"""Name -> class registries.

Equivalent of Dassl's ``TRAINER_REGISTRY`` / ``DATASET_REGISTRY`` /
``EVALUATOR_REGISTRY`` (consumed throughout the reference, e.g.
reference ``trainers/classification/coop.py:14``): modules register
classes at import time; the CLI looks them up by the name in the config.
"""

from __future__ import annotations

import contextlib
import threading


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict = {}
        self._local = threading.local()

    def register(self, obj=None):
        if obj is None:  # used as decorator
            def deco(cls):
                self._do_register(cls.__name__, cls)
                return cls
            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj) -> None:
        if name in self._obj_map and self._obj_map[name] is not obj:
            raise KeyError(
                f"'{name}' already registered in {self._name} registry")
        self._obj_map[name] = obj

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in {self._name} registry. "
                f"Available: {sorted(self._obj_map)}")
        obj = self._obj_map[name]
        wrapper = getattr(self._local, "wrapper", None)
        return obj if wrapper is None else wrapper(obj)

    @contextlib.contextmanager
    def wrapped(self, wrapper):
        """Thread-locally wrap every ``get`` result for the duration of
        the context (nested lookups included — e.g. TempScaling building
        its base learner inside ``build_model``). Other threads see the
        registry unchanged, so a concurrent real ``build_trainer`` can
        never pick up a serving subclass."""
        prev = getattr(self._local, "wrapper", None)
        self._local.wrapper = wrapper
        try:
            yield
        finally:
            self._local.wrapper = prev

    def registered_names(self):
        return sorted(self._obj_map)

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map


TRAINER_REGISTRY = Registry("trainer")
DATASET_REGISTRY = Registry("dataset")
EVALUATOR_REGISTRY = Registry("evaluator")


def build_trainer(cfg, device="cuda"):
    """Look up ``cfg.TRAINER.NAME`` and instantiate on ``device``
    (Dassl build_trainer)."""
    name = cfg.TRAINER.NAME
    return TRAINER_REGISTRY.get(name)(cfg, device=device)


def build_evaluator(cfg, **kwargs):
    return EVALUATOR_REGISTRY.get(cfg.TEST.EVALUATOR)(cfg, **kwargs)
