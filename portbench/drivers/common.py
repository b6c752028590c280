"""What the drivers share: the port's model on the benchmark's weights,
and a trainer built on class names alone.

The port resolves a backbone by name (``models/backbone.py::
load_clip_backbone``: weights on disk, else a fixed-seed init). The
benchmark hands it its own seeded weights instead: ``backbone`` puts the
model in place of that loader where the trainers and the Predictor look
it up (``trainers.coop``, ``trainers.base_learner``, ``serving``), for as
long as the system is being built.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch

from .. import schema as S
from .. import traffic as T
from .. import weights as W

#: the modules that look ``load_clip_backbone`` up by name
LOADER_USERS = ("clip_calibration_tpu_torch.trainers.coop",
                "clip_calibration_tpu_torch.trainers.base_learner",
                "clip_calibration_tpu_torch.serving")
#: what the port runs where its CLIPConfig has no field of that name:
#: OpenAI's layout (``schema.py``)
PORT_DEFAULTS = {"vision_mlp_width": lambda c: 4 * c.vision_width,
                 "transformer_mlp_width": lambda c: 4 * c.transformer_width,
                 "activation": lambda c: "quick_gelu"}


def port_config(cfg: dict):
    """The port's CLIPConfig from every key of the configuration that
    names one of its fields. Raises ``ValueError``, naming each key, where
    the port would run something other than what the configuration
    states: its vision heads (a property of the port's config), and each
    key of ``PORT_DEFAULTS``, read from the port's config where it has a
    field of that name (``None`` there: OpenAI's value)."""
    from clip_calibration_tpu_torch.models.clip import CLIPConfig
    fields = {f.name for f in dataclasses.fields(CLIPConfig)}
    ccfg = CLIPConfig(**{k: v for k, v in cfg.items() if k in fields})
    stated = {"vision_heads": cfg["vision_heads"],
              "vision_mlp_width": S.mlp_width(cfg, "vision"),
              "transformer_mlp_width": S.mlp_width(cfg, "transformer"),
              "activation": S.activation(cfg)}
    wrong = []
    for key, want in stated.items():
        got = getattr(ccfg, key, None)
        if got is None:
            got = PORT_DEFAULTS[key](ccfg)
        if got != want:
            wrong.append(f"{key}: the configuration states {want!r}, the "
                         f"port runs {got!r}")
    if wrong:
        raise ValueError("the port cannot run this configuration: "
                         + "; ".join(wrong))
    return ccfg


def port_model(run):
    """(the port's CLIP module on the run's weights, its CLIPConfig, the
    weights) for the run's configuration and seed; the configuration is
    checked (``port_config``) before any weight is made."""
    from clip_calibration_tpu_torch.models.clip import CLIP
    cfg = run.config
    ccfg = port_config(cfg)
    weights = W.make(cfg, T.sub_seed(run.seed, "weights"), run.device)
    model = CLIP(ccfg, W.DTYPES[cfg["precision"]], run.device)
    W.load_into(model, weights)
    return model, ccfg, weights


@contextlib.contextmanager
def backbone(model, ccfg):
    """The port's backbone loader answers with ``(model, ccfg)``."""
    mods = [importlib.import_module(m) for m in LOADER_USERS]
    old = [m.load_clip_backbone for m in mods]
    for m in mods:
        m.load_clip_backbone = lambda *a, **k: (model, ccfg)
    base = importlib.import_module(LOADER_USERS[1])
    base._zs_clip_cached.cache_clear()
    try:
        yield
    finally:
        for m, fn in zip(mods, old):
            m.load_clip_backbone = fn
        base._zs_clip_cached.cache_clear()


class _Loader:
    """The train loader's length (the LR schedule's steps per epoch);
    the driver feeds the batches itself."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(())


def build_trainer(run, classnames, opts, steps_per_epoch: int = 1):
    """The registered trainer ``run.traffic["trainer"]`` over
    ``classnames`` without a dataset: a class-names-only data manager,
    everything else the trainer's own code."""
    import types

    from clip_calibration_tpu_torch import trainers  # noqa: F401
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.engine.registry import TRAINER_REGISTRY
    from clip_calibration_tpu_torch.evaluators import vl_evaluator  # noqa

    cfg = get_cfg_default()
    res = run.config["image_resolution"]
    cfg.merge_from_list([
        "TRAINER.NAME", run.traffic["trainer"],
        "MODEL.BACKBONE.NAME", run.config["model"],
        "MODEL.PRECISION", run.config["precision"],
        "INPUT.SIZE", (res, res),
        "TEST.EVALUATOR", "VLClassification",
        "OUTPUT_DIR", "build/portbench/output"])
    for key, value in opts.items():
        cfg.merge_from_list([key, value])
    names = list(classnames)

    class BenchTrainer(TRAINER_REGISTRY.get(cfg.TRAINER.NAME)):
        def build_data_loader(self):
            self.dm = types.SimpleNamespace(
                dataset=types.SimpleNamespace(classnames=names,
                                              num_classes=len(names)),
                num_classes=len(names),
                lab2cname=dict(enumerate(names)),
                train_loader_x=_Loader(steps_per_epoch))
            self.train_loader_x = self.dm.train_loader_x
            self.val_loader = self.test_loader = None
            self.num_classes = len(names)
            self.lab2cname = self.dm.lab2cname

    return BenchTrainer(cfg, device=run.device)


def bench_ctx(run, n_ctx: int, width: int) -> torch.Tensor:
    """The prompt context both sides start from: N(0, 0.02^2), as CoOp
    initialises a generic context."""
    gen = torch.Generator(device=run.device).manual_seed(
        T.sub_seed(run.seed, "ctx"))
    return torch.randn((n_ctx, width), generator=gen,
                       device=run.device) * 0.02


def sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
