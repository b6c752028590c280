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
import importlib

import torch

from .. import traffic as T
from .. import weights as W

#: the modules that look ``load_clip_backbone`` up by name
LOADER_USERS = ("clip_calibration_tpu_torch.trainers.coop",
                "clip_calibration_tpu_torch.trainers.base_learner",
                "clip_calibration_tpu_torch.serving")
CLIP_KEYS = ("embed_dim", "image_resolution", "vision_layers",
             "vision_width", "vision_patch_size", "transformer_width",
             "transformer_heads", "transformer_layers", "context_length",
             "vocab_size")


def port_model(run):
    """(the port's CLIP module on the run's weights, its CLIPConfig, the
    weights) for the run's configuration and seed."""
    from clip_calibration_tpu_torch.models.clip import CLIP, CLIPConfig
    cfg = run.config
    ccfg = CLIPConfig(**{k: cfg[k] for k in CLIP_KEYS})
    if ccfg.vision_heads != cfg["vision_heads"]:
        raise ValueError(f"the port runs {ccfg.vision_heads} vision heads, "
                         f"the configuration states {cfg['vision_heads']}")
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
