"""Temperature-scaling calibration trainer.

Parity target: reference ``trainers/calibration/tempscaling.py``, through
``clip_calibration_tpu/trainers/calibration/tempscaling.py``. Wraps a
frozen, already-tuned base learner; the one trainable parameter is a
log-temperature (init 4.6052 = ln 100, the CLIP convention). The base
trainer's own inference is reused with its logit scale divided out, so
one code path serves every base learner.

Training re-points ``train_loader_x`` at the *val* loader (reference
``tempscaling.py:123-143``) and optimizes the cross-entropy of
``exp(s) * cos`` with the configured optimizer (SGD in every shipped
config). The frozen model's cosine logits are computed once per val batch
and replayed from a cache in later epochs. Checkpoints are saved as
``model-calibrated.pth.tar-<N>`` (reference ``tempscaling.py:305-327``).
The JAX package gathers rows across hosts (``host_rows_allgather``,
``to_host_global``); on one device those are the identity and are left
out.
"""

from __future__ import annotations

import math
import os.path as osp

import torch
import torch.nn.functional as F

from ...engine.checkpoint import load_checkpoint
from ...engine.registry import TRAINER_REGISTRY
from ..base_learner import VLBaseLearner


class _CachedCosReplay:
    """Scaling-epoch replay shim around the sequential val loader.

    Epoch 1 iterates the real loader (filling the trainer's per-batch
    cosine-logit cache); once the cache holds a full epoch, later epochs
    replay the cached batch keys: no decode, no transform, no copy to the
    device. The val loader is sequential and deterministic, so the
    cache's insertion order is the epoch order and the trajectory is
    unchanged."""

    def __init__(self, trainer, base):
        self.trainer = trainer
        self.base = base

    def __len__(self):
        return len(self.base)

    def set_epoch(self, epoch):
        self.base.set_epoch(epoch)

    @property
    def replaying(self) -> bool:
        cache = getattr(self.trainer, "_cos_cache", None)
        return cache is not None and len(cache) >= len(self.base)

    def __iter__(self):
        if self.replaying:
            for key in list(self.trainer._cos_cache.keys()):
                yield {"impath": key, "n_real": len(key)}
            return
        yield from self.base


@TRAINER_REGISTRY.register()
class TempScaling(VLBaseLearner):

    def build_data_loader(self):
        super().build_data_loader()
        # calibrate on the validation split, as the reference does
        if self.val_loader is not None:
            self.train_loader_x = _CachedCosReplay(self, self.val_loader)

    def _device_staged(self, loader):
        # cached-cos replay batches carry no images: nothing to stage
        if getattr(loader, "replaying", False):
            yield from loader
            return
        yield from super()._device_staged(loader)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        base_name = cfg.CALIBRATION.SCALING.BASE_LEARNER
        print(f"Building base learner for scaling: {base_name}")

        bcfg = cfg.clone()
        bcfg.defrost()
        bcfg.TRAINER.NAME = base_name
        bcfg.freeze()
        self.base = TRAINER_REGISTRY.get(base_name)(bcfg, device=self.device)

        base_dir = cfg.CALIBRATION.SCALING.BASE_DIR
        if base_dir:
            self.base.load_model(base_dir,
                                 epoch=cfg.CALIBRATION.SCALING.BASE_EPOCH)

        # the frozen model's own temperature, divided out of its logits
        self._base_log_scale = float(self.base.clip_model.logit_scale)

        self.register_trainable("scale_learner", self.init_scale_params())

        self._cos_cache = {}  # impath tuple -> (cos_logits, labels)
        # the cache is valid only while the base model stays frozen
        self._base_fingerprint = self._fingerprint_base()
        self._fingerprint_checked = False

    def init_scale_params(self) -> dict:
        """The scale learner's tensors: one log-temperature."""
        return {"scale": torch.tensor(
            self.cfg.CALIBRATION.SCALING.INIT_TEMP, dtype=torch.float32,
            device=self.device)}

    # the CLIP backbone lives on the wrapped base learner
    @property
    def clip_cfg(self):
        return self.base.clip_cfg

    @property
    def clip_model(self):
        return self.base.clip_model

    @property
    def _step_clip_params(self):
        # TRAINER.QUANT_FROZEN_VISION is the wrapped base learner's (its
        # build_model installed the quantized tower or raised); delegating
        # satisfies the engine's check and keeps inference on its path
        return getattr(self.base, "_step_clip_params", None)

    def _fingerprint_base(self) -> float:
        total = 0.0
        for slot in self.base._models.values():
            for leaf in slot["params"].values():
                total += float(leaf.detach().float().abs().sum())
        return total

    # -- helpers --------------------------------------------------------------
    @torch.no_grad()
    def _unit_logits(self, images):
        """Base model cosine logits with its temperature divided out
        (fp64 division rounded to fp32, as the JAX package's numpy)."""
        logits, img_f, txt_f = self.base.model_inference(images)
        cos = (logits.double() / math.exp(self._base_log_scale)).float()
        return cos, img_f, txt_f

    # -- train -------------------------------------------------------------
    def _cached_cos(self, batch):
        """Frozen-model cosine logits and labels of the batch (cached per
        batch on the sequential val loader; a dataset without a val split
        scales on the shuffled train loader, whose batches change every
        epoch, and bypasses the cache). Padded rows of the last batch are
        sliced off."""
        n = batch["n_real"]
        base = getattr(self.train_loader_x, "base", self.train_loader_x)
        if base is not self.val_loader:
            images, labels = self.parse_batch_train(batch)
            cos, _, _ = self._unit_logits(images)
            return cos[:n], labels[:n]
        key = tuple(batch["impath"])
        if key not in self._cos_cache:
            # bounded by construction: the sequential val loader replays
            # identical batches each epoch
            if len(self._cos_cache) >= len(self.train_loader_x):
                raise RuntimeError(
                    "TempScaling logit cache grew past one epoch — the "
                    "val loader order is expected to be deterministic")
            images, labels = self.parse_batch_train(batch)
            cos, _, _ = self._unit_logits(images)
            self._cos_cache[key] = (cos[:n], self.put_batch(labels)[:n])
        elif not self._fingerprint_checked:
            # first cache hit: the base model must not have trained since
            # build (cached logits would silently go stale)
            if self._fingerprint_base() != self._base_fingerprint:
                raise RuntimeError(
                    "base model parameters changed after TempScaling "
                    "build; cached cosine logits are stale")
            self._fingerprint_checked = True
        return self._cos_cache[key]

    def forward_backward(self, batch):
        cos, labels = self._cached_cos(batch)
        scale = self.model_params("scale_learner")["scale"]
        self.optimizer("scale_learner").zero_grad(set_to_none=True)
        loss = F.cross_entropy(torch.exp(scale) * cos,
                               self.put_batch(labels).long())
        loss.backward()
        self.optimizer_step("scale_learner")
        return {"loss": loss.detach(),
                "temperature": torch.exp(scale.detach())}

    # -- eval ---------------------------------------------------------------
    def model_inference(self, images):
        cos, img_f, txt_f = self._unit_logits(images)
        s = float(self._models["scale_learner"]["params"]["scale"])
        return (cos.double() * math.exp(s)).float(), img_f, txt_f

    # -- checkpointing: model-calibrated.pth.tar-N --------------------------
    checkpoint_model_name = "model-calibrated"

    def convert_to_reference_state(self, name, state):
        """The reference ScaleLearner's parameter is ``logit_scale``
        (reference ``tempscaling.py:34-41``)."""
        return {"logit_scale": state["scale"]}

    def checkpoint_dir_aliases(self, name):
        """The reference registers its scaler under ``tempscaling``
        (reference ``tempscaling.py:111``); native layout first, the last
        entry names the export directory."""
        return ["scale_learner", "tempscaling"]

    def load_model(self, directory, epoch=None):
        """Load the scale learner from model-calibrated checkpoints
        (reference ``tempscaling.py:258-301``) under ``scale_learner/``
        or ``tempscaling/``. The base model was loaded from
        CALIBRATION.SCALING.BASE_DIR at build time."""
        if not directory:
            print("Note that load_model() is skipped as no pretrained "
                  "model is given")
            return
        fname = ("model-calibrated-best.pth.tar" if epoch is None
                 else f"model-calibrated.pth.tar-{epoch}")
        aliases = self.checkpoint_dir_aliases("scale_learner")
        for alias in aliases:
            path = osp.join(directory, alias, fname)
            if osp.exists(path):
                break
        else:
            raise FileNotFoundError(
                f'No "{fname}" under {directory!r} (tried '
                f'subdirectories {aliases})')
        ckpt = load_checkpoint(path)
        state = dict(ckpt["state_dict"])
        if "logit_scale" in state and "scale" not in state:
            state["scale"] = state.pop("logit_scale")
        print(f'Loading weights to scale_learner from "{path}" '
              f'(epoch = {ckpt["epoch"]})')
        self._set_params("scale_learner", state)
