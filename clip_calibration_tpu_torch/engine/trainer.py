"""Trainer lifecycle engine — the evaluation half.

Clean-room equivalent of the Dassl ``TrainerX`` surface the reference
trainers use (reference ``trainers/classification/coop.py:226-343``):
``build_data_loader`` -> ``build_model`` -> ``test()``, the model
registry, ``load_model`` with buffer-dropping, metric logging. Training
(the epoch loop, optimizers, resume) is not ported yet.

Every trainer lives on one device, named at construction (default
``cuda``; asking for it without a card raises). Host batches are staged
one ahead into the device from pinned memory.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.loader import DataManager
from ..engine.checkpoint import (export_torch_checkpoint, load_checkpoint,
                                 resolve_model_file)
from ..engine.registry import build_evaluator
from ..tools.device import resolve_device


class TrainerX:
    """Base trainer: device, data, model registry, eval lifecycle."""

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.MODEL.PRECISION not in ("bf16", "fp32"):
            # every consumer uses 'fp32 if x == "fp32" else bf16', so a
            # typo would silently mean bf16
            raise ValueError(
                f"MODEL.PRECISION must be 'bf16' or 'fp32', got "
                f"{cfg.MODEL.PRECISION!r}")
        self.check_cfg(cfg)
        self.epoch = 0
        self.output_dir = cfg.OUTPUT_DIR
        # name -> {"params": nested dict of tensors}
        self._models: Dict[str, Dict[str, Any]] = {}
        self._scalar_log = None

        self.build_data_loader()
        self.evaluator = build_evaluator(cfg, lab2cname=self.dm.lab2cname)
        self.build_model()

    # -- hooks ------------------------------------------------------------
    def check_cfg(self, cfg):
        pass

    def build_data_loader(self):
        self.dm = DataManager(self.cfg)
        self.train_loader_x = self.dm.train_loader_x
        self.val_loader = self.dm.val_loader
        self.test_loader = self.dm.test_loader
        self.num_classes = self.dm.num_classes
        self.lab2cname = self.dm.lab2cname

    def build_model(self):
        raise NotImplementedError

    def model_inference(self, images):
        """images: uint8 [B,H,W,3] device tensor -> (logits,
        image_features, text_features) device tensors."""
        raise NotImplementedError

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.MODEL.PRECISION == "fp32"
                else torch.bfloat16)

    @property
    def pixel_stats(self):
        """(mean, std) for the device-side normalize (None, None: /255
        only) — ops/preprocess.pixel_stats_from_cfg."""
        from ..ops.preprocess import pixel_stats_from_cfg
        return pixel_stats_from_cfg(self.cfg)

    def set_model_mode(self, mode: str):
        pass  # the frozen towers carry no train/eval behaviour

    def train(self):
        raise NotImplementedError(
            f"{type(self).__name__}: training is not ported to the torch "
            "package yet; run with --eval-only")

    # -- model registry ----------------------------------------------------
    def register_model(self, name: str, params: Dict[str, Any]):
        if name in self._models:
            raise KeyError(f"Model {name!r} already registered")
        self._models[name] = {"params": params}

    def get_model_names(self):
        return list(self._models)

    def model_params(self, name: str):
        return self._models[name]["params"]

    # -- checkpoints ---------------------------------------------------------
    #: checkpoint filename stem (reference naming)
    checkpoint_model_name = "model"

    def export_reference_checkpoint(self, directory: str, dst_dir: str,
                                    epoch: Optional[int] = None):
        """Write each registered model's checkpoint under ``directory``
        as a reference-format torch ``.pth.tar`` under ``dst_dir``."""
        written = []
        for name in self.get_model_names():
            path = resolve_model_file(osp.join(directory, name), epoch,
                                      model_name=self.checkpoint_model_name)
            ckpt = load_checkpoint(path)
            dst = osp.join(dst_dir, name, osp.basename(path))
            written.append(export_torch_checkpoint(
                ckpt["state_dict"], ckpt["epoch"], dst))
            print(f'Exported {name} -> "{dst}" (reference torch format)')
        return written

    def load_model(self, directory: str, epoch: Optional[int] = None):
        if not directory:
            print("Note that load_model() is skipped as no pretrained "
                  "model is given")
            return
        for name in self.get_model_names():
            path = resolve_model_file(osp.join(directory, name), epoch,
                                      model_name=self.checkpoint_model_name)
            ckpt = load_checkpoint(path)
            state = ckpt["state_dict"]
            # Ignore fixed token vectors: class sets change between
            # train (base) and test (new) (reference coop.py:334-343)
            state.pop("token_prefix", None)
            state.pop("token_suffix", None)
            print(f'Loading weights to {name} from "{path}" '
                  f'(epoch = {ckpt["epoch"]})')
            self._set_params(name, state)

    def _set_params(self, name: str, loaded: Dict[str, Any]):
        """Non-strict merge of loaded tensors into the registered dict,
        each cast to the registered leaf's dtype and device."""
        def merge(dst, src, prefix=""):
            out = {}
            for k, v in dst.items():
                if k not in src:
                    print(f"missing key in checkpoint: {prefix + k}")
                    out[k] = v
                elif isinstance(v, dict):
                    out[k] = merge(v, src[k], prefix + k + "/")
                else:
                    t = torch.as_tensor(src[k]).to(v.device, v.dtype)
                    if t.shape != v.shape:
                        print(f"skip {prefix + k}: shape "
                              f"{tuple(t.shape)} != {tuple(v.shape)}")
                        out[k] = v
                    else:
                        out[k] = t
            return out

        self._models[name]["params"] = merge(self._models[name]["params"],
                                             loaded)

    # -- device staging -------------------------------------------------------
    def put_batch(self, array) -> torch.Tensor:
        """Host array -> tensor on this trainer's device (pinned memory,
        asynchronous copy, when that device is a card)."""
        if isinstance(array, torch.Tensor) and array.device == self.device:
            return array
        t = torch.as_tensor(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _device_staged(self, loader):
        """One-batch-ahead staging: batch N+1's copy is issued before
        batch N is consumed, so the copy overlaps the device work."""
        staged_prev = None
        for batch in loader:
            staged = dict(batch)
            staged["img"] = self.put_batch(batch["img"])
            staged["label"] = self.put_batch(batch["label"])
            if staged_prev is not None:
                yield staged_prev
            staged_prev = staged
        if staged_prev is not None:
            yield staged_prev

    def parse_batch_test(self, batch):
        return batch["img"], batch["label"]

    # -- misc ---------------------------------------------------------------
    def write_scalar(self, tag: str, value, step: int):
        if self._scalar_log is None:
            os.makedirs(self.output_dir, exist_ok=True)
            self._scalar_log = open(
                osp.join(self.output_dir, "scalars.jsonl"), "a")
        self._scalar_log.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._scalar_log.flush()

    def close_writer(self):
        if self._scalar_log is not None:
            self._scalar_log.close()
            self._scalar_log = None

    def test(self, split=None):
        raise NotImplementedError
