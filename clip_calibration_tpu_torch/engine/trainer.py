"""Trainer lifecycle engine.

Clean-room equivalent of the Dassl ``TrainerX`` surface the reference
trainers use (reference ``trainers/classification/coop.py:226-343``):
``build_data_loader`` -> ``build_model`` -> ``train()`` epoch loop calling
``forward_backward`` per batch, per-epoch checkpoints with the optimizer
state, all-or-nothing auto-resume from ``RESUME`` or the output dir,
``test()``, the model registry, ``load_model`` with buffer-dropping,
metric logging. Counterpart of ``clip_calibration_tpu/engine/trainer.py``.

Every trainer lives on one device, named at construction (default
``cuda``; asking for it without a card raises). Host batches are staged
one ahead into the device from pinned memory. A train step only enqueues
device work: losses stay device tensors until a print fetches them.

Multi-process runs (one process per device, ``parallel/mesh.py``): with
more than one rank the trainer builds a (data, model) mesh from
``TPU.MESH_SHAPE``; the loaders hand each data rank its slice of every
global batch, the trainables start equal on every rank (broadcast from
rank 0 after build and resume), ``optimizer_step`` reduces their
gradients over the mesh before stepping, and every rank writes its own
``OUTPUT_DIR``.
"""

from __future__ import annotations

import datetime
import json
import os
import os.path as osp
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..data.loader import DataManager
from ..engine.checkpoint import (export_torch_checkpoint, load_checkpoint,
                                 resolve_model_file, save_checkpoint)
from ..engine.optim import (load_opt_state_leaves, opt_state_leaves,
                            set_lr, sorted_leaves)
from ..engine.registry import build_evaluator
from ..parallel import mesh as P
from ..tools import profiling
from ..tools.device import resolve_device
from ..tools.profiling import Tracer

#: what ``_device_staged`` reads from an exhausted loader
_EXHAUSTED = object()


class MetricMeter:
    """Running averages for loss printing (Dassl MetricMeter look).

    Takes device scalars and keeps them unfetched until printed: a
    per-step ``.item()`` would block the host on every train step. At
    print time the pending values of a metric are stacked and fetched in
    one copy."""

    def __init__(self, delimiter: str = " "):
        self.meters = defaultdict(lambda: deque(maxlen=100))
        self.delimiter = delimiter

    def update(self, metrics: Dict[str, Any]):
        for k, v in metrics.items():
            self.meters[k].append(v)

    def _materialize(self):
        for vals in self.meters.values():
            idx = [i for i, v in enumerate(vals) if type(v) is not float]
            if not idx:
                continue
            fetched = torch.stack([torch.as_tensor(vals[i]).float()
                                   .reshape(()) for i in idx]).cpu()
            for i, x in zip(idx, fetched.tolist()):
                vals[i] = float(x)

    def __str__(self):
        self._materialize()
        parts = []
        for name, vals in self.meters.items():
            avg = sum(vals) / len(vals)
            parts.append(f"{name} {vals[-1]:.4f} ({avg:.4f})")
        return self.delimiter.join(parts)


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
        self.start_epoch = self.epoch = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.output_dir = cfg.OUTPUT_DIR
        self.best_result = -np.inf
        # name -> {"params": nested dict of tensors, "make_optim": builds
        # the torch optimizer or None, "optim": it once built, "sched":
        # step -> lr, "step": steps taken}
        self._models: Dict[str, Dict[str, Any]] = {}
        self._scalar_log = None

        self.build_data_loader()
        self.evaluator = build_evaluator(cfg, lab2cname=self.dm.lab2cname)
        self.build_model()
        self.broadcast_trainables()
        # TRAINER.QUANT_FROZEN_VISION is never silently ignored: a trainer
        # that supports it calls setup_frozen_vision() in its build_model
        # (which installs the quantized tower or raises); anything else
        # lands here
        if cfg.TRAINER.QUANT_FROZEN_VISION and \
                getattr(self, "_step_clip_params", None) is None:
            raise ValueError(
                f"{type(self).__name__} does not support "
                "TRAINER.QUANT_FROZEN_VISION (its build_model never "
                "installed a quantized frozen tower)")

    # -- hooks ------------------------------------------------------------
    def check_cfg(self, cfg):
        pass

    def build_data_loader(self):
        self.dm = DataManager(self.cfg, mesh=self.mesh)
        self.train_loader_x = self.dm.train_loader_x
        self.val_loader = self.dm.val_loader
        self.test_loader = self.dm.test_loader
        self.num_classes = self.dm.num_classes
        self.lab2cname = self.dm.lab2cname

    def build_model(self):
        raise NotImplementedError

    def forward_backward(self, batch) -> Dict[str, Any]:
        """One train step; returns loss metrics as device scalars (left
        unfetched: MetricMeter fetches at print time)."""
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

    # -- model registry ----------------------------------------------------
    def register_model(self, name: str, params: Dict[str, Any],
                       make_optim: Optional[Callable[
                           [], torch.optim.Optimizer]] = None,
                       sched=None):
        """params: nested dict of tensors (the trainable ones are the
        optimizer's parameters); make_optim: builds the optimizer at its
        first use (``optimizer``), since the first torch optimizer of a
        process imports torch._dynamo, seconds an eval-only run need not
        pay; sched: step -> lr."""
        if name in self._models:
            raise KeyError(f"Model {name!r} already registered")
        self._models[name] = {"params": params, "make_optim": make_optim,
                              "optim": None, "sched": sched, "step": 0}

    def get_model_names(self):
        return list(self._models)

    def model_params(self, name: str):
        return self._models[name]["params"]

    def optimizer(self, name: str) -> torch.optim.Optimizer:
        """``name``'s optimizer, built at the first call."""
        slot = self._models[name]
        if slot["optim"] is None:
            slot["optim"] = slot["make_optim"]()
        return slot["optim"]

    def optimizer_step(self, name: str):
        """Step ``name``'s optimizer on the gradients in place, at the
        lr its schedule gives for the step count (optax's
        ``scale_by_learning_rate(schedule)``). On a mesh the gradients are
        first made the global loss's (``parallel/mesh.py::
        reduce_trainable_grads``, summed over the model ranks when the
        step sharded the class axis); gradients that are already equal on
        every rank come out of its data average unchanged.

        A trainable the step left without a gradient gets zeros, so it is
        stepped as optax steps every leaf (torch's optimizers skip a
        ``None`` gradient: no weight decay, no momentum), and every rank
        joins the same collectives."""
        slot = self._models[name]
        optim = self.optimizer(name)
        params = [p for g in optim.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        P.reduce_trainable_grads(params, self.mesh,
                                 model_sharded=self.class_sharded)
        set_lr(optim, slot["sched"](slot["step"]))
        optim.step()
        slot["step"] += 1

    def broadcast_trainables(self):
        """Every registered model's tensors set to rank 0's, so all ranks
        of a mesh hold the same trainables (after build and resume)."""
        if self.mesh is None:
            return
        for slot in self._models.values():
            P.broadcast_params(sorted_leaves(slot["params"]), self.mesh)

    # -- train loop ----------------------------------------------------------
    def train(self):
        self.before_train()
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch()
            self.after_epoch()
        self.after_train()

    def before_train(self):
        # Dassl parity: resume from RESUME when given, else from the
        # output dir itself (re-running an interrupted run picks up its
        # checkpoints)
        directory = self.cfg.RESUME or self.output_dir
        if self._models:
            self.resume_model_if_exist(directory)
        os.makedirs(self.output_dir, exist_ok=True)
        self.time_start = time.time()

    def before_epoch(self):
        self.train_loader_x.set_epoch(self.epoch)

    def run_epoch(self):
        meter = MetricMeter()
        epoch_start = time.time()
        self.num_batches = len(self.train_loader_x)
        profile_dir = self.cfg.TPU.PROFILE_DIR
        tracer = None
        if profile_dir and self.epoch == 0:
            print(f"Tracing first {self.cfg.TPU.PROFILE_STEPS} steps "
                  f"to {profile_dir}")
            # Tracer.stop waits for the card: losses are fetched lazily,
            # so the traced steps may still be queued when it is called
            tracer = Tracer(profile_dir, self.device).start()
        # forward_backward only enqueues device work (losses are fetched
        # at print time), so the numbers come from the print window:
        # printing the meter drains the queue, and the window's wall time
        # over its steps is the true step time
        end = window_start = time.time()
        window_steps = 0
        window_data = 0.0
        for self.batch_idx, batch in enumerate(
                self._device_staged(self.train_loader_x)):
            window_data += time.time() - end  # decode/prefetch wait
            meter.update(self.forward_backward(batch))
            window_steps += 1
            if tracer is not None and \
                    self.batch_idx + 1 >= self.cfg.TPU.PROFILE_STEPS:
                tracer.stop()
                tracer = None
            if ((self.batch_idx + 1) % self.cfg.TRAIN.PRINT_FREQ == 0
                    or self.num_batches < self.cfg.TRAIN.PRINT_FREQ):
                msg = str(meter)  # fetches the pending losses (sync)
                now = time.time()
                batch_time = (now - window_start) / window_steps
                data_time = window_data / window_steps
                nb_left = self.num_batches - self.batch_idx - 1
                ep_left = self.max_epoch - self.epoch - 1
                eta = batch_time * (nb_left + ep_left * self.num_batches)
                eta = str(datetime.timedelta(seconds=int(eta)))
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}]"
                    f"[{self.batch_idx + 1}/{self.num_batches}] "
                    f"time {batch_time:.3f} data {data_time:.3f} "
                    f"eta {eta} {msg}")
                window_start = time.time()
                window_steps = 0
                window_data = 0.0
            end = time.time()
        if tracer is not None:  # epoch shorter than PROFILE_STEPS
            tracer.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - epoch_start
        n = max(self.num_batches, 1)
        print(f"epoch [{self.epoch + 1}/{self.max_epoch}] done in "
              f"{dt:.1f}s ({dt / n * 1e3:.1f} ms/step, "
              f"{n * self.cfg.DATALOADER.TRAIN_X.BATCH_SIZE / dt:.0f} "
              f"img/s)")

    def after_epoch(self):
        last_epoch = (self.epoch + 1) == self.max_epoch
        do_test = not self.cfg.TEST.NO_TEST
        meet_freq = (self.cfg.TRAIN.CHECKPOINT_FREQ > 0 and
                     (self.epoch + 1) % self.cfg.TRAIN.CHECKPOINT_FREQ == 0)
        if do_test and self.cfg.TEST.FINAL_MODEL == "best_val":
            result = self.test(split="val")
            if result > self.best_result:
                self.best_result = result
                self.save_model(self.epoch, self.output_dir, is_best=True)
        if last_epoch or meet_freq:
            self.save_model(self.epoch, self.output_dir)

    def after_train(self):
        print("Finish training")
        if not self.cfg.TEST.NO_TEST:
            if self.cfg.TEST.FINAL_MODEL == "best_val":
                print("Deploy the model with the best val performance")
                self.load_model(self.output_dir)
            else:
                print("Deploy the last-epoch model")
            self.test()
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")
        self.close_writer()

    # -- checkpoints ---------------------------------------------------------
    #: checkpoint filename stem; calibration trainers override with
    #: "model-calibrated" (reference tempscaling.py:305-327 naming)
    checkpoint_model_name = "model"

    def save_model(self, epoch: int, directory: str, is_best: bool = False,
                   model_name: Optional[str] = None):
        """Each registered model's params and optimizer state (optax
        leaf order) as ``<directory>/<name>/<model_name>.pth.tar-<epoch+1>``."""
        model_name = model_name or self.checkpoint_model_name
        for name, slot in self._models.items():
            leaves = None
            if slot["make_optim"] is not None:
                leaves = opt_state_leaves(self.cfg, self.optimizer(name),
                                          slot["params"], slot["step"])
            save_checkpoint(
                {"state_dict": slot["params"], "epoch": epoch + 1,
                 "opt_leaves": leaves},
                osp.join(directory, name), epoch + 1, is_best=is_best,
                model_name=model_name)

    def checkpoint_dir_aliases(self, name: str):
        """Subdirectory names to try when loading (reference trainers use
        other registered names); the last one names the export dir."""
        return [name]

    def _resolve_aliased(self, directory: str, name: str,
                         epoch: Optional[int], model_name: str = "model"):
        """Model ``name``'s checkpoint file under ``directory``, trying
        each ``checkpoint_dir_aliases`` subdirectory in order."""
        for alias in self.checkpoint_dir_aliases(name):
            try:
                return resolve_model_file(osp.join(directory, alias),
                                          epoch, model_name=model_name)
            except FileNotFoundError:
                continue
        raise FileNotFoundError(
            f"No checkpoint for {name!r} under {directory!r} "
            f"(tried {self.checkpoint_dir_aliases(name)})")

    def convert_reference_state(self, name: str, state: Dict[str, Any]):
        """Map a loaded state dict in the reference's layout (dots ->
        nesting, torch [out, in] Linear weights) onto this trainer's
        params. Default identity (native checkpoints, CoOp's ``ctx``)."""
        return state

    def convert_to_reference_state(self, name: str, state: Dict[str, Any]):
        """Map this trainer's params to the reference's state-dict layout
        for export. Default identity (CoOp's ``ctx`` shares its name)."""
        return state

    def resume_model_if_exist(self, directory: str):
        """All-or-nothing resume: every registered model's checkpoint is
        loaded and validated before any is applied, so a missing or
        truncated file (a run killed mid-save) starts fresh instead of
        crashing or resuming from a mixed state. Restores the optimizer
        state and the schedule position with the params."""
        loaded = []
        for name in self.get_model_names():
            try:
                path = resolve_model_file(
                    osp.join(directory, name), latest=True,
                    model_name=self.checkpoint_model_name)
                ckpt = load_checkpoint(path)
            except FileNotFoundError:
                print(f"No checkpoint to resume at {directory}")
                return
            except Exception as e:  # truncated/corrupt/alien file
                print(f"Unusable checkpoint for {name!r} at {directory} "
                      f"({type(e).__name__}: {e}); starting fresh")
                return
            loaded.append((name, ckpt["state_dict"], ckpt["epoch"],
                           ckpt.get("opt_leaves")))

        resumed_epoch = 0
        for name, state, epoch, leaves in loaded:
            state.pop("token_prefix", None)
            state.pop("token_suffix", None)
            self._set_params(name, state)
            resumed_epoch = max(resumed_epoch, epoch)
            slot = self._models[name]
            if leaves is not None and slot["make_optim"] is not None:
                try:
                    slot["step"] = load_opt_state_leaves(
                        self.cfg, self.optimizer(name), slot["params"],
                        leaves)
                except ValueError as e:
                    print(f"optimizer state mismatch for {name} ({e}); "
                          "keeping fresh state")
        self.start_epoch = resumed_epoch
        self.broadcast_trainables()
        print(f"Resumed from {directory} (epoch {resumed_epoch})")

    def export_reference_checkpoint(self, directory: str, dst_dir: str,
                                    epoch: Optional[int] = None):
        """Write each registered model's checkpoint under ``directory``
        as a reference-format torch ``.pth.tar`` under ``dst_dir``."""
        written = []
        for name in self.get_model_names():
            path = self._resolve_aliased(
                directory, name, epoch, model_name=self.checkpoint_model_name)
            ckpt = load_checkpoint(path)
            state = ckpt["state_dict"]
            if ckpt["native"]:
                state = self.convert_to_reference_state(name, state)
            ref_name = self.checkpoint_dir_aliases(name)[-1]
            dst = osp.join(dst_dir, ref_name, osp.basename(path))
            written.append(export_torch_checkpoint(state, ckpt["epoch"],
                                                   dst))
            print(f'Exported {name} -> "{dst}" (reference torch format)')
        return written

    def load_model(self, directory: str, epoch: Optional[int] = None):
        if not directory:
            print("Note that load_model() is skipped as no pretrained "
                  "model is given")
            return
        for name in self.get_model_names():
            path = self._resolve_aliased(directory, name, epoch)
            ckpt = load_checkpoint(path)
            state = self.convert_reference_state(name, ckpt["state_dict"])
            # Ignore fixed token vectors: class sets change between
            # train (base) and test (new) (reference coop.py:334-343)
            state.pop("token_prefix", None)
            state.pop("token_suffix", None)
            print(f'Loading weights to {name} from "{path}" '
                  f'(epoch = {ckpt["epoch"]})')
            self._set_params(name, state)

    def _set_params(self, name: str, loaded: Dict[str, Any]):
        """Non-strict merge of loaded tensors into the registered dict,
        each cast to the registered leaf's dtype and device and copied in
        place, so an optimizer over the registered tensors keeps them."""
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
                        with torch.no_grad():
                            v.copy_(t)
                        out[k] = v
            return out

        self._models[name]["params"] = merge(self._models[name]["params"],
                                             loaded)

    # -- mesh -----------------------------------------------------------------
    @property
    def mesh(self):
        """The (data, model) process mesh (``parallel/mesh.py``), built
        from TPU.MESH_SHAPE / MESH_AXES when the process group has more
        than one rank, else None (set ``_mesh = None`` to force the
        single-rank path)."""
        if not hasattr(self, "_mesh"):
            self._mesh = None
            if P.world()[1] > 1:
                self._mesh = P.mesh_from_cfg(self.cfg)
        return self._mesh

    #: True on trainers whose text fan-out splits its classes over a
    #: model axis (CoCoOp, ProDA)
    shards_classes = False

    @property
    def class_sharded(self) -> bool:
        """The step shards the class axis over the model ranks (each then
        holds a partial gradient of the trainables)."""
        return (self.shards_classes and self.mesh is not None
                and self.mesh.dims[1] > 1)

    # -- device staging -------------------------------------------------------
    def put_batch(self, array, global_batch: bool = False) -> torch.Tensor:
        """Host array -> tensor on this trainer's device (pinned memory,
        asynchronous copy, when that device is a card). The loaders
        already hand each data rank its rows; ``global_batch`` marks an
        array every rank holds whole (serving requests): on a mesh this
        rank's data-coordinate slice is taken, and a batch the data axis
        does not divide raises on more than one rank."""
        if global_batch:
            array = P.local_rows(array, self.mesh)
        if isinstance(array, torch.Tensor) and array.device == self.device:
            return array
        if isinstance(array, np.ndarray) and not array.flags.writeable:
            array = array.copy()  # torch.as_tensor wants writable memory
        t = torch.as_tensor(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _device_staged(self, loader):
        """One-batch-ahead staging: batch N+1's copy is issued before
        batch N is consumed, so the copy overlaps the device work. The
        wait for each batch from the loader is the span ``data.wait``."""
        batches = iter(loader)
        staged_prev = None
        while True:
            with profiling.span("data.wait"):
                batch = next(batches, _EXHAUSTED)
            if batch is _EXHAUSTED:
                break
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
