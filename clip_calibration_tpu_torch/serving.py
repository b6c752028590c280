"""Dataset-free batch inference: (weights, classnames) -> calibrated
probabilities.

Counterpart of ``clip_calibration_tpu/serving.py``:

- ``Predictor``: zero-shot CLIP from a backbone name, classnames and a
  template (reference ``trainers/classification/zsclip.py:74-102``
  semantics), or a prompt-tuned model from a CoOp-family checkpoint
  (``from_prompt_checkpoint``); DAC class confidences and a fitted
  temperature ride on top; ``quantize`` runs the vision tower int8
  (``ops/quant.py``: weight-only ``int8``, or ``w8a8`` products through
  kernel K3 on the card, with dynamic or calibrated static activation
  scales).
- ``TrainerPredictor`` serves any ported trainer (ZeroshotCLIP, CoOp,
  TempScaling) through its own inference, built without a dataset
  directory by ``build_serving_trainer``.

Images enter as uint8 NHWC at the model resolution (or, with
``preprocess_on_device``, at any uniform size). Short chunks pad to the
next power of two (``_drain_batched``). Every predictor lives on one
device, default ``cuda``; asking for it without a card raises.

On a process mesh (``parallel/mesh.py``; ``Predictor(mesh=...)``, or a
``TrainerPredictor`` over a trainer built on one) serving is SPMD: every
rank calls ``predict`` with the same images, ``batch_size`` rounds up to
a multiple of the data axis, each data rank encodes its slice of every
chunk (the ViT tower tensor-parallel over a model axis > 1,
``parallel/tp.py``, int8 weights included), and the probabilities are
gathered, so every rank returns the whole result. HTTP serving over a
mesh runs ``parallel/http_mesh.py``: rank 0 serves, the other ranks join
each batch.
"""

from __future__ import annotations

import os
import os.path as osp
import types
from typing import Optional, Sequence

import numpy as np
import torch

from .models import clip as M
from .models.backbone import load_clip_backbone
from .models.tokenizer import tokenize
from .ops.preprocess import (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD,
                             device_preprocess, normalize_images)
from .ops.quant import bucket_qmode
from .ops.scoring import fused_dac_scores
from .parallel import mesh as P
from .parallel.tp import tower_tp
from .tools.device import resolve_device

# Max chunks enqueued on the device ahead of the first fetch of a predict()
# call: enough to overlap the copies with compute, small enough that the
# staged inputs of a very large image set never pile up on the device.
_MAX_IN_FLIGHT = 4

def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _drain_batched(images: np.ndarray, batch_size: int, dispatch,
                   fetch, bucket: bool = False,
                   multiple: int = 1) -> np.ndarray:
    """Pad each chunk to ``batch_size``, dispatch it (device work is only
    enqueued), keep at most ``_MAX_IN_FLIGHT`` chunks pending, fetch fp32
    rows, trim the pad.

    ``bucket``: pad a SHORT chunk to the next power of two instead of
    the full ``batch_size``, so a lone request costs a 1-image encode.
    ``multiple``: every chunk's rows a multiple of it (a mesh's data
    axis). The pad repeats the chunk's last image."""
    n = images.shape[0]
    pending, done = [], []
    for i in range(0, n, batch_size):
        batch = images[i:i + batch_size]
        short = batch.shape[0]
        if short < batch_size:
            target = batch_size
            if bucket:
                target = 1
                while target < short:
                    target *= 2
                target = min(_round_up(target, multiple), batch_size)
            if short < target:
                pad = np.repeat(batch[-1:], target - short, axis=0)
                batch = np.concatenate([batch, pad])
        pending.append(dispatch(batch))
        if len(pending) >= _MAX_IN_FLIGHT:
            done.append(fetch(pending.pop(0)))
    done.extend(fetch(p) for p in pending)
    return np.concatenate(done)[:n]


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor (pinned, asynchronous copy to a card).
    Pinned memory is allocated by the calling thread."""
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:  # torch.from_numpy needs writable memory
        array = array.copy()
    t = torch.from_numpy(array)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _empty_result(n_cls: int) -> dict:
    return {"probs": np.zeros((0, n_cls), np.float32),
            "preds": np.zeros((0,), np.int64),
            "confidences": np.zeros((0,), np.float32)}


class Predictor:
    """Batched calibrated image classification over fixed classnames.

    ``quantize="int8"``: weight-only int8 vision tower (per-output-channel
    scales, dequantized into each matmul). ``quantize="w8a8"``: int8 x
    int8 products (K3 on the card); with ``calibration_images`` (a
    representative uint8 batch, any H x W: it goes through the request
    preprocessing) or ``act_scales`` (an npz written by
    ``ops/quant.save_act_stats`` from ``self.act_stats``, or the stats
    pytree) the activations use static calibrated scales, else dynamic
    per-row ones. With static scales a batch of one row runs the dynamic
    path (the JAX package's 1-row bucket rule: it changes the numbers,
    not only the speed). Text features and the calibration math stay
    full precision.
    """

    def __init__(self, backbone: str, classnames: Sequence[str],
                 template: str = "a photo of a {}.",
                 precision: str = "bf16", batch_size: int = 64,
                 class_confidence: Optional[np.ndarray] = None,
                 temperature: Optional[float] = None,
                 mesh=None,
                 pixel_stats=(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD),
                 preprocess_on_device: bool = False,
                 quantize: Optional[str] = None,
                 calibration_images: Optional[np.ndarray] = None,
                 act_scales=None,
                 device="cuda",
                 _text_features: Optional[torch.Tensor] = None):
        self.device = resolve_device(device)
        self.classnames = list(classnames)
        self.batch_size = int(batch_size)
        self.mesh = mesh
        self.tp = tower_tp(mesh)
        if mesh is not None:
            self.batch_size = _round_up(self.batch_size, mesh.dims[0])
        self.preprocess_on_device = bool(preprocess_on_device)
        if quantize == "w8a8_kernel":
            raise ValueError(
                "quantize='w8a8_kernel' is no longer a serving mode "
                "(the JAX package removed it); use 'w8a8', which runs the "
                "int8 kernel on the card")
        if quantize not in (None, "int8", "w8a8"):
            raise ValueError(f"quantize={quantize!r}: expected None, "
                             f"'int8' or 'w8a8'")
        if (calibration_images is not None or act_scales is not None) \
                and quantize != "w8a8":
            raise ValueError(
                "calibration_images/act_scales only apply to "
                "quantize='w8a8' (static activation scales — "
                "ops/quant.py)")
        if calibration_images is not None and act_scales is not None:
            raise ValueError(
                "pass calibration_images (calibrate now) OR act_scales "
                "(previously saved stats), not both")
        self.model, self.cfg = load_clip_backbone(
            backbone, "float32" if precision == "fp32" else "bfloat16",
            self.device)
        if self.tp is not None and not self.cfg.is_vit:
            # fail at construction, not at the first request
            raise ValueError(
                "Tensor-parallel serving covers the ViT towers only; "
                "serve ResNet backbones on a data-only mesh "
                "(parallel/tp.py)")
        self.dtype = torch.float32 if precision == "fp32" else torch.bfloat16
        from .ops import quant as Q
        if quantize is not None:
            # the vision tower only: text encodes once, right below
            self.model = Q.quantize_clip_params(self.model)
        self.quantize = quantize
        self.qmode = quantize if quantize == "w8a8" else "dequant"

        if _text_features is None:
            toks = tokenize([template.format(c.replace("_", " "))
                             for c in self.classnames])
            with torch.inference_mode():
                _text_features = M.normalize(M.encode_text(
                    self.model, self.cfg,
                    torch.as_tensor(toks, dtype=torch.long,
                                    device=self.device),
                    dtype=self.dtype, seq_len=M.eot_seq_len(toks)))
        self.text_features = _text_features

        if class_confidence is not None and \
                len(class_confidence) != len(self.classnames):
            # a wrong-length vector would gather out of range
            raise ValueError(
                f"class_confidence has {len(class_confidence)} entries "
                f"for {len(self.classnames)} classnames")
        n_cls = len(self.classnames)
        self.class_confidence = torch.as_tensor(
            np.ones((n_cls,), np.float32) if class_confidence is None
            else np.asarray(class_confidence, np.float32),
            device=self.device)
        self.temperature = temperature
        # checkpoints carry no pixel stats: the default is the CLIP
        # constants every reference yaml uses; (None, None) for a model
        # trained ToTensor-only
        self.pixel_stats = tuple(pixel_stats)

        self.act_stats = None
        if calibration_images is not None:
            with torch.inference_mode():
                cal = self._preprocess(_to_device(
                    np.asarray(calibration_images), self.device))
                stats = Q.calibrate_image_act_scales(self.model, self.cfg,
                                                     cal)
            self.act_stats = Q.stats_to_numpy(stats)
        elif isinstance(act_scales, (str, os.PathLike)):
            self.act_stats = Q.load_act_stats(os.fspath(act_scales))
        elif act_scales is not None:
            self.act_stats = act_scales
        if self.act_stats is not None:
            self.model = Q.attach_act_scales(self.model, self.act_stats)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_prompt_checkpoint(cls, backbone: str,
                               classnames: Sequence[str],
                               checkpoint_dir: str,
                               n_ctx: int = 16, ctx_init: str = "",
                               class_token_position: str = "end",
                               epoch: Optional[int] = None,
                               **kwargs) -> "Predictor":
        """CoOp-family prompt-tuned predictor from a checkpoint dir laid
        out like training output (``<dir>/prompt_learner/model.pth.tar-N``,
        reference torch or native npz)."""
        from .engine.checkpoint import load_checkpoint, resolve_model_file
        from .trainers.coop import assemble_prompts, build_prompt_assembly

        self = cls(backbone, classnames, _text_features=torch.zeros((0,)),
                   **kwargs)
        path = resolve_model_file(
            osp.join(checkpoint_dir, "prompt_learner"), epoch)
        ctx = load_checkpoint(path)["state_dict"]["ctx"].float()
        if ctx.ndim >= 2 and ctx.shape[-2] != n_ctx:
            n_ctx = ctx.shape[-2]
        asm = build_prompt_assembly(self.classnames, n_ctx,
                                    class_token_position, ctx_init,
                                    self.model, self.dtype)
        want = ((len(self.classnames), asm["n_ctx"])
                if ctx.ndim == 3 else (asm["n_ctx"],))
        if tuple(ctx.shape[:-1]) != want:
            raise ValueError(
                f"checkpoint ctx shape {tuple(ctx.shape)} does not fit "
                f"the assembled prompt layout (expected leading dims "
                f"{want}); check n_ctx/ctx_init/classnames")
        with torch.inference_mode():
            prompts = assemble_prompts(ctx.to(self.device), asm)
            self.text_features = M.normalize(M.encode_text_embedded(
                self.model, self.cfg, prompts, asm["eot_pos"],
                seq_len=asm["seq_len"]))
        return self

    # -- inference ------------------------------------------------------------
    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        res = self.cfg.image_resolution
        if tuple(images.shape[1:3]) != (res, res):
            # resize + center-crop + normalize on the device; reached only
            # with preprocess_on_device (and for calibration images)
            return device_preprocess(images, res, *self.pixel_stats,
                                     dtype=self.dtype)
        return normalize_images(images, *self.pixel_stats, dtype=self.dtype)

    def _predict_step(self, images: np.ndarray, scale: torch.Tensor,
                      conf: torch.Tensor) -> torch.Tensor:
        """Encode + calibrated scoring of one padded chunk; the features
        stay on the device. On a mesh this data rank's rows, the
        probabilities gathered."""
        # the 1-row bucket (of the whole chunk) runs per-row scales
        q = bucket_qmode(self.qmode, images.shape[0])
        images = _to_device(P.local_rows(images, self.mesh), self.device)
        img_f = M.normalize(M.encode_image(
            self.model, self.cfg, self._preprocess(images), dtype=self.dtype,
            qmode=q, tp=self.tp))
        probs, _ = fused_dac_scores(img_f, self.text_features, scale, conf,
                                    normalized=True)
        return P.gather_data(probs, self.mesh)

    def check_images(self, images) -> np.ndarray:
        """``images`` as an array, after the checks ``predict`` makes
        before any device work or collective (a ValueError names what is
        wrong); an empty batch passes."""
        images = np.asarray(images)
        if images.size == 0:
            return images
        if images.dtype != np.uint8:
            raise ValueError("Predictor.predict expects uint8 images; "
                             "apply host-side geometry first")
        res = self.cfg.image_resolution
        if images.ndim != 4 or images.shape[-1] != 3 or (
                not self.preprocess_on_device
                and images.shape[1:3] != (res, res)):
            raise ValueError(
                f"expected [N, {res}, {res}, 3] images; got "
                f"{images.shape} — resize host-side "
                f"(data/transforms.build_transform) or construct with "
                f"preprocess_on_device=True")
        return images

    def predict(self, images: np.ndarray) -> dict:
        """images: uint8 [N, H, W, 3] at the model resolution, or, with
        ``preprocess_on_device``, at any uniform source size. Returns
        dict(probs [N, C] fp32, preds [N], confidences [N]). Runs under
        its own ``inference_mode`` (the HTTP server calls it from a
        worker thread)."""
        images = self.check_images(images)
        if images.size == 0:  # upstream filters can drop every image
            return _empty_result(len(self.classnames))
        with torch.inference_mode():
            scale = self.model.logit_scale
            if self.temperature is not None:
                # a fitted temperature REPLACES exp(logit_scale)
                # (reference tempscaling.py ScaleLearner semantics)
                scale = torch.log(torch.tensor(
                    self.temperature, dtype=torch.float32,
                    device=self.device))
            probs = _drain_batched(
                images, self.batch_size,
                lambda b: self._predict_step(b, scale,
                                             self.class_confidence),
                lambda p: p.float().cpu().numpy(), bucket=True,
                multiple=self.mesh.dims[0] if self.mesh else 1)
        preds = probs.argmax(axis=1)
        return {"probs": probs, "preds": preds,
                "confidences": probs.max(axis=1)}


class _ServingLoaderStub:
    """Stands in for the train loader in serving builds: trainers size
    their LR schedules by ``len(train_loader_x)`` at build time, nothing
    else is touched (serving never trains)."""

    def __len__(self):
        return 1

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(())


class _ServingDataManager:
    """Classnames-only DataManager stand-in: everything the trainers read
    from ``self.dm`` at build and inference time."""

    def __init__(self, classnames: Sequence[str]):
        cns = list(classnames)
        self.dataset = types.SimpleNamespace(classnames=cns,
                                             num_classes=len(cns))
        self.num_classes = len(cns)
        self.lab2cname = {i: c for i, c in enumerate(cns)}
        self.train_loader_x = _ServingLoaderStub()
        self.val_loader = None
        self.test_loader = None


def build_serving_trainer(classnames: Sequence[str],
                          trainer_name: Optional[str] = None,
                          backbone: Optional[str] = None,
                          config_file: Optional[str] = None,
                          opts: Optional[Sequence] = None,
                          cfg=None, device="cuda"):
    """Build a registered trainer WITHOUT a dataset directory: the
    DataManager is replaced by a classnames-only stub, everything else
    (prompt assembly, steps, checkpoint loading) is the trainer's own
    code. Pass ``config_file``/``opts`` to reproduce the training run's
    hyperparameters (N_CTX, ...) before ``trainer.load_model``."""
    from .config import get_cfg_default
    from .engine.registry import TRAINER_REGISTRY
    from . import trainers as _register_trainers  # noqa: F401
    from .evaluators import vl_evaluator as _register_eval  # noqa: F401

    if cfg is not None:
        overrides = {"trainer_name": trainer_name, "backbone": backbone,
                     "config_file": config_file, "opts": opts}
        clash = [k for k, v in overrides.items() if v]
        if clash:
            # silently ignoring these would build a prompt layout that
            # does not match the checkpoint the caller loads next
            raise ValueError(
                f"build_serving_trainer: {clash} are ignored when an "
                f"explicit cfg is passed — bake them into the cfg, or "
                f"drop the cfg argument")
    if cfg is None:
        cfg = get_cfg_default()
        if config_file:
            # the training config verbatim, whether it normalized or not
            cfg.merge_from_file(config_file)
        else:
            # the reference trainer yamls' normalize block (CLIP pixel
            # stats), the constants Predictor uses too
            cfg.INPUT.PIXEL_MEAN = list(CLIP_PIXEL_MEAN)
            cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_STD)
            cfg.INPUT.TRANSFORMS = ("random_resized_crop",
                                    "random_flip", "normalize")
        if trainer_name:
            cfg.TRAINER.NAME = trainer_name
        if backbone:
            cfg.MODEL.BACKBONE.NAME = backbone
        cfg.TEST.EVALUATOR = "VLClassification"
        if opts:
            cfg.merge_from_list(list(opts))

    def serving_class(base_cls):
        class ServingTrainer(base_cls):
            def build_data_loader(self):
                self.dm = _ServingDataManager(classnames)
                self.train_loader_x = self.dm.train_loader_x
                self.val_loader = None
                self.test_loader = None
                self.num_classes = self.dm.num_classes
                self.lab2cname = self.dm.lab2cname

        ServingTrainer.__name__ = f"Serving{base_cls.__name__}"
        ServingTrainer.__qualname__ = ServingTrainer.__name__
        return ServingTrainer

    # TempScaling builds its base learner through TRAINER_REGISTRY.get
    # inside build_model: route that nested build through the same
    # dataset-free subclass. The override is thread-local
    # (Registry.wrapped).
    with TRAINER_REGISTRY.wrapped(serving_class):
        trainer = TRAINER_REGISTRY.get(cfg.TRAINER.NAME)(cfg, device=device)
    return trainer


class TrainerPredictor:
    """Serve a built trainer through its own ``model_inference``, with
    static-shape batching and optional DAC class confidences applied as
    the eval pipeline does (reference ``vl_calibrator.py``: DAC scales the
    logits, softmax after), on the device: only the probabilities are
    fetched. For a fitted temperature, serve a TempScaling trainer (its
    ``model_inference`` already returns tempered logits)."""

    def __init__(self, trainer, class_confidence=None,
                 batch_size: Optional[int] = None):
        self.trainer = trainer
        self.batch_size = int(batch_size
                              or trainer.cfg.DATALOADER.TEST.BATCH_SIZE)
        if trainer.mesh is not None:
            # every padded chunk splits evenly over the data axis
            self.batch_size = _round_up(self.batch_size,
                                        trainer.mesh.dims[0])
        n_cls = trainer.dm.num_classes
        if class_confidence is not None and len(class_confidence) != n_cls:
            raise ValueError(
                f"class_confidence has {len(class_confidence)} entries "
                f"for {n_cls} classes")
        self.class_confidence = torch.as_tensor(
            np.ones((n_cls,), np.float32) if class_confidence is None
            else np.asarray(class_confidence, np.float32),
            device=trainer.device)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        classnames: Sequence[str],
                        trainer_name: Optional[str] = None,
                        backbone: Optional[str] = None,
                        config_file: Optional[str] = None,
                        opts: Optional[Sequence] = None,
                        epoch: Optional[int] = None,
                        class_confidence=None,
                        batch_size: Optional[int] = None,
                        device="cuda") -> "TrainerPredictor":
        """Dataset-free serving: build the trainer from (classnames,
        config), load its checkpoint dir (reference torch
        ``model.pth.tar-N`` or native npz), serve."""
        trainer = build_serving_trainer(
            classnames, trainer_name=trainer_name, backbone=backbone,
            config_file=config_file, opts=opts, device=device)
        trainer.load_model(checkpoint_dir, epoch)
        return cls(trainer, class_confidence=class_confidence,
                   batch_size=batch_size)

    def _score(self, logits: torch.Tensor) -> torch.Tensor:
        """DAC on the argmax class, then softmax (fp32, on the device)."""
        lg = logits.float()
        preds = lg.argmax(dim=1)
        lg = lg * self.class_confidence[preds][:, None]
        return torch.softmax(lg, dim=-1)

    def check_images(self, images) -> np.ndarray:
        """``images`` as an array, after the checks ``predict`` makes
        before any device work or collective (a ValueError names what is
        wrong); an empty batch passes."""
        images = np.asarray(images)
        if images.size == 0:
            return images
        res = self.trainer.clip_cfg.image_resolution
        if images.dtype != np.uint8 or images.ndim != 4 or \
                images.shape[1:] != (res, res, 3):
            # float input would be re-scaled into garbage; channels-first
            # would mix channels into spatial positions
            raise ValueError(
                f"TrainerPredictor.predict expects uint8 [N, {res}, {res}, "
                f"3] images; got {images.dtype} {images.shape} — apply "
                f"host-side geometry first "
                f"(data/transforms.build_transform)")
        return images

    def predict(self, images: np.ndarray) -> dict:
        """images: uint8 [N, H, W, 3] at the model resolution."""
        images = self.check_images(images)
        if images.size == 0:
            return _empty_result(self.trainer.dm.num_classes)
        trainer = self.trainer
        with torch.inference_mode():
            probs = _drain_batched(
                images, self.batch_size,
                lambda b: P.gather_data(self._score(trainer.model_inference(
                    trainer.put_batch(b, global_batch=True))[0]),
                    trainer.mesh),
                lambda p: p.float().cpu().numpy())
        preds = probs.argmax(axis=1)
        return {"probs": probs, "preds": preds,
                "confidences": probs.max(axis=1)}
