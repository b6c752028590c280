"""VLBaseLearner: the calibrated-evaluation pipeline.

Parity target: reference ``trainers/classification/base_learner.py``.
``test()`` runs the inference loop, persists/loads the cross-run feature
caches (``./temp/base_features/...`` and ``./temp/knndist/...`` — the
filesystem handshake that coordinates the ZeroshotCLIP-base -> trainer-base
-> new-class-eval pipeline), assembles the 4-way text-feature dict, fits
VLCalibration, computes test-set proximity, and evaluates calibrated
probabilities.

The caches are npz payloads under the reference's paths and file names,
byte-compatible with the JAX package's (a torch reader covers caches
written by the reference). Text features are computed once per class set;
the eval loop stages batches to the device one ahead and fetches batch N
while batch N+1 runs.
"""

from __future__ import annotations

import functools
import io
import os
import os.path as osp

import numpy as np
import torch

from ..engine.optim import (build_lr_schedule, build_optimizer,
                            sorted_leaves)
from ..engine.registry import TRAINER_REGISTRY
from ..engine.trainer import TrainerX
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..models.tokenizer import tokenize
from ..parallel import mesh as P
from .calibration.proximity import (get_knn_dists, get_val_image_knn_dists,
                                    proximity_from_dists)
from .calibration.vl_calibrator import VLCalibration
from .templates import build_clip_templates

TEMP_ROOT = "./temp"


def _save_feature_dict(path: str, d: dict) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in d.items()})


def _load_feature_dict(path: str) -> dict:
    try:
        with open(path, "rb") as f:
            data = np.load(io.BytesIO(f.read()), allow_pickle=False)
            out = {k: data[k] for k in data.files}
            # torch zip archives also open as npz but yield raw bytes
            if not out or not all(isinstance(v, np.ndarray)
                                  for v in out.values()):
                raise ValueError("not an npz feature cache")
            return out
    except (ValueError, OSError):
        d = torch.load(path, map_location="cpu", weights_only=False)
        return {k: np.asarray(v) for k, v in d.items()}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@functools.lru_cache(maxsize=2)
def _zs_clip_cached(backbone_name: str, ckpt_dir, dtype_str: str,
                    device: str):
    return load_clip_backbone(backbone_name, dtype_str, device)


def _zs_clip(backbone_name: str, precision: str, device):
    """Frozen zero-shot CLIP for calibration text features (reference
    ``tools/zsclip_encoder.py:29-48``), cached per backbone, weight dir,
    precision and device."""
    return _zs_clip_cached(
        backbone_name, os.environ.get("CLIP_CHECKPOINT_DIR"),
        "float32" if precision == "fp32" else "bfloat16", str(device))


@torch.no_grad()
def encode_prompt_sets(model, ccfg, prompt_sets, dtype) -> torch.Tensor:
    """Frozen class text features averaged over prompt sets: each set
    (one template) holds one prompt a class and runs as one batch, so
    memory follows the class count, not the template count; every set is
    truncated at the furthest EOT of all of them. Returns [n_cls,
    embed_dim] in ``dtype``. ``model`` needs only ``text`` and
    ``logit_scale``."""
    toks = [tokenize(s) for s in prompt_sets]
    seq = max(M.eot_seq_len(t) for t in toks)
    device = model.logit_scale.device
    feats = [M.encode_text(model, ccfg,
                           torch.as_tensor(t, dtype=torch.long,
                                           device=device),
                           dtype=dtype, seq_len=seq) for t in toks]
    return feats[0] if len(feats) == 1 else torch.stack(feats).mean(0)


@torch.inference_mode()
def encode_classnames_zs(backbone_name: str, dataset_name: str, classnames,
                         template: str | None = None,
                         precision: str = "bf16",
                         device="cuda") -> np.ndarray:
    """Zero-shot text features for the given class names, normalized."""
    model, ccfg = _zs_clip(backbone_name, precision, device)
    dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    temp = template or build_clip_templates(dataset_name)
    prompts = [temp.format(c.replace("_", " ")) for c in classnames]
    return _host(M.normalize(encode_prompt_sets(model, ccfg, [prompts],
                                                dtype)))


@TRAINER_REGISTRY.register()
class VLBaseLearner(TrainerX):
    """Base trainer for vision-language tuning and calibration."""

    #: True on trainers whose ``model_inference`` logits are exactly
    #: ``exp(logit_scale) * norm(img_f) @ norm(txt_f).T`` of the features
    #: it returns — the contract the fused DAC scoring (ops/scoring.py)
    #: recomputes on the device.
    fused_dac_scoring = False

    def fused_dac_logit_scale(self):
        """Log logit-scale for the fused DAC scoring path, or None when
        this trainer's logits are not plain cosine scores."""
        if not self.fused_dac_scoring:
            return None
        return self.clip_model.logit_scale

    # -- training ------------------------------------------------------------
    def register_trainable(self, name: str, params: dict):
        """Register ``params`` (a nested dict of tensors, every one
        trained) as ``name``, with the configured optimizer and the LR
        schedule over this run's train loader."""
        for t in sorted_leaves(params):
            t.requires_grad_(True)
        self.register_model(
            name, params,
            lambda: build_optimizer(
                self.cfg, sorted_leaves(self.model_params(name))),
            build_lr_schedule(self.cfg, len(self.train_loader_x)))

    def loss_step(self, name: str, batch) -> dict:
        """One train step of ``name``'s tensors on ``self._loss(images,
        labels)``: backward, then the optimizer step. The loss stays on
        the device (on a mesh: the global batch's mean)."""
        images, labels = self.parse_batch_train(batch)
        self.optimizer(name).zero_grad(set_to_none=True)
        loss = self._loss(images, self.put_batch(labels))
        loss.backward()
        self.optimizer_step(name)
        return {"loss": P.data_mean(loss.detach(), self.mesh)}

    # -- quantized frozen vision tower (TRAINER.QUANT_FROZEN_VISION) -------
    #: True on trainers whose image tower takes TRAINABLE prompt inputs
    #: (VPT, MaPLe, PromptSRC): the tower is on the gradient path there
    #: and cannot run quantized
    vision_tower_trainable = False
    #: encode_image qmode of the frozen tower ("dequant" = full precision
    #: on plain weights; set by setup_frozen_vision)
    vision_qmode = "dequant"

    @property
    def step_clip_params(self):
        """The frozen CLIP the steps run: ``clip_model``, unless
        ``TRAINER.QUANT_FROZEN_VISION`` put a copy with an int8 vision
        tower in its place (the text tower is the same module either
        way, so the text path is bit-identical)."""
        m = getattr(self, "_step_clip_params", None)
        return self.clip_model if m is None else m

    def vision_qmode_for(self, batch_rows: int) -> str:
        """qmode of an image batch of ``batch_rows`` rows: under w8a8 a
        single row runs the dynamic per-row path over the same int8
        weights, as the serving Predictor's 1-row bucket does (the JAX
        package's rule; it changes the numbers, not only the speed). On a
        mesh the rule reads the global batch (this rank's rows times the
        data axis), as the JAX program's shape does."""
        if self.mesh is not None:
            batch_rows *= self.mesh.dims[0]
        if self.vision_qmode == "w8a8" and batch_rows == 1:
            return "w8a8_dynamic"
        return self.vision_qmode

    def _calibration_images(self):
        """One raw uint8 image batch for static activation-scale
        calibration, preferring the train distribution."""
        for loader in (getattr(self, "train_loader_x", None),
                       getattr(self, "val_loader", None),
                       getattr(self, "test_loader", None)):
            if loader is None:
                continue
            # serving builds carry loader stubs that report len > 0 but
            # yield nothing (serving._ServingLoaderStub)
            batch = next(iter(loader), None)
            if batch is not None and "img" in batch:
                return batch["img"]
        raise ValueError(
            "TRAINER.QUANT_FROZEN_VISION=w8a8 needs a data loader to "
            "draw a calibration batch from; dataset-free serving builds "
            "have none — serve this checkpoint with the flag overridden "
            "(opts: TRAINER.QUANT_FROZEN_VISION '' for full precision, "
            "or 'int8' for calibration-free weight-only quantization)")

    @torch.no_grad()
    def setup_frozen_vision(self):
        """Opt-in quantized frozen vision tower for training and eval
        (``TRAINER.QUANT_FROZEN_VISION``: '', 'int8' weight-only, or
        'w8a8' with static activation scales calibrated on one loader
        batch). Gradients never flow through the image tower of the
        trainers that call this, so only its features change, by
        quantization noise; the text tower, logits and checkpoints stay
        exact. Call after ``clip_model`` exists."""
        self.setup_eval_text_quant()  # validates that flag for everyone
        mode = self.cfg.TRAINER.QUANT_FROZEN_VISION
        if not mode:
            return
        if mode not in ("int8", "w8a8"):
            raise ValueError(
                f"TRAINER.QUANT_FROZEN_VISION={mode!r}: expected '', "
                "'int8' or 'w8a8'")
        if self.vision_tower_trainable:
            raise ValueError(
                f"{type(self).__name__} trains vision-side prompts — the "
                "image tower is on the gradient path and cannot run "
                "quantized (TRAINER.QUANT_FROZEN_VISION applies to "
                "frozen-vision trainers only)")
        from ..ops import quant as Q
        from ..ops.preprocess import normalize_images
        qm = Q.quantize_clip_params(self.clip_model)
        if mode == "w8a8":
            x = normalize_images(self.put_batch(self._calibration_images()),
                                 *self.pixel_stats, dtype=self.compute_dtype)
            stats = Q.calibrate_image_act_scales(qm, self.clip_cfg, x)
            # on a mesh each data rank calibrated on ITS slice of the
            # batch: absmax statistics reduce with max, so every rank
            # attaches the scales one process would
            stats = _tree_map(lambda t: P.max_over_ranks(t, self.mesh),
                              stats)
            qm = Q.attach_act_scales(qm, stats)
        self._step_clip_params = qm
        self.vision_qmode = "w8a8" if mode == "w8a8" else "dequant"
        print(f"Frozen vision tower quantized: mode={mode} "
              f"(TRAINER.QUANT_FROZEN_VISION)")

    # -- quantized eval-time text fan-out (TRAINER.QUANT_EVAL_TEXT) --------
    #: True on trainers whose EVAL re-runs the text tower per request
    #: (CoCoOp's per-image class encodes, ProDA's set_classifier sweep);
    #: the one-shot class features of the CoOp family stay full precision
    text_eval_quant_supported = False
    #: "", "int8" (weight-only) or "w8a8" (static calibrated scales); set
    #: by setup_eval_text_quant from TRAINER.QUANT_EVAL_TEXT
    text_eval_quant = ""

    def setup_eval_text_quant(self):
        """Validate ``TRAINER.QUANT_EVAL_TEXT`` ('', 'int8' or 'w8a8') and
        turn it on for the trainers that support it. Eval runs no
        gradients, so the per-request text encodes may run int8 (K3 under
        w8a8) while every train step keeps the full-precision text tower
        its prompts' gradients flow through. Called from
        ``setup_frozen_vision``, so every trainer validates the flag."""
        mode = self.cfg.TRAINER.QUANT_EVAL_TEXT
        if not mode:
            return
        if mode not in ("int8", "w8a8"):
            raise ValueError(
                f"TRAINER.QUANT_EVAL_TEXT={mode!r}: expected '', "
                "'int8' or 'w8a8'")
        if not self.text_eval_quant_supported:
            raise ValueError(
                f"{type(self).__name__} encodes its class features once "
                "per eval — TRAINER.QUANT_EVAL_TEXT applies to the "
                "per-request text fan-out trainers (CoCoOp, ProDA) only")
        self.text_eval_quant = mode
        self._eval_text_params = None
        print(f"Eval text fan-out quantized: mode={mode} "
              f"(TRAINER.QUANT_EVAL_TEXT)")

    def text_eval_qmode(self) -> str:
        """The text encodes' qmode under ``text_eval_quant`` ("dequant"
        runs the weight-only int8 weights at full-precision math)."""
        return "w8a8" if self.text_eval_quant == "w8a8" else "dequant"

    def invalidate_eval_text_quant(self):
        """Drop the cached quantized text tower: call after any change of
        the learned prompts (the w8a8 scales are calibrated on them)."""
        self._eval_text_params = None

    @torch.no_grad()
    def eval_text_clip_params(self):
        """The frozen CLIP for eval-time text encodes: ``step_clip_params``
        with the text tower's matmul weights int8, plus static activation
        scales under "w8a8", calibrated on the trainer's own prompt rows
        (``_text_calibration_prompts``). Made at first use, remade after
        ``invalidate_eval_text_quant``."""
        q = getattr(self, "_eval_text_params", None)
        if q is not None:
            return q
        from ..ops import quant as Q
        q = Q.quantize_clip_params(self.step_clip_params, towers=("text",))
        if self.text_eval_quant == "w8a8":
            prompts, eots, seq_len = self._text_calibration_prompts()
            q = Q.attach_text_act_scales(q, Q.calibrate_text_act_scales(
                q, self.clip_cfg, prompts, eots, seq_len=seq_len))
        self._eval_text_params = q
        return q

    def _text_calibration_prompts(self):
        """(embedded prompts [N, 77, D], eot_pos [N], seq_len) for the
        text activation-scale calibration; the supporting trainers
        override it."""
        raise NotImplementedError(
            f"{type(self).__name__} supports TRAINER.QUANT_EVAL_TEXT "
            "but provides no calibration prompts")

    # -- cache paths (reference base_learner.py:106-108,123-134) ------------
    def _base_feature_dir(self, subsample: str) -> str:
        cfg = self.cfg
        return osp.join(TEMP_ROOT, "base_features", cfg.DATASET.NAME,
                        cfg.TRAINER.NAME,
                        "shots" + str(cfg.DATASET.NUM_SHOTS),
                        cfg.MODEL.BACKBONE.NAME, subsample,
                        "seed" + str(cfg.SEED))

    def _knndist_dir(self) -> str:
        cfg = self.cfg
        return osp.join(TEMP_ROOT, "knndist", cfg.DATASET.NAME,
                        cfg.TRAINER.NAME,
                        "shots" + str(cfg.DATASET.NUM_SHOTS),
                        cfg.MODEL.BACKBONE.NAME,
                        cfg.DATASET.SUBSAMPLE_CLASSES,
                        "seed" + str(cfg.SEED),
                        "nn" + str(cfg.CALIBRATION.PROCAL.IMAGE_K))

    # -- inference loop -------------------------------------------------------
    @torch.inference_mode()
    def _run_inference(self, data_loader):
        """Returns (logits, labels, image_features, text_features) as
        host arrays. Batch N's outputs are fetched after batch N+1 has
        been queued, so the copy back overlaps the next batch's work.

        On a mesh each data rank infers its slice of every batch; the
        rows are gathered in data order (``n`` is the global real-row
        count), and the text features are the last data rank's (the last
        image's, for CoCoOp), so every rank returns what one process
        would."""
        logits_all, labels_all, img_f_all = [], [], []
        text_features = None
        pending = None
        mesh = self.mesh

        def collect(p):
            (output, img_f, txt_f), n, labels = p
            logits_all.append(P.to_host_global(output, mesh)[:n])
            img_f_all.append(P.to_host_global(img_f, mesh)[:n])
            labels_all.append(P.to_host_global(labels, mesh)[:n])
            return txt_f

        for batch in self._device_staged(data_loader):
            images, labels = self.parse_batch_test(batch)
            out = self.model_inference(images)
            if pending is not None:
                text_features = collect(pending)
            pending = (out, batch["n_real"], labels)
        if pending is not None:
            text_features = collect(pending)
        text_features = P.from_last_data_rank(text_features, mesh)
        return (np.concatenate(logits_all), np.concatenate(labels_all),
                np.concatenate(img_f_all), _host(text_features))

    # -- the generic testing pipeline (reference base_learner.py:59-152) ----
    def test(self, split=None):
        self.set_model_mode("eval")
        self.evaluator.reset()
        cfg = self.cfg

        if split is None:
            split = cfg.TEST.SPLIT
        if split == "val" and self.val_loader is not None:
            data_loader = self.val_loader
        else:
            split = "test"
            data_loader = self.test_loader
        print(f"Evaluate on the *{split}* set")

        logits, labels, image_features_test, text_features_test = \
            self._run_inference(data_loader)

        # cache base-class val features (trains the calibrator downstream)
        if cfg.DATASET.SUBSAMPLE_CLASSES == "base":
            self.save_base_val_features()

        val_feature_path = osp.join(self._base_feature_dir("base"),
                                    "base_features.pt")
        val_dict = _load_feature_dict(val_feature_path)

        calibrator = VLCalibration(
            cfg,
            cfg.CALIBRATION.BASE_CALIBRATION_MODE,
            cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME,
            cfg.CALIBRATION.DAC.IF_DAC,
            cfg.CALIBRATION.PROCAL.IF_PROCAL,
            val_dict,
            self.get_text_features(text_features_test,
                                   val_dict=val_dict))
        calibrator.fit()

        # test-set proximity (cached only for the test split: the cache
        # path has no split component)
        base_val_image_features = val_dict["val_image_features"]
        k = cfg.CALIBRATION.PROCAL.IMAGE_K
        if split == "test":
            dist_dir = self._knndist_dir()
            dist_path = osp.join(dist_dir, "knndist.npy")
            if osp.exists(dist_path):
                print(f"load the knn distance from: {dist_path}")
                knndists = np.load(dist_path)
            else:
                knndists = get_knn_dists(base_val_image_features,
                                         image_features_test, k,
                                         device=self.device)
                os.makedirs(dist_dir, exist_ok=True)
                np.save(dist_path, knndists)
        else:
            knndists = get_knn_dists(base_val_image_features,
                                     image_features_test, k,
                                     device=self.device)
        test_img_proximity = proximity_from_dists(knndists)

        probs = self._calibrated_probs(calibrator, logits,
                                       image_features_test,
                                       text_features_test,
                                       test_img_proximity)
        results = self.evaluator.evaluate(probs, labels,
                                          test_img_proximity)

        for name, value in results.items():
            self.write_scalar(f"{split}/{name}", value, self.epoch)
        return list(results.values())[0]

    @torch.inference_mode()
    def _calibrated_probs(self, calibrator, logits, image_features_test,
                          text_features_test, test_img_proximity):
        """Calibrated probabilities for the eval loop's outputs.

        DAC-only configuration (the paper's headline): the fused scoring
        on the device (ops/scoring.py) from the returned unit-norm
        features. Any composed base calibrator, or logits that are not
        plain cosine scores, take the numpy calibrator instead. The two
        agree exactly in fp32; in bf16 the fused path recomputes logits
        from bf16-rounded features (tests/test_golden_e2e.py's parity
        holds at MODEL.PRECISION fp32).
        """
        if calibrator.dac_calibrator is not None and \
                calibrator.base_calibrator is None:
            fused_scale = self.fused_dac_logit_scale()
            if fused_scale is not None:
                from ..ops.scoring import fused_dac_scores

                def dev(a):
                    return torch.as_tensor(np.asarray(a, np.float32),
                                           device=self.device)
                probs, _ = fused_dac_scores(
                    dev(image_features_test), dev(text_features_test),
                    fused_scale,
                    dev(calibrator.dac_calibrator.class_confidence),
                    normalized=True)
                return probs.cpu().numpy().astype(np.float64)
        return calibrator.predict(logits, test_img_proximity)

    # -- base-class val feature cache (reference base_learner.py:176-239) ---
    def save_base_val_features(self):
        save_dir = osp.join(
            self._base_feature_dir(self.cfg.DATASET.SUBSAMPLE_CLASSES),
            "base_features.pt")
        if osp.exists(save_dir):
            print(f"File {save_dir} already exists. "
                  "Skipping save operation.")
            return
        print("Saving base features from val dataset")
        logits, labels, img_f, txt_f = self._run_inference(self.val_loader)
        knn = get_val_image_knn_dists(img_f,
                                      self.cfg.CALIBRATION.PROCAL.IMAGE_K,
                                      device=self.device)
        _save_feature_dict(save_dir, {
            "val_logits": logits,
            "val_image_features": img_f,
            "val_text_features": txt_f,
            "val_labels": labels,
            "val_image_knn_dists": knn,
        })

    # -- 4-way text features (reference base_learner.py:242-293) -----------
    def get_text_features(self, current_text_features_tuned=None,
                          val_dict=None):
        cfg = self.cfg
        if val_dict is None:
            val_dict = _load_feature_dict(
                osp.join(self._base_feature_dir("base"),
                         "base_features.pt"))

        # 1. base text features from the cached ZeroshotCLIP base run
        # (hardcoded seed 1, reference base_learner.py:253-255)
        zs_dir = osp.join(TEMP_ROOT, "base_features", cfg.DATASET.NAME,
                          "ZeroshotCLIP",
                          "shots" + str(cfg.DATASET.NUM_SHOTS),
                          cfg.MODEL.BACKBONE.NAME, "base", "seed1",
                          "base_features.pt")
        base_text_features_zs = _load_feature_dict(zs_dir)[
            "val_text_features"]

        # 2. current classes through frozen zero-shot CLIP
        current_text_features_zs = encode_classnames_zs(
            cfg.MODEL.BACKBONE.NAME, cfg.DATASET.NAME,
            self.dm.dataset.classnames, precision=cfg.MODEL.PRECISION,
            device=self.device)

        # 3. base text features from this trainer's own base run
        base_text_features_tuned = val_dict["val_text_features"]

        # 4. current classes through the tuned model (one inference)
        if current_text_features_tuned is None:
            batch = next(iter(self.test_loader))
            images, _ = self.parse_batch_test(batch)
            with torch.inference_mode():
                _, _, txt_f = self.model_inference(self.put_batch(images))
            current_text_features_tuned = _host(txt_f)

        return {
            "base_text_features_zs": np.asarray(base_text_features_zs),
            "current_text_features_zs": current_text_features_zs,
            "base_text_features_tuned":
                np.asarray(base_text_features_tuned),
            "current_text_features_tuned":
                np.asarray(current_text_features_tuned),
        }

    def parse_batch_train(self, batch):
        return batch["img"], batch["label"]
