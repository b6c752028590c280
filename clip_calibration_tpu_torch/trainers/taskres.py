"""TaskRes: task residual tuning on the text classifier.

Parity target: reference ``trainers/classification/taskres.py``, through
``clip_calibration_tpu/trainers/taskres.py``. The classifier is
``t + alpha * x``: ``t`` the frozen template-averaged text features
(CUSTOM_TEMPLATES, plus IMAGENET_TEMPLATES_SELECT on ImageNet, reference
``taskres.py:109-135``), encoded once in fp32 as the reference's fp32
model does (``taskres.py:248``), and ``x`` a zero-initialized learnable
residual. Only ``x`` trains; both towers stay frozen, so the image
features are the only per-batch work (and may run int8,
``TRAINER.QUANT_FROZEN_VISION``).

The reference's "enhanced base" swaps in a pretrained text projection
(``taskres.py:137-171``): ``TRAINER.TaskRes.ENHANCED_BASE`` names an npz
with a ``text_projection`` array.
"""

from __future__ import annotations

import copy
import json
import os.path as osp
import types

import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..models.weights import load_params, to_tensor
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner, encode_prompt_sets
from .templates import CUSTOM_TEMPLATES, IMAGENET_TEMPLATES_SELECT

#: the ImageNet-A/R class indices within ImageNet's 1000 (reference
#: ``imagenet_a_r_indexes_v2.py``)
IMAGENET_A_R_INDEXES = osp.join(osp.dirname(osp.dirname(
    osp.abspath(__file__))), "assets", "imagenet_a_r_indexes.json")


@TRAINER_REGISTRY.register()
class TaskRes(VLBaseLearner):
    fused_dac_scoring = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.TaskRes.PREC in ("fp16", "fp32", "amp")

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.TRAINER.TaskRes.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if cfg.TRAINER.TaskRes.PREC == "fp32" else "bfloat16",
            self.device)
        self.alpha = cfg.TRAINER.TaskRes.RESIDUAL_SCALE
        print(">> DCT scale factor: ", self.alpha)

        model = self.clip_model
        if cfg.TRAINER.TaskRes.ENHANCED_BASE != "none":
            print(">> Use enhanced base!")
            # a text tower of its own with the loaded projection, kept in
            # the file's precision as the JAX package keeps it
            text = copy.deepcopy(model.text)
            text.text_projection = torch.nn.Parameter(
                to_tensor(load_params(cfg.TRAINER.TaskRes.ENHANCED_BASE)
                          ["text_projection"]).to(self.device),
                requires_grad=False)
            model = types.SimpleNamespace(text=text,
                                          logit_scale=model.logit_scale)
        else:
            print(">> Use regular base!")

        templates = ([*IMAGENET_TEMPLATES_SELECT]
                     if cfg.DATASET.NAME == "ImageNet" else [])
        templates += [CUSTOM_TEMPLATES[cfg.DATASET.NAME]]
        self.base_text_features = encode_prompt_sets(
            model, self.clip_cfg,
            [[t.format(name) for name in classnames] for t in templates],
            torch.float32)
        self.register_trainable("taskres_learner", {
            "residual": torch.zeros_like(self.base_text_features)})
        self.setup_frozen_vision()

    def _classifier(self):
        return (self.base_text_features + self.alpha
                * self.model_params("taskres_learner")["residual"])

    def _image_features(self, images):
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        with torch.no_grad():
            return M.encode_image(self.step_clip_params, self.clip_cfg, x,
                                  dtype=dtype,
                                  qmode=self.vision_qmode_for(x.shape[0]))

    def _loss(self, images, labels):
        logits = M.cosine_logits(self._image_features(images),
                                 self._classifier(),
                                 self.clip_model.logit_scale)
        return F.cross_entropy(logits, labels.long())

    def forward_backward(self, batch):
        return self.loss_step("taskres_learner", batch)

    def model_inference(self, images):
        txt_n = M.normalize(self._classifier())
        img_n = M.normalize(self._image_features(images))
        scale = torch.exp(self.clip_model.logit_scale.float())
        return scale * (img_n.float() @ txt_n.float().T), img_n, txt_n

    def checkpoint_dir_aliases(self, name):
        # the reference registers TaskResLearner under "prompt_learner"
        return [name, "prompt_learner"]

    def convert_to_reference_state(self, name, state):
        """Ours -> the reference's text_feature_residuals (its
        base_text_features may be missing: its strict=False load)."""
        return {"text_feature_residuals": torch.as_tensor(
            state["residual"])}

    def convert_reference_state(self, name, state):
        """Reference TaskRes checkpoints hold base_text_features and
        text_feature_residuals; only the residual is ours to load."""
        if "text_feature_residuals" in state:
            return {"residual": torch.as_tensor(
                state["text_feature_residuals"])}
        return state

    def _set_params(self, name, loaded):
        """On ImageNet-A/R cross-dataset eval, the 1000-class residual of
        an ImageNet-trained checkpoint is cut down to the 200 classes
        present (reference ``taskres.py:318-327``)."""
        ds = self.cfg.DATASET.NAME
        res = loaded.get("residual")
        if ds in ("ImageNetA", "ImageNetR") and res is not None \
                and res.shape[0] == 1000:
            with open(IMAGENET_A_R_INDEXES) as f:
                idx = json.load(f)[
                    "imagenet_a" if ds == "ImageNetA" else "imagenet_r"]
            loaded = dict(loaded, residual=torch.as_tensor(res)[
                torch.as_tensor(idx)])
        super()._set_params(name, loaded)
