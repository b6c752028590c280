"""Zero-shot CLIP trainer (no training).

Parity target: reference ``trainers/classification/zsclip.py:74-102``.
Class text features are encoded once at build time from the per-dataset
hand-crafted template; each batch is normalize -> encode -> cosine logits.
"""

from __future__ import annotations

import os

import torch

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..models.tokenizer import tokenize
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner
from .templates import CUSTOM_TEMPLATES


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(VLBaseLearner):
    fused_dac_scoring = True

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        classnames = self.dm.dataset.classnames

        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if cfg.MODEL.PRECISION == "fp32" else "bfloat16",
            self.device)

        temp = CUSTOM_TEMPLATES[cfg.DATASET.NAME]
        prompts = [temp.format(c.replace("_", " ")) for c in classnames]
        print(f"Prompts: {prompts}")
        toks = tokenize(prompts)
        self.text_features = M.normalize(M.encode_text(
            self.clip_model, self.clip_cfg,
            torch.as_tensor(toks, dtype=torch.long, device=self.device),
            dtype=self.compute_dtype, seq_len=M.eot_seq_len(toks)))
        self.setup_frozen_vision()

    def model_inference(self, images):
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        img_f = M.normalize(M.encode_image(
            self.step_clip_params, self.clip_cfg, x, dtype=dtype,
            qmode=self.vision_qmode_for(x.shape[0])))
        txt_f = self.text_features
        scale = torch.exp(self.clip_model.logit_scale.float())
        logits = scale * (img_f.float() @ txt_f.float().T)
        return logits, img_f, txt_f

    def train(self):
        """Zero-shot: nothing to train; run the test pipeline."""
        os.makedirs(self.output_dir, exist_ok=True)
        self.test()
