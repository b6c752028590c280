"""VPT: vision-only deep prompt tuning.

Parity target: reference ``trainers/classification/vpt.py``, through
``clip_calibration_tpu/trainers/vpt.py``. The text side is FIXED ("a
photo of a {}" features, encoded once in fp32 as the reference's fp32
model does, ``vpt.py:42,68-90``); the trainables are the shallow vision
prompt appended after the positional embedding and one stacked
[depth-1, n_ctx, width] prompt array for layers 1..depth-1 (the
reference's per-block ``VPT_shallow``, ``clip/model.py:191-256``).

The vision tower runs with autograd (its parameters stay frozen, so only
activation gradients flow): the fused attention's backward, kernel K2,
runs in every vision layer of a train step, at the vision length plus
the prompt tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner, encode_prompt_sets


def deep_stack(tower, depth: int):
    """Per-layer ``VPT_shallow`` rows 1..depth-1 of a reference tower's
    state (``transformer.resblocks.N``), stacked; None when there are
    none. Rows the checkpoint lacks are skipped, as the reference's
    strict=False load would."""
    blocks = tower["transformer"]["resblocks"]
    rows = [torch.as_tensor(blocks[str(i)]["VPT_shallow"])
            for i in range(1, depth)
            if str(i) in blocks and "VPT_shallow" in blocks[str(i)]]
    return torch.stack(rows) if rows else None


def reference_tower(deep) -> dict:
    """Inverse of ``deep_stack``: rows -> ``transformer.resblocks.N``."""
    blocks = {}
    if deep is not None:
        blocks = {str(i + 1): {"VPT_shallow": torch.as_tensor(deep[i])}
                  for i in range(deep.shape[0])}
    return {"transformer": {"resblocks": blocks}}


@TRAINER_REGISTRY.register()
class VPT(VLBaseLearner):
    vision_tower_trainable = True
    fused_dac_scoring = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.VPT.PREC in ("fp16", "fp32", "amp")
        assert cfg.TRAINER.VPT.PROMPT_DEPTH_VISION >= 1, \
            "For Vision Prompting, PROMPT_DEPTH_VISION should be >= 1"

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.TRAINER.VPT.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.VPT
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if tcfg.PREC == "fp32" else "bfloat16", self.device)
        self.n_ctx = tcfg.N_CTX_VISION
        self.depth = tcfg.PROMPT_DEPTH_VISION

        print("Vision Prompting Design")
        print('Initial context: "a photo of a"')
        print(f"Number of context words (tokens) for Vision prompting: "
              f"{self.n_ctx}")
        print("Using fixed hand crated prompts")
        # the reference VPT model is fp32 whatever PREC says; the fixed
        # text features are a one-time cost, so they match it (on a bf16
        # tower this runs the fp32 attention kernel)
        self.text_features = encode_prompt_sets(
            self.clip_model, self.clip_cfg,
            [["a photo of a " + n.replace("_", " ") + "."
              for n in classnames]], torch.float32)

        vw = self.clip_cfg.vision_width
        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))

        def normal(*shape):
            return torch.randn(shape, generator=gen,
                               device=self.device) * 0.02

        prompts = {"shallow": normal(self.n_ctx, vw)}
        if self.depth > 1:
            prompts["deep"] = normal(self.depth - 1, self.n_ctx, vw)
        self.register_trainable("vpt_prompts", prompts)
        self.setup_frozen_vision()  # raises: the tower trains

    def _image_features(self, images):
        p = self.model_params("vpt_prompts")
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        deep = p.get("deep")
        return M.encode_image(
            self.clip_model, self.clip_cfg, x, dtype=dtype,
            shallow_prompts=p["shallow"], deep_prompts=deep,
            deep_prompt_depth=self.depth if deep is not None else 0)

    def _loss(self, images, labels):
        logits = M.cosine_logits(self._image_features(images),
                                 self.text_features,
                                 self.clip_model.logit_scale)
        return F.cross_entropy(logits, labels.long())

    def forward_backward(self, batch):
        return self.loss_step("vpt_prompts", batch)

    def model_inference(self, images):
        img_n = M.normalize(self._image_features(images))
        txt_n = M.normalize(self.text_features)
        scale = torch.exp(self.clip_model.logit_scale.float())
        return scale * (img_n.float() @ txt_n.float().T), img_n, txt_n

    def checkpoint_dir_aliases(self, name):
        # the reference registers the whole model under "prompt_learner"
        return [name, "prompt_learner"]

    def convert_to_reference_state(self, name, state):
        """Ours -> the reference's image_encoder.VPT and
        image_encoder.transformer.resblocks.N.VPT_shallow."""
        return {"image_encoder": {
            "VPT": torch.as_tensor(state["shallow"]),
            **reference_tower(state.get("deep"))}}

    def convert_reference_state(self, name, state):
        """Reference VPT checkpoints are whole-model state dicts with
        image_encoder.VPT and per-layer resblocks.N.VPT_shallow."""
        enc = state.get("image_encoder")
        if not isinstance(enc, dict):
            return state
        out = {"shallow": torch.as_tensor(enc["VPT"])}
        if self.depth > 1:
            deep = deep_stack(enc, self.depth)
            if deep is not None:
                out["deep"] = deep
        return out
