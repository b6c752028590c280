"""CLIP-Adapter: residual feature adapter on the image branch.

Parity target: reference ``trainers/classification/clip_adapter.py``,
through ``clip_calibration_tpu/trainers/clip_adapter.py``. Prompts are
FIXED ("a photo of a" + class name), so the text features are constant
and encoded once at build. The only trainable module is a bias-free
2-layer bottleneck MLP (D -> D/4 -> D, ReLU after both layers) on the
image features, blended residually with ratio 0.2 (reference
``clip_adapter.py:138-172``). Both towers stay frozen: the image tower
runs without autograd, and may run int8
(``TRAINER.QUANT_FROZEN_VISION``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner, encode_prompt_sets


def adapter_forward(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"].to(x.dtype))
    return torch.relu(h @ params["w2"].to(x.dtype))


@TRAINER_REGISTRY.register()
class CLIP_Adapter(VLBaseLearner):
    fused_dac_scoring = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.COOP.PREC in ("fp16", "fp32", "amp")

    @property
    def compute_dtype(self):
        # the reference's check_cfg reads TRAINER.COOP.PREC (its own
        # quirk): the same knob here
        return (torch.float32 if self.cfg.TRAINER.COOP.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if cfg.TRAINER.COOP.PREC == "fp32" else "bfloat16",
            self.device)
        self.ratio = cfg.TRAINER.CLIP_ADAPTER.RATIO

        # fixed prompts -> constant text features, in the compute dtype
        ctx_init = cfg.TRAINER.CLIP_ADAPTER.CTX_INIT.replace("_", " ")
        self.text_features = encode_prompt_sets(
            self.clip_model, self.clip_cfg,
            [[ctx_init + " " + name.replace("_", " ") + "."
              for name in classnames]], self.compute_dtype)

        dim = self.clip_cfg.embed_dim
        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))

        def uniform(shape, fan_in):
            # torch nn.Linear's default init, U(+-1/sqrt(fan_in)); the
            # reference Adapter's Linears have no bias
            lim = (1.0 / fan_in) ** 0.5
            return (torch.rand(shape, generator=gen, device=self.device)
                    * 2 - 1) * lim

        self.register_trainable("adapter", {
            "w1": uniform((dim, dim // 4), dim),
            "w2": uniform((dim // 4, dim), dim // 4)})
        self.setup_frozen_vision()

    def _features(self, images):
        """(normalized adapted image features, normalized text features);
        the adapter is the only thing autograd sees."""
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        with torch.no_grad():
            img_f = M.encode_image(self.step_clip_params, self.clip_cfg, x,
                                   dtype=dtype,
                                   qmode=self.vision_qmode_for(x.shape[0]))
        ax = adapter_forward(self.model_params("adapter"), img_f)
        img_f = self.ratio * ax + (1 - self.ratio) * img_f
        return M.normalize(img_f), M.normalize(self.text_features)

    def _logits(self, images):
        img_n, txt_n = self._features(images)
        scale = torch.exp(self.clip_model.logit_scale.float())
        return scale * (img_n.float() @ txt_n.float().T), img_n, txt_n

    def _loss(self, images, labels):
        return F.cross_entropy(self._logits(images)[0], labels.long())

    def forward_backward(self, batch):
        return self.loss_step("adapter", batch)

    def model_inference(self, images):
        return self._logits(images)

    def convert_to_reference_state(self, name, state):
        """Ours -> reference fc.{0,2}.weight ([out, in])."""
        return {"fc": {"0": {"weight": torch.as_tensor(state["w1"]).T},
                       "2": {"weight": torch.as_tensor(state["w2"]).T}}}

    def convert_reference_state(self, name, state):
        """Reference Adapter checkpoints hold fc.0.weight / fc.2.weight
        (torch [out, in] bias-free Linears)."""
        fc = state.get("fc")
        if isinstance(fc, dict):
            return {"w1": torch.as_tensor(fc["0"]["weight"]).T,
                    "w2": torch.as_tensor(fc["2"]["weight"]).T}
        return state
