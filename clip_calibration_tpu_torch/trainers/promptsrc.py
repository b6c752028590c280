"""PromptSRC: prompting with self-regulating constraints.

Parity target: reference ``trainers/classification/promptsrc.py``,
through ``clip_calibration_tpu/trainers/promptsrc.py``. IVLP deep
prompting on BOTH towers (independent per-layer prompts: text depth and
ctx, vision depth and ctx); a frozen-CLIP teacher supplies per-class mean
text features over the 80 IMAGENET_TEMPLATES (encoded once in fp32, one
template a batch) and frozen image features. Loss (reference
``promptsrc.py:298-314``):

  CE + 25 * L1(txt_norm, zs_txt_norm) + 10 * L1(img_norm, zs_img_norm)
     + KLdiv(log_softmax(logits), log_softmax(zs_logits), log_target,
             sum) / logits.numel()

Gaussian Prompt Aggregation (GPA, reference ``promptsrc.py:264-336``):
after each epoch the prompts are added, weighted by a Gaussian over the
epochs 1..N (mean GPA_MEAN, std GPA_STD), into a running sum that
replaces them after the last epoch, in place, before the checkpoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner, encode_prompt_sets
from .coop import assemble_prompts, build_prompt_assembly
from .templates import IMAGENET_TEMPLATES
from .vpt import deep_stack, reference_tower


def gpa_schedule(n_epochs: int, mean: float, std: float) -> np.ndarray:
    """Normalized per-epoch Gaussian aggregation weights over epochs 1..N
    (reference ``promptsrc.py:268-274``)."""
    gauss = np.array([math.exp(-((e - mean) ** 2) / (2 * std ** 2))
                      / (std * math.sqrt(2 * math.pi))
                      for e in range(1, n_epochs + 1)])
    return gauss / gauss.sum()


@TRAINER_REGISTRY.register()
class PromptSRC(VLBaseLearner):
    vision_tower_trainable = True
    fused_dac_scoring = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.PROMPTSRC.PREC in ("fp16", "fp32", "amp")
        assert cfg.TRAINER.PROMPTSRC.PROMPT_DEPTH_TEXT >= 1

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.TRAINER.PROMPTSRC.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.PROMPTSRC
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if tcfg.PREC == "fp32" else "bfloat16", self.device)
        self.depth_text = tcfg.PROMPT_DEPTH_TEXT
        self.depth_vis = tcfg.PROMPT_DEPTH_VISION
        n_ctx_t = tcfg.N_CTX_TEXT
        n_ctx_v = tcfg.N_CTX_VISION
        ctx_dim = self.clip_cfg.transformer_width
        vis_dim = self.clip_cfg.vision_width

        ctx_init = tcfg.CTX_INIT if (tcfg.CTX_INIT and n_ctx_t <= 4) \
            else ""
        self.asm = build_prompt_assembly(
            classnames, n_ctx_t, "end", ctx_init, self.clip_model,
            self.compute_dtype, ctx_slots=n_ctx_t)
        print("Independent V-L design")
        print(f'Initial text context: "{self.asm["prompt_prefix"]}"')
        print(f"Number of context words (tokens) for Language prompting: "
              f"{n_ctx_t}")
        print(f"Number of context words (tokens) for Vision prompting: "
              f"{n_ctx_v}")

        # the frozen teacher: per-class mean text features over the
        # template ensemble, fp32 whatever PREC says (the reference's
        # `.float()` copy, promptsrc.py:115-129)
        self.fixed_embeddings = encode_prompt_sets(
            self.clip_model, self.clip_cfg,
            [[t.replace("{}", n.replace("_", " ")) for n in classnames]
             for t in IMAGENET_TEMPLATES], torch.float32)

        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))

        def normal(*shape):
            return torch.randn(shape, generator=gen,
                               device=self.device) * 0.02

        if self.asm["ctx_vectors"] is not None:
            ctx = torch.as_tensor(self.asm["ctx_vectors"][:n_ctx_t],
                                  dtype=torch.float32, device=self.device)
        else:
            ctx = normal(n_ctx_t, ctx_dim)
        prompts = {"ctx": ctx, "vpt_shallow": normal(n_ctx_v, vis_dim)}
        if self.depth_text > 1:
            prompts["deep_text"] = normal(self.depth_text - 1, n_ctx_t,
                                          ctx_dim)
        if self.depth_vis > 1:
            prompts["deep_vis"] = normal(self.depth_vis - 1, n_ctx_v,
                                         vis_dim)
        self.register_trainable("prompt_learner", prompts)
        self.gauss = gpa_schedule(cfg.OPTIM.MAX_EPOCH, tcfg.GPA_MEAN,
                                  tcfg.GPA_STD)
        self._gpa_accum = None
        self.setup_frozen_vision()  # raises: the tower trains

    # -- forward ----------------------------------------------------------
    def _images(self, images):
        return normalize_images(self.put_batch(images), *self.pixel_stats,
                                dtype=self.compute_dtype)

    def _features(self, x):
        """(image, text) features of the prompted towers on the
        normalized batch ``x``."""
        p = self.model_params("prompt_learner")
        txt_f = M.encode_text_embedded(
            self.clip_model, self.clip_cfg,
            assemble_prompts(p["ctx"], self.asm), self.asm["eot_pos"],
            seq_len=self.asm["seq_len"], deep_prompts=p.get("deep_text"),
            deep_prompt_depth=self.depth_text)
        img_f = M.encode_image(
            self.clip_model, self.clip_cfg, x, dtype=self.compute_dtype,
            shallow_prompts=p["vpt_shallow"], deep_prompts=p.get("deep_vis"),
            deep_prompt_depth=self.depth_vis)
        return img_f, txt_f

    def _loss(self, images, labels):
        tcfg = self.cfg.TRAINER.PROMPTSRC
        x = self._images(images)
        img_f, txt_f = self._features(x)
        img_n = M.normalize(img_f).float()
        # one text value feeds the logits and the text-to-text term; the
        # latter's gradient, equal on every data rank, passes the data
        # average unchanged
        txt_n = self.replicated_text(M.normalize(txt_f).float())
        scale = torch.exp(self.clip_model.logit_scale.float())
        logits = scale * (img_n @ txt_n.T)
        ce = F.cross_entropy(logits, labels.long())

        # the frozen teacher: no gradient reaches it
        fixed_n = M.normalize(self.fixed_embeddings)
        with torch.no_grad():
            zs_img = M.normalize(M.encode_image(
                self.clip_model, self.clip_cfg, x,
                dtype=self.compute_dtype)).float()
        zs_logits = scale * (zs_img @ fixed_n.T)

        loss_text = (txt_n - fixed_n).abs().mean() * tcfg.TEXT_LOSS_WEIGHT
        loss_image = (img_n - zs_img).abs().mean() * tcfg.IMAGE_LOSS_WEIGHT
        log_p = F.log_softmax(logits, dim=1)
        log_q = F.log_softmax(zs_logits, dim=1)
        l_kl = (log_q.exp() * (log_q - log_p)).sum() / logits.numel()
        return ce + loss_text + loss_image + l_kl

    def forward_backward(self, batch):
        return self.loss_step("prompt_learner", batch)

    @torch.no_grad()
    def after_epoch(self):
        # Gaussian prompt aggregation across epochs
        w = float(self.gauss[self.epoch])
        params = self.model_params("prompt_learner")
        if self._gpa_accum is None:
            self._gpa_accum = {k: v * w for k, v in params.items()}
        else:
            for k, v in params.items():
                self._gpa_accum[k] += v * w
        if (self.epoch + 1) == self.max_epoch:
            print("Using GPA model for final inference...")
            # in place: the optimizer and the checkpoint keep the tensors
            for k, v in params.items():
                v.copy_(self._gpa_accum[k])
        super().after_epoch()

    def model_inference(self, images):
        img_f, txt_f = self._features(self._images(images))
        img_n, txt_n = M.normalize(img_f), M.normalize(txt_f)
        scale = torch.exp(self.clip_model.logit_scale.float())
        return scale * (img_n.float() @ txt_n.float().T), img_n, txt_n

    def convert_to_reference_state(self, name, state):
        """Ours -> the reference's whole-model prompt keys
        (prompt_learner.ctx, image_encoder.VPT, per-layer VPT_shallow
        rows in both towers)."""
        return {"prompt_learner": {"ctx": torch.as_tensor(state["ctx"])},
                "image_encoder": {
                    "VPT": torch.as_tensor(state["vpt_shallow"]),
                    **reference_tower(state.get("deep_vis"))},
                "text_encoder": reference_tower(state.get("deep_text"))}

    def convert_reference_state(self, name, state):
        """Reference PromptSRC checkpoints are whole-model state dicts:
        prompt_learner.ctx, image_encoder.VPT, and per-layer
        {image,text}_encoder.transformer.resblocks.N.VPT_shallow."""
        if "image_encoder" not in state:
            return state
        pl = state["prompt_learner"]
        out = {"ctx": torch.as_tensor(pl["ctx"]),
               "vpt_shallow": torch.as_tensor(state["image_encoder"]["VPT"])}
        for key, tower, depth in (
                ("deep_vis", "image_encoder", self.depth_vis),
                ("deep_text", "text_encoder", self.depth_text)):
            deep = deep_stack(state[tower], depth)
            if deep is not None:
                out[key] = deep
        if "token_prefix" in pl:
            out["token_prefix"] = pl["token_prefix"]
            out["token_suffix"] = pl["token_suffix"]
        return out
