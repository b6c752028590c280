"""MaPLe: multi-modal prompt learning.

Parity target: reference ``trainers/classification/maple.py``, through
``clip_calibration_tpu/trainers/maple.py``. One text context (N_CTX
slots) is shared across the towers: a learnable 512->768 projection of it
is the shallow vision prompt, and the per-layer compound text prompts
(layers 1..depth-1) each have their own 512->768 projection giving that
layer's vision prompt (reference ``maple.py:108-188``). The reference
deep-copies one Linear for all the per-layer projections, so they start
equal: one initialization tiled here.

The deep vision prompts are functions of the deep text prompts, so the
text prompts' gradient comes through both towers (K2 in every layer of
each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner
from .coop import assemble_prompts, build_prompt_assembly


@TRAINER_REGISTRY.register()
class MaPLe(VLBaseLearner):
    vision_tower_trainable = True
    fused_dac_scoring = True

    def check_cfg(self, cfg):
        assert cfg.TRAINER.MAPLE.PREC in ("fp16", "fp32", "amp")
        assert cfg.TRAINER.MAPLE.PROMPT_DEPTH >= 1, \
            "For MaPLe, PROMPT_DEPTH should be >= 1"

    @property
    def compute_dtype(self):
        return (torch.float32 if self.cfg.TRAINER.MAPLE.PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.MAPLE
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if tcfg.PREC == "fp32" else "bfloat16", self.device)
        self.depth = tcfg.PROMPT_DEPTH
        n_ctx = tcfg.N_CTX
        ctx_dim = self.clip_cfg.transformer_width
        vis_dim = self.clip_cfg.vision_width

        ctx_init = tcfg.CTX_INIT if (tcfg.CTX_INIT and n_ctx <= 4) else ""
        # N_CTX learnable slots; the rest of the init phrase stays frozen
        self.asm = build_prompt_assembly(
            classnames, n_ctx, "end", ctx_init, self.clip_model,
            self.compute_dtype, ctx_slots=n_ctx)
        print("MaPLe design: Multi-modal Prompt Learning")
        print(f'Initial context: "{self.asm["prompt_prefix"]}"')
        print(f"Number of MaPLe context words (tokens): {n_ctx}")

        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))
        lim = (1.0 / ctx_dim) ** 0.5

        def uniform(*shape):
            # torch nn.Linear's default init: weights and biases from
            # U(+-1/sqrt(fan_in))
            return (torch.rand(shape, generator=gen, device=self.device)
                    * 2 - 1) * lim

        if self.asm["ctx_vectors"] is not None:
            ctx = torch.as_tensor(self.asm["ctx_vectors"][:n_ctx],
                                  dtype=torch.float32, device=self.device)
        else:
            ctx = torch.randn((n_ctx, ctx_dim), generator=gen,
                              device=self.device) * 0.02
        prompts = {"ctx": ctx, "proj_w": uniform(ctx_dim, vis_dim),
                   "proj_b": uniform(vis_dim)}
        if self.depth > 1:
            prompts["compound_text"] = torch.randn(
                (self.depth - 1, n_ctx, ctx_dim), generator=gen,
                device=self.device) * 0.02
            # one init tiled across the layers (reference _get_clones)
            prompts["compound_proj_w"] = uniform(ctx_dim, vis_dim).expand(
                self.depth - 1, ctx_dim, vis_dim).clone()
            prompts["compound_proj_b"] = uniform(vis_dim).expand(
                self.depth - 1, vis_dim).clone()
        self.register_trainable("prompt_learner", prompts)
        self.setup_frozen_vision()  # raises: the tower trains

    # -- forward ----------------------------------------------------------
    def _prompt_pack(self):
        """(ctx, shallow vision prompt, deep text prompts, deep vision
        prompts), the vision ones projected from the text ones."""
        p = self.model_params("prompt_learner")
        shallow_vis = p["ctx"] @ p["proj_w"] + p["proj_b"]
        deep_text = p.get("compound_text")
        deep_vis = None
        if deep_text is not None:
            deep_vis = (torch.bmm(deep_text, p["compound_proj_w"])
                        + p["compound_proj_b"][:, None, :])
        return p["ctx"], shallow_vis, deep_text, deep_vis

    def _features(self, images):
        ctx, shallow_vis, deep_text, deep_vis = self._prompt_pack()
        depth = self.depth if deep_text is not None else 0
        txt_f = M.encode_text_embedded(
            self.clip_model, self.clip_cfg, assemble_prompts(ctx, self.asm),
            self.asm["eot_pos"], seq_len=self.asm["seq_len"],
            deep_prompts=deep_text, deep_prompt_depth=depth)
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=self.compute_dtype)
        img_f = M.encode_image(
            self.clip_model, self.clip_cfg, x, dtype=self.compute_dtype,
            shallow_prompts=shallow_vis, deep_prompts=deep_vis,
            deep_prompt_depth=depth)
        return img_f, txt_f

    def _loss(self, images, labels):
        img_f, txt_f = self._features(images)
        # the text side's gradient is summed over the data ranks at the
        # product; the vision side's stays this rank's (its prompts are
        # averaged with the other trainables' gradients)
        logits = M.cosine_logits(img_f, txt_f, self.clip_model.logit_scale,
                                 text_hook=self.replicated_text)
        return F.cross_entropy(logits, labels.long())

    def forward_backward(self, batch):
        return self.loss_step("prompt_learner", batch)

    def model_inference(self, images):
        img_f, txt_f = self._features(images)
        img_n, txt_n = M.normalize(img_f), M.normalize(txt_f)
        scale = torch.exp(self.clip_model.logit_scale.float())
        return scale * (img_n.float() @ txt_n.float().T), img_n, txt_n

    def checkpoint_dir_aliases(self, name):
        # the reference registers the whole model as MultiModalPromptLearner
        return [name, "MultiModalPromptLearner"]

    def convert_to_reference_state(self, name, state):
        """Ours -> the reference's prompt_learner.{ctx, proj.*,
        compound_prompts_text.N, compound_prompt_projections.N.*}
        ([out, in] weights)."""
        t = torch.as_tensor
        out = {"ctx": t(state["ctx"]),
               "proj": {"weight": t(state["proj_w"]).T,
                        "bias": t(state["proj_b"])}}
        ct = state.get("compound_text")
        if ct is not None:
            out["compound_prompts_text"] = {
                str(i): t(ct[i]) for i in range(ct.shape[0])}
            out["compound_prompt_projections"] = {
                str(i): {"weight": t(state["compound_proj_w"][i]).T,
                         "bias": t(state["compound_proj_b"][i])}
                for i in range(ct.shape[0])}
        return {"prompt_learner": out}

    def convert_reference_state(self, name, state):
        """Reference MaPLe checkpoints are whole-model state dicts with
        prompt_learner.{ctx, proj.*, compound_prompts_text.N,
        compound_prompt_projections.N.*}."""
        pl = state.get("prompt_learner")
        if not isinstance(pl, dict) or "proj" not in pl:
            return state
        t = torch.as_tensor
        out = {"ctx": t(pl["ctx"]), "proj_w": t(pl["proj"]["weight"]).T,
               "proj_b": t(pl["proj"]["bias"])}
        cpt = pl.get("compound_prompts_text")
        if cpt:
            n = len(cpt)
            proj = pl["compound_prompt_projections"]
            out["compound_text"] = torch.stack(
                [t(cpt[str(i)]) for i in range(n)])
            out["compound_proj_w"] = torch.stack(
                [t(proj[str(i)]["weight"]).T for i in range(n)])
            out["compound_proj_b"] = torch.stack(
                [t(proj[str(i)]["bias"]) for i in range(n)])
        if "token_prefix" in pl:
            out["token_prefix"] = pl["token_prefix"]
            out["token_suffix"] = pl["token_suffix"]
        return out
