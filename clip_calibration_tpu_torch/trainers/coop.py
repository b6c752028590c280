"""CoOp: Context Optimization prompt tuning.

Parity target: reference ``trainers/classification/coop.py``.
Learnable context vectors (unified or class-specific ``CSC``) are spliced
into pre-embedded class prompts at position end/middle/front; only the
context trains, the CLIP backbone stays frozen. Prompt assembly is one
gather + select over index maps built once on the host from the tokenized
prompts.

A train step (``forward_backward``) is the JAX step's dataflow: the text
tower runs with autograd (the fused attention's backward, kernel K2, in
every layer), the vision tower forward only under ``torch.no_grad()``
(nothing in it trains, as ``jax.value_and_grad`` over the ctx prunes it),
mean cross-entropy of the cosine logits, then the optimizer step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.optim import build_lr_schedule, build_optimizer
from ..engine.registry import TRAINER_REGISTRY
from ..models import clip as M
from ..models.backbone import load_clip_backbone
from ..models.tokenizer import CLIPTokenizer, tokenize
from ..ops.preprocess import normalize_images
from .base_learner import VLBaseLearner

_tokenizer = CLIPTokenizer()


def build_prompt_assembly(classnames, n_ctx: int, class_token_position:
                          str, ctx_init: str, clip_model, compute_dtype,
                          ctx_slots: int | None = None,
                          ctx_init_tail: bool = False):
    """Precompute everything needed to splice [SOS | ctx | class EOS] rows.

    ctx_slots: number of LEARNABLE positions when it differs from the init
    phrase length (MaPLe: N_CTX=2 with CTX_INIT="a photo of a" trains 2
    vectors while "of a" stay frozen in the prompt — reference
    ``maple.py:93-101``). Only meaningful with ctx_init and position "end".

    ctx_init_tail: ProGrad's scheme (reference ``prograd.py:88-105``):
    all n_ctx positions learnable, zero-initialized, with the init
    phrase's token embeddings in the LAST len(phrase) slots and leading
    "X" placeholders in the prompt text.

    Returns dict with (tensors on the model's device):
      embedding: [n_cls, 77, D] frozen token embeddings in compute dtype
        (ctx positions hold the placeholder embedding),
      tokenized: [n_cls, 77] (for EOT argmax pooling), eot_pos, seq_len,
      ctx_idx / const_mask: [n_cls, 77] gather maps — final row p is
        ctx[ctx_idx[c, p]] where const_mask is False, else embedding[c, p],
      ctx_vectors: init value [n_ctx, D] numpy (None without ctx_init),
      n_ctx, prompt_prefix, name_lens.
    """
    emb_table = clip_model.text.token_embedding.detach().float().cpu()\
        .numpy()
    if ctx_init and ctx_init_tail:
        ctx_init = ctx_init.replace("_", " ")
        n_words = len(ctx_init.split(" "))
        assert n_ctx >= n_words, (
            f"#tokens ({n_ctx}) should larger equal than #initial "
            f"prompt tokens ({n_words}, {ctx_init})")
        init_toks = tokenize(ctx_init)
        ctx_vectors = np.zeros((n_ctx, emb_table.shape[1]), np.float32)
        ctx_vectors[n_ctx - n_words:] = emb_table[init_toks[0, 1:1 + n_words]]
        prompt_prefix = " ".join(
            ["X"] * (n_ctx - n_words) + [ctx_init]).strip()
    elif ctx_init:
        ctx_init = ctx_init.replace("_", " ")
        n_words = len(ctx_init.split(" "))
        n_ctx = n_words if ctx_slots is None else min(ctx_slots, n_words)
        if ctx_slots is not None and n_ctx < n_words:
            assert class_token_position == "end", \
                "ctx_slots < init length only supported at position end"
        init_toks = tokenize(ctx_init)
        ctx_vectors = emb_table[init_toks[0, 1:1 + n_ctx]]
        prompt_prefix = ctx_init
    else:
        if ctx_slots is not None:
            n_ctx = ctx_slots
        ctx_vectors = None
        prompt_prefix = " ".join(["X"] * n_ctx)

    classnames = [name.replace("_", " ") for name in classnames]
    name_lens = [len(_tokenizer.encode(name)) for name in classnames]
    prompts = [prompt_prefix + " " + name + "." for name in classnames]
    tokenized = tokenize(prompts)  # [n_cls, 77]
    embedding = emb_table[tokenized]  # [n_cls, 77, D]

    n_cls, L = tokenized.shape
    ctx_idx = np.zeros((n_cls, L), np.int64)
    const_mask = np.ones((n_cls, L), bool)

    for c in range(n_cls):
        nl = name_lens[c]
        if class_token_position == "end":
            # [SOS][ctx x n_ctx][name][.][EOS]...
            order = ([("const", 0)] + [("ctx", j) for j in range(n_ctx)]
                     + [("const", p) for p in range(1 + n_ctx, L)])
        elif class_token_position == "middle":
            half = n_ctx // 2
            name_slice = [("const", p) for p in
                          range(1 + n_ctx, 1 + n_ctx + nl)]
            tail = [("const", p) for p in range(1 + n_ctx + nl, L)]
            order = ([("const", 0)] + [("ctx", j) for j in range(half)]
                     + name_slice + [("ctx", j) for j in range(half, n_ctx)]
                     + tail)
        elif class_token_position == "front":
            name_slice = [("const", p) for p in
                          range(1 + n_ctx, 1 + n_ctx + nl)]
            tail = [("const", p) for p in range(1 + n_ctx + nl, L)]
            order = ([("const", 0)] + name_slice
                     + [("ctx", j) for j in range(n_ctx)] + tail)
        else:
            raise ValueError(class_token_position)
        order = order[:L]
        for p, (kind, j) in enumerate(order):
            if kind == "ctx":
                ctx_idx[c, p] = j
                const_mask[c, p] = False
            elif j != p:
                # move the constant token's embedding to its new position
                # (reads are always from j >= p, not yet overwritten)
                embedding[c, p] = embedding[c, j]

    device = clip_model.logit_scale.device
    eot_pos = tokenized.argmax(-1)
    return {
        "embedding": torch.as_tensor(embedding, device=device)
        .to(compute_dtype),
        "tokenized": torch.as_tensor(tokenized, device=device),
        "eot_pos": torch.as_tensor(eot_pos, dtype=torch.long,
                                   device=device),
        # causal mask => positions past the furthest EOT never reach the
        # pooled feature (models/clip.py::eot_seq_len)
        "seq_len": int(eot_pos.max()) + 1,
        "ctx_idx": torch.as_tensor(ctx_idx, device=device),
        "const_mask": torch.as_tensor(const_mask, device=device),
        "ctx_vectors": ctx_vectors,
        "n_ctx": n_ctx,
        "prompt_prefix": prompt_prefix,
        "name_lens": name_lens,
    }


def assemble_prompts(ctx: torch.Tensor, asm) -> torch.Tensor:
    """ctx [n_ctx, D] or [n_cls, n_ctx, D] -> [n_cls, 77, D] prompt rows."""
    emb = asm["embedding"]
    ctx = ctx.to(emb.dtype)
    if ctx.ndim == 2:
        gathered = ctx[asm["ctx_idx"]]  # [n_cls, 77, D]
    else:  # class-specific context [n_cls, n_ctx, D]
        rows = torch.arange(emb.shape[0], device=emb.device)[:, None]
        gathered = ctx[rows, asm["ctx_idx"]]
    return torch.where(asm["const_mask"][:, :, None], emb, gathered)


@TRAINER_REGISTRY.register()
class CoOp(VLBaseLearner):
    """Context Optimization (https://arxiv.org/abs/2109.01134)."""

    fused_dac_scoring = True

    trainer_cfg_key = "COOP"

    def check_cfg(self, cfg):
        assert cfg.TRAINER[self.trainer_cfg_key].PREC in (
            "fp16", "fp32", "amp")

    def trainer_cfg(self):
        return self.cfg.TRAINER[self.trainer_cfg_key]

    @property
    def compute_dtype(self):
        return (torch.float32 if self.trainer_cfg().PREC == "fp32"
                else torch.bfloat16)

    @torch.no_grad()
    def build_model(self):
        cfg = self.cfg
        tcfg = self.trainer_cfg()
        classnames = self.dm.dataset.classnames

        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.clip_model, self.clip_cfg = load_clip_backbone(
            cfg.MODEL.BACKBONE.NAME,
            "float32" if tcfg.PREC == "fp32" else "bfloat16", self.device)

        if cfg.INPUT.SIZE[0] != self.clip_cfg.image_resolution:
            raise ValueError(
                f"cfg_imsize ({cfg.INPUT.SIZE[0]}) must equal clip_imsize "
                f"({self.clip_cfg.image_resolution})")

        ctx_init = self._resolve_ctx_init(tcfg)
        position = tcfg.get("CLASS_TOKEN_POSITION", "end")
        asm = build_prompt_assembly(classnames, tcfg.N_CTX, position,
                                    ctx_init, self.clip_model,
                                    self.compute_dtype)
        self.asm = asm
        n_ctx = asm["n_ctx"]
        ctx_dim = self.clip_cfg.transformer_width
        print(f'Initial context: "{asm["prompt_prefix"]}"')
        print(f"Number of context words (tokens): {n_ctx}")

        gen = torch.Generator(device=self.device).manual_seed(
            max(cfg.SEED, 0))
        if asm["ctx_vectors"] is not None:
            ctx = torch.as_tensor(asm["ctx_vectors"], dtype=torch.float32,
                                  device=self.device)
        else:
            shape = ((len(classnames), n_ctx, ctx_dim)
                     if tcfg.get("CSC", False) else (n_ctx, ctx_dim))
            print("Initializing class-specific contexts"
                  if len(shape) == 3 else "Initializing a generic context")
            ctx = torch.randn(shape, generator=gen, device=self.device) \
                * 0.02
        ctx.requires_grad_(True)
        self.register_model(
            "prompt_learner", {"ctx": ctx},
            lambda: build_optimizer(cfg, [ctx]),
            build_lr_schedule(cfg, len(self.train_loader_x)))
        self._cached_text_features = None
        self.setup_frozen_vision()

    def _resolve_ctx_init(self, tcfg) -> str:
        """KgCoOp configs use CTX_INIT: True meaning "a photo of a"
        (reference kgcoop.py:102-107)."""
        ctx_init = tcfg.CTX_INIT
        if ctx_init is True:
            return "a photo of a"
        if ctx_init is False:
            return ""
        return ctx_init

    def _text_features(self, ctx):
        """Class text features of ``ctx`` (unnormalized; differentiable
        in ctx outside no_grad)."""
        prompts = assemble_prompts(ctx, self.asm)
        return M.encode_text_embedded(self.clip_model, self.clip_cfg,
                                      prompts, self.asm["eot_pos"],
                                      seq_len=self.asm["seq_len"])

    def _image_features(self, images):
        """Frozen image features on ``step_clip_params`` (an int8 tower
        under ``TRAINER.QUANT_FROZEN_VISION``, run in the batch's
        qmode)."""
        dtype = self.compute_dtype
        x = normalize_images(self.put_batch(images), *self.pixel_stats,
                             dtype=dtype)
        return M.encode_image(self.step_clip_params, self.clip_cfg, x,
                              dtype=dtype,
                              qmode=self.vision_qmode_for(x.shape[0]))

    def text_features(self):
        """Normalized class text features of the current context, cached
        until the context changes."""
        if self._cached_text_features is None:
            with torch.no_grad():
                self._cached_text_features = M.normalize(
                    self._text_features(self.model_params(
                        "prompt_learner")["ctx"]))
        return self._cached_text_features

    # -- train ------------------------------------------------------------
    def _loss(self, images, labels):
        """Mean cross-entropy of the cosine logits (JAX ``CoOp._loss``)."""
        txt_f = self._text_features(self.model_params("prompt_learner")
                                    ["ctx"])
        with torch.no_grad():
            img_f = self._image_features(images)
        logits = M.cosine_logits(img_f, txt_f, self.clip_model.logit_scale)
        return F.cross_entropy(logits, labels.long())

    def forward_backward(self, batch):
        images, labels = self.parse_batch_train(batch)
        self.optimizer("prompt_learner").zero_grad(set_to_none=True)
        loss = self._loss(images, self.put_batch(labels))
        loss.backward()
        self.optimizer_step("prompt_learner")
        self._cached_text_features = None  # ctx changed
        return {"loss": loss.detach()}

    # -- eval ---------------------------------------------------------------
    def model_inference(self, images):
        txt_f = self.text_features()
        img_f = M.normalize(self._image_features(images))
        scale = torch.exp(self.clip_model.logit_scale.float())
        logits = scale * (img_f.float() @ txt_f.float().T)
        return logits, img_f, txt_f

    def load_model(self, directory, epoch=None):
        super().load_model(directory, epoch)
        self._cached_text_features = None
