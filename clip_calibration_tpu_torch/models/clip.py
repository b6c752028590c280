"""CLIP dual-tower model (ViT or ModifiedResNet image tower + text tower)
as ``nn.Module``s.

Mirrors ``clip_calibration_tpu/models/clip.py`` with PyTorch idiom: the
towers are modules holding their parameters (frozen: the eval path never
backpropagates), the functions below run them. Layouts are the JAX
package's — batch-first [B, L, D], matmul weights stored [in, out]
(``x @ w``), patchify-as-matmul with (ph, pw, c) patch vectors — so the
same flattened parameters load into either package
(``models/weights.py::params_from_numpy``).

The ResNet presets' image tower is ``models/resnet.py::ModifiedResNet``
(NCHW convolutions; its parameters keep the JAX package's tree, the conv
kernels carried HWIO <-> OIHW by ``models/weights.py``).

Precision: matmul weights in the compute dtype (bf16, or fp32);
LayerNorm, softmax, logits and embeddings in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import attention as _attention
from ..ops.attention import (ACTIVATIONS, biased_qdot, causal_mask,
                             layer_norm)
from ..ops.quant import BLOCK_WEIGHTS, qdot
from ..tools import profiling


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: int
    vision_width: int
    vision_patch_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int
    context_length: int = 77
    vocab_size: int = 49408
    # OpenCLIP's towers state these; None takes OpenAI's layout, filled in
    # on construction: heads of 64 (the ResNet attention pool: width 32 /
    # 64), MLPs 4x their tower's width
    vision_heads: Optional[int] = None
    vision_mlp_width: Optional[int] = None
    transformer_mlp_width: Optional[int] = None
    #: the MLP's activation, ``ACTIVATIONS``
    activation: str = "quick_gelu"

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"activation {self.activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        fill = {"transformer_mlp_width": 4 * self.transformer_width}
        if self.is_vit:
            fill["vision_heads"] = self.vision_width // 64
            fill["vision_mlp_width"] = 4 * self.vision_width
        else:
            fill["vision_heads"] = self.vision_width * 32 // 64
        for name, value in fill.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, value)

    @property
    def is_vit(self) -> bool:
        # a ModifiedResNet tower names its four stages' depths
        return isinstance(self.vision_layers, int)

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def vision_seq_len(self) -> int:
        return self.grid_size ** 2 + 1


# presets of the public OpenAI checkpoints, plus the tiny test backbones
PRESETS: Dict[str, CLIPConfig] = {
    "ViT-B/16": CLIPConfig(512, 224, 12, 768, 16, 512, 8, 12),
    "ViT-B/32": CLIPConfig(512, 224, 12, 768, 32, 512, 8, 12),
    "ViT-L/14": CLIPConfig(768, 224, 24, 1024, 14, 768, 12, 12),
    "ViT-L/14@336px": CLIPConfig(768, 336, 24, 1024, 14, 768, 12, 12),
    # OpenCLIP (open_clip/model_configs/ViT-bigG-14.json): heads of 104,
    # MLP ratio 4.9231 (vision) and 4 (text), exact GELU
    "ViT-bigG/14": CLIPConfig(1280, 224, 48, 1664, 14, 1280, 20, 32,
                              vision_heads=16, vision_mlp_width=8192,
                              transformer_mlp_width=5120, activation="gelu"),
    "RN50": CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None, 512, 8, 12),
    "RN101": CLIPConfig(512, 224, (3, 4, 23, 3), 64, None, 512, 8, 12),
    # width and resolution scaled jointly (reference clip/clip.py:30-39)
    "RN50x4": CLIPConfig(640, 288, (4, 6, 10, 6), 80, None, 640, 10, 12),
    "RN50x16": CLIPConfig(768, 384, (6, 8, 18, 8), 96, None, 768, 12, 12),
    "RN50x64": CLIPConfig(1024, 448, (3, 15, 36, 10), 128, None,
                          1024, 16, 12),
    "ViT-Test": CLIPConfig(32, 32, 2, 64, 8, 64, 4, 2),
    # ModifiedResNet at (1, 1, 1, 1) depth: stem /4, then 3 strided stages
    # -> a 1x1 attention-pool grid at 32 px
    "RN-Test": CLIPConfig(32, 32, (1, 1, 1, 1), 8, None, 64, 4, 2),
}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, width: int, device):
        super().__init__()
        self.scale = _param((width,), torch.float32, device)
        self.bias = _param((width,), torch.float32, device)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias)


class Attention(nn.Module):
    def __init__(self, width: int, dtype, device):
        super().__init__()
        self.wqkv = _param((width, 3 * width), dtype, device)
        self.bqkv = _param((3 * width,), torch.float32, device)
        self.wo = _param((width, width), dtype, device)
        self.bo = _param((width,), torch.float32, device)


class MLP(nn.Module):
    def __init__(self, width: int, mlp_width: int, dtype, device):
        super().__init__()
        self.w_fc = _param((width, mlp_width), dtype, device)
        self.b_fc = _param((mlp_width,), torch.float32, device)
        self.w_proj = _param((mlp_width, width), dtype, device)
        self.b_proj = _param((width,), torch.float32, device)


class Block(nn.Module):
    """One residual attention block: pre-LN, an MLP of ``mlp_width``
    hidden features under ``activation`` (``ops/attention.py::
    ACTIVATIONS``; OpenAI's: 4x width, QuickGELU)."""

    def __init__(self, width: int, mlp_width: int, activation: str, dtype,
                 device):
        super().__init__()
        self.ln_1 = LayerNorm(width, device)
        self.attn = Attention(width, dtype, device)
        self.ln_2 = LayerNorm(width, device)
        self.mlp = MLP(width, mlp_width, dtype, device)
        self.act = ACTIVATIONS[activation]

    def forward(self, h, n_heads: int, mask, qmode: str = "dequant",
                stats: Optional[dict] = None, tp=None):
        """mask: [L, L] additive fp32, contiguous (``transformer``'s one
        tensor for every layer). ``qmode``: how int8 weights run
        (``ops/quant.py::qdot``). ``stats``: when given, the absmax over
        the first ``stats["real_len"]`` tokens of each quantized-matmul
        input is appended to ``stats[(outer, key)]``. ``tp``: a
        ``parallel/tp.py::TowerTP``: this rank's heads and weight slices
        (``tp.block``); the row cuts' (``wo``, ``w_proj``) partial products
        summed by ``tp.all_reduce`` before their bias, their dynamic
        activation scales from the whole row's absmax (``tp.max``)."""
        a, m = self.attn, self.mlp
        if tp is None:
            w = {"wqkv": a.wqkv, "bqkv": a.bqkv, "wo": a.wo,
                 "w_fc": m.w_fc, "b_fc": m.b_fc, "w_proj": m.w_proj}
            row_amax = reduce = None
        else:
            w, n_heads = tp.block(self), tp.heads(n_heads)
            row_amax, reduce = tp.max, tp.all_reduce
        ln1 = self.ln_1(h)
        # the fused attention (K1), looked up at call time: tracing
        # replaces the module's entry point. No name holds qkv, so outside
        # autograd it is freed once K1 has read it (the tower's peak memory)
        ctx = _attention.mha_qkv(
            biased_qdot(ln1, w["wqkv"], w["bqkv"], qmode).contiguous(), mask,
            n_heads)
        h = h + biased_qdot(ctx, w["wo"], a.bo, qmode, row_amax, reduce)
        fc_in = self.ln_2(h)
        y = self.act(biased_qdot(fc_in, w["w_fc"], w["b_fc"], qmode))
        out = h + biased_qdot(y, w["w_proj"], m.b_proj, qmode, row_amax,
                              reduce)
        if stats is not None:
            _record_stats(stats, ln1, ctx, fc_in, y, tp)
        return out


def _record_stats(stats: dict, ln1, ctx, fc_in, y, tp=None) -> None:
    """Appends the absmax over the first ``stats["real_len"]`` tokens of
    each quantized-matmul input of a block; under ``tp`` the row-cut
    sites' (``wo``, ``w_proj``) over every model rank's features."""
    L = stats["real_len"]
    for site, t in ((("attn", "wqkv"), ln1), (("attn", "wo"), ctx),
                    (("mlp", "w_fc"), fc_in), (("mlp", "w_proj"), y)):
        amax = t[:, :L].float().abs().amax()
        if tp is not None and site[1] in ("wo", "w_proj"):
            amax = tp.max(amax)
        stats[site].append(amax)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device):
        super().__init__()
        vw, p = cfg.vision_width, cfg.vision_patch_size
        f32 = torch.float32
        self.patch_kernel = _param((p * p * 3, vw), dtype, device)
        self.class_embedding = _param((vw,), f32, device)
        self.positional_embedding = _param((cfg.vision_seq_len, vw), f32,
                                           device)
        self.ln_pre = LayerNorm(vw, device)
        self.blocks = nn.ModuleList(
            Block(vw, cfg.vision_mlp_width, cfg.activation, dtype, device)
            for _ in range(cfg.vision_layers))
        self.ln_post = LayerNorm(vw, device)
        self.proj = _param((vw, cfg.embed_dim), dtype, device)


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device):
        super().__init__()
        tw = cfg.transformer_width
        f32 = torch.float32
        self.token_embedding = _param((cfg.vocab_size, tw), f32, device)
        self.positional_embedding = _param((cfg.context_length, tw), f32,
                                           device)
        self.blocks = nn.ModuleList(
            Block(tw, cfg.transformer_mlp_width, cfg.activation, dtype,
                  device)
            for _ in range(cfg.transformer_layers))
        self.ln_final = LayerNorm(tw, device)
        self.text_projection = _param((tw, cfg.embed_dim), dtype, device)


class CLIP(nn.Module):
    """Both towers and the learned log logit scale. Parameters are
    allocated uninitialised: fill them with ``init_clip`` or
    ``models/weights.py::params_from_numpy``."""

    def __init__(self, cfg: CLIPConfig, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if cfg.is_vit:
            self.visual = VisionTower(cfg, dtype, device)
        else:
            from .resnet import ModifiedResNet
            self.visual = ModifiedResNet(cfg, dtype, device)
        self.text = TextTower(cfg, dtype, device)
        self.logit_scale = _param((), torch.float32, device)


@torch.no_grad()
def init_clip(model: CLIP, seed: int) -> CLIP:
    """Seeded random init in place, with the reference's distributions
    (``clip/model.py:572-580``). Draws from a ``torch.Generator`` on the
    model's device, so values differ from the JAX package's init."""
    device = model.logit_scale.device
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=device,
                            dtype=torch.float32) * std)

    def blocks(mods, width):
        n = len(mods)
        for b in mods:
            for ln in (b.ln_1, b.ln_2):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
            normal(b.attn.wqkv, width ** -0.5)
            b.attn.bqkv.zero_()
            normal(b.attn.wo, (width ** -0.5) * ((2 * n) ** -0.5))
            b.attn.bo.zero_()
            normal(b.mlp.w_fc, (2 * width) ** -0.5)
            b.mlp.b_fc.zero_()
            normal(b.mlp.w_proj, (width ** -0.5) * ((2 * n) ** -0.5))
            b.mlp.b_proj.zero_()

    cfg = model.cfg
    v, t = model.visual, model.text
    if cfg.is_vit:
        scale = cfg.vision_width ** -0.5
        normal(v.patch_kernel, scale)
        normal(v.class_embedding, scale)
        normal(v.positional_embedding, scale)
        blocks(v.blocks, cfg.vision_width)
        normal(v.proj, scale)
        for ln in (v.ln_pre, v.ln_post):
            ln.scale.fill_(1.0)
            ln.bias.zero_()
    else:
        from .resnet import init_modified_resnet
        init_modified_resnet(v, gen)
    normal(t.token_embedding, 0.02)
    normal(t.positional_embedding, 0.01)
    blocks(t.blocks, cfg.transformer_width)
    normal(t.text_projection, cfg.transformer_width ** -0.5)
    t.ln_final.scale.fill_(1.0)
    t.ln_final.bias.zero_()
    model.logit_scale.fill_(math.log(1 / 0.07))
    return model


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------

def transformer(blocks: nn.ModuleList, x: torch.Tensor, n_heads: int,
                mask: Optional[torch.Tensor] = None, qmode: str = "dequant",
                collect_act_stats: bool = False, *,
                deep_prompts: Optional[torch.Tensor] = None,
                deep_prompt_depth: int = 0, text_side: bool = False,
                remat: bool = False, tp=None):
    """Run the residual blocks over x [B, L, D].

    deep_prompts: [rows, n_ctx, D] per-layer prompt tokens. Layer i in
    [1, deep_prompt_depth) splices row i-1 into the sequence before its
    attention (layer 0 never splices: the shallow prompt is already in
    x); rows past ``n_layers - 1`` are dropped and layers past the last
    row splice zeros, as the JAX package pads the stack to one row a
    layer. ``text_side`` picks the splice: positions [1, 1+n_ctx) (text)
    or the last n_ctx REAL tokens (vision), ahead of the padding below.

    The token axis is padded ONCE to a multiple of 16 for the whole tower
    (the JAX package's contract, kept so both see the same shapes):
    padded keys are masked with finfo.min, padded rows attend to token 0
    only, so real-token outputs are unchanged and every row keeps a finite
    key; the pad is sliced off on return.

    qmode: execution mode of int8 weights (``ops/quant.py::qdot``).
    collect_act_stats: also return, per quantized-matmul input site, the
    absmax over the real tokens (padding rows excluded; the matmuls still
    run over them) as [n_layers] tensors, ``{"attn": {"wqkv", "wo"},
    "mlp": {"w_fc", "w_proj"}}``: the calibration capture of static w8a8.
    Return becomes ``(out, stats)``.
    remat: checkpoint each layer (``torch.utils.checkpoint``, non-reentrant;
    the JAX package's ``jax.checkpoint`` on the scan body): under autograd
    only the layer inputs are kept, and the backward runs each layer's
    forward again (K1 included) before its backward. Same values and
    gradients; memory for the large text fan-outs.
    tp: optional ``parallel/tp.py::TowerTP``: tensor-parallel blocks
    (this rank's heads and MLP hidden features, two ``all_reduce`` a
    layer), forward only; None runs the whole blocks.
    """
    transformer.forwards += 1
    L = x.shape[1]
    Lp = ((L + 15) // 16) * 16
    if Lp != L:
        x = torch.nn.functional.pad(x, (0, 0, 0, Lp - L))
        neg = torch.finfo(torch.float32).min
        full = torch.zeros((Lp, Lp), dtype=torch.float32, device=x.device)
        if mask is not None:
            full[:L, :L] = mask.float()
        full[:, L:] = neg
        full[L:, :] = neg
        full[L:, 0] = 0.0
        mask = full
    elif mask is None:
        mask = torch.zeros((L, L), dtype=torch.float32, device=x.device)
    else:
        mask = mask.float().contiguous()
    stats = None
    if collect_act_stats:
        stats = {"real_len": L, **{(o, k): [] for o, k in BLOCK_WEIGHTS}}
    rows = 0
    if deep_prompts is not None:
        rows = min(deep_prompts.shape[0], len(blocks) - 1)
        zeros = torch.zeros(deep_prompts.shape[1:], dtype=x.dtype,
                            device=x.device)
    for i, block in enumerate(blocks):
        if deep_prompts is not None and 0 < i < deep_prompt_depth:
            prompt = deep_prompts[i - 1] if i - 1 < rows else zeros
            x = (_splice_text(x, prompt) if text_side
                 else _splice_vision(x, prompt, L))
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, n_heads, mask, qmode=qmode,
                           stats=stats, use_reentrant=False)
        else:
            x = block(x, n_heads, mask, qmode=qmode, stats=stats, tp=tp)
    x = x[:, :L] if Lp != L else x
    if not collect_act_stats:
        return x
    out = {}
    for o, k in BLOCK_WEIGHTS:
        out.setdefault(o, {})[k] = torch.stack(stats[(o, k)])
    return x, out



#: tower forwards run since the last reset (each runs one fused-attention
#: call per layer)
transformer.forwards = 0


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def _splice_text(x: torch.Tensor, prompt: torch.Tensor) -> torch.Tensor:
    """Replace x[:, 1:1+n_ctx] with prompt (text-side splice, reference
    ``clip/model.py:247-256``)."""
    n_ctx = prompt.shape[0]
    tiled = prompt.to(x.dtype).expand(x.shape[0], *prompt.shape)
    return torch.cat([x[:, :1], tiled, x[:, 1 + n_ctx:]], dim=1)


def _splice_vision(x: torch.Tensor, prompt: torch.Tensor,
                   real_len: int) -> torch.Tensor:
    """Replace the trailing n_ctx REAL tokens with prompt (vision-side
    splice, reference ``clip/model.py:236-243``); padding rows past
    ``real_len`` stay in place."""
    n_ctx = prompt.shape[0]
    tiled = prompt.to(x.dtype).expand(x.shape[0], *prompt.shape)
    return torch.cat([x[:, :real_len - n_ctx], tiled, x[:, real_len:]],
                     dim=1)


@profiling.span("tower.text")
def encode_text_embedded(model: CLIP, cfg: CLIPConfig, x: torch.Tensor,
                         eot_pos: torch.Tensor,
                         seq_len: Optional[int] = None,
                         qmode: str = "dequant",
                         collect_act_stats: bool = False, *,
                         deep_prompts: Optional[torch.Tensor] = None,
                         deep_prompt_depth: int = 0, remat: bool = False,
                         tp=None):
    """Text tower over pre-embedded prompts [N, 77, D] (the PromptLearner
    path, reference TextEncoder ``trainers/classification/coop.py:47-67``).

    eot_pos: [N] index of the EOT token per row (pooling position).
    seq_len: truncation (> max(eot_pos)). The mask is causal, so tokens
    past the longest EOT cannot reach the pooled feature; None keeps the
    full length.
    qmode / collect_act_stats: as ``transformer``; the stats add
    ``text_projection`` (the pooled rows) and every row up to ``seq_len``
    counts, as the quantized matmuls run over them all. Return becomes
    ``(features, stats)``.
    deep_prompts / deep_prompt_depth: per-layer text prompts spliced at
    positions [1, 1+n_ctx) (``transformer``).
    remat: per-layer activation checkpointing (``transformer``), for the
    gradient passes over large class/prompt fan-outs.
    tp: tensor-parallel blocks (``transformer``).
    """
    txt = model.text
    if seq_len is not None and seq_len < x.shape[1]:
        mx = int(eot_pos.max())
        if mx >= seq_len:
            raise ValueError(
                f"seq_len={seq_len} drops an EOT at position {mx}; "
                f"use eot_seq_len(eot_pos) (= max+1)")
        x = x[:, :seq_len]
    x = x + txt.positional_embedding[:x.shape[1]].to(x.dtype)
    mask = causal_mask(x.shape[1], device=x.device)
    x = transformer(txt.blocks, x, cfg.transformer_heads, mask, qmode=qmode,
                    collect_act_stats=collect_act_stats,
                    deep_prompts=deep_prompts,
                    deep_prompt_depth=deep_prompt_depth, text_side=True,
                    remat=remat, tp=tp)
    if collect_act_stats:
        x, blocks = x
    x = txt.ln_final(x)
    # the EOT row of each prompt, as a gather along the token axis: its
    # gradient is a scatter-add, where an indexed read's would be
    # PyTorch's sorting accumulate (indexing_backward_kernel)
    idx = eot_pos.to(x.device, torch.long).reshape(-1, 1, 1)
    pooled = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1])).squeeze(1)
    feats = qdot(pooled, txt.text_projection, qmode)
    if not collect_act_stats:
        return feats
    return feats, {"blocks": blocks,
                   "text_projection": pooled.float().abs().amax()}


def eot_seq_len(tokens_or_eot) -> int:
    """One past the furthest EOT pooling position, from raw [N, L] token
    rows (EOT is the max token id per row) or [N] EOT positions."""
    a = np.asarray(tokens_or_eot)
    if a.ndim == 2:
        a = a.argmax(-1)
    return int(np.max(a)) + 1


def encode_text(model: CLIP, cfg: CLIPConfig, tokens: torch.Tensor,
                dtype=torch.bfloat16, seq_len: Optional[int] = None,
                tp=None, qmode: str = "dequant") -> torch.Tensor:
    """Raw-token text encode (reference ``clip/model.py:598-613``); ``tp``
    and ``qmode`` as ``transformer``."""
    x = model.text.token_embedding[tokens].to(dtype)
    # EOT from the UNTRUNCATED row; encode_text_embedded then rejects a
    # seq_len that would drop it
    eot_pos = tokens.argmax(dim=-1)
    return encode_text_embedded(model, cfg, x, eot_pos, seq_len=seq_len,
                                qmode=qmode, tp=tp)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, n_patches, p*p*3], (ph, pw, c) patch order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


@profiling.span("tower.vision")
def encode_image(model: CLIP, cfg: CLIPConfig, images: torch.Tensor,
                 dtype=torch.bfloat16, qmode: str = "dequant",
                 collect_act_stats: bool = False, *,
                 shallow_prompts: Optional[torch.Tensor] = None,
                 deep_prompts: Optional[torch.Tensor] = None,
                 deep_prompt_depth: int = 0, tp=None):
    """Vision tower. images: [B, H, W, 3] (NHWC, preprocessed).

    shallow_prompts: [n_ctx, width] tokens appended after the positional
    embedding, before ``ln_pre`` (VPT / IVLP / MaPLe, reference
    ``clip/model.py:404-408``); deep_prompts: [depth-1, n_ctx, width]
    replacements of the last n_ctx real tokens in layers 1..depth-1
    (``transformer``).

    qmode: execution mode of int8 weights (``ops/quant.py::qdot``).
    collect_act_stats: also return the absmax of every quantized-matmul
    input (patchified pixels, the block sites of ``transformer``, the
    ln_post output feeding ``proj``) for static w8a8 calibration; return
    becomes ``(features, stats)``; ViT only.

    A ResNet preset runs ``models/resnet.py::ModifiedResNet`` (its convs,
    BatchNorm and attention pool; ``qmode`` does not apply: the ResNet
    tower is never quantized).

    tp: tensor-parallel blocks (``transformer``); ViT only, the
    ModifiedResNet tower is data-parallel only."""
    if not cfg.is_vit:
        if tp is not None:
            raise ValueError(
                "Tensor-parallel execution covers the ViT towers only; "
                "serve ResNet backbones data-parallel (parallel/tp.py)")
        if collect_act_stats:
            raise ValueError(
                "activation-scale calibration covers the ViT towers only "
                "(int8 quantization is ViT-only, ops/quant.py)")
        if shallow_prompts is not None or deep_prompts is not None:
            # the reference has no ResNet prompt path either; fail loudly
            # instead of dropping the prompts
            raise ValueError(
                "Vision prompts are not supported with ResNet backbones; "
                "use a ViT backbone for prompt-injection trainers")
        return model.visual(images.to(dtype), cfg.vision_heads)
    vp = model.visual
    x = patchify(images.to(dtype), cfg.vision_patch_size)
    stats = {}
    if collect_act_stats:
        stats["patch_kernel"] = x.float().abs().amax()
    x = qdot(x, vp.patch_kernel, qmode)
    cls = vp.class_embedding.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + vp.positional_embedding.to(x.dtype)
    if shallow_prompts is not None:
        x = torch.cat([x, shallow_prompts.to(x.dtype).expand(
            x.shape[0], *shallow_prompts.shape)], dim=1)
    x = vp.ln_pre(x)
    x = transformer(vp.blocks, x, cfg.vision_heads, qmode=qmode,
                    collect_act_stats=collect_act_stats,
                    deep_prompts=deep_prompts,
                    deep_prompt_depth=deep_prompt_depth, text_side=False,
                    tp=tp)
    if collect_act_stats:
        x, stats["blocks"] = x
    x = vp.ln_post(x[:, 0])
    feats = qdot(x, vp.proj, qmode)
    if not collect_act_stats:
        return feats
    stats["proj"] = x.float().abs().amax()
    return feats, stats


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
                + eps).to(x.dtype)


def cosine_logits(image_features: torch.Tensor,
                  text_features: torch.Tensor,
                  logit_scale: torch.Tensor,
                  text_hook: Optional[Callable] = None) -> torch.Tensor:
    """scale * normalize(img) @ normalize(txt).T in fp32. ``text_hook``
    takes the fp32 normalized text features before the product (a
    trainer's ``replicated_text``: on a data mesh, the sum of their
    gradient over the data ranks)."""
    img = normalize(image_features).float()
    txt = normalize(text_features).float()
    if text_hook is not None:
        txt = text_hook(txt)
    return torch.exp(logit_scale.float()) * (img @ txt.T)
