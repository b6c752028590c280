"""The benchmark's seeded CLIP weights, made on the device.

The names and layouts are those both sides read: the port's CLIP module
parameters (``<tower>.blocks.<i>.attn.wqkv`` [in, out], ...) and the
reference (``reference/clip_ref.py``); each tower's MLP has the width
the configuration states (``schema.mlp_width``). Values follow OpenAI
CLIP's initialisation (``clip/model.py``: ``initialize_parameters``),
with small random biases and LayerNorm scales near one so that every
term of the forward is exercised. All values come from one
``torch.Generator`` on the device in one call; the matmul weights are
then rounded to the configuration's precision, the rest kept in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import schema

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}

#: parameter name suffixes held in the compute precision (the products'
#: weights); every other tensor is fp32
MATMUL_WEIGHTS = ("wqkv", "wo", "w_fc", "w_proj", "patch_kernel", "proj",
                  "text_projection")


def _blocks(prefix: str, layers: int, width: int,
            mlp: int) -> List[Tuple]:
    out = []
    resid = width ** -0.5 * (2 * layers) ** -0.5
    for i in range(layers):
        p = f"{prefix}.blocks.{i}."
        out += [(p + "ln_1.scale", (width,), "ln"),
                (p + "ln_1.bias", (width,), 0.02),
                (p + "attn.wqkv", (width, 3 * width), width ** -0.5),
                (p + "attn.bqkv", (3 * width,), 0.02),
                (p + "attn.wo", (width, width), resid),
                (p + "attn.bo", (width,), 0.02),
                (p + "ln_2.scale", (width,), "ln"),
                (p + "ln_2.bias", (width,), 0.02),
                (p + "mlp.w_fc", (width, mlp), (2 * width) ** -0.5),
                (p + "mlp.b_fc", (mlp,), 0.02),
                (p + "mlp.w_proj", (mlp, width), resid),
                (p + "mlp.b_proj", (width,), 0.02)]
    return out


def layout(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, std) of every tensor; std ``"ln"`` is a LayerNorm
    scale (1 + 0.02 N(0, 1)), ``"logit_scale"`` the log of 1/0.07."""
    vw, tw = cfg["vision_width"], cfg["transformer_width"]
    p, E = cfg["vision_patch_size"], cfg["embed_dim"]
    L = (cfg["image_resolution"] // p) ** 2 + 1
    out = [("visual.patch_kernel", (p * p * 3, vw), vw ** -0.5),
           ("visual.class_embedding", (vw,), vw ** -0.5),
           ("visual.positional_embedding", (L, vw), vw ** -0.5),
           ("visual.ln_pre.scale", (vw,), "ln"),
           ("visual.ln_pre.bias", (vw,), 0.02)]
    out += _blocks("visual", cfg["vision_layers"], vw,
                   schema.mlp_width(cfg, "vision"))
    out += [("visual.ln_post.scale", (vw,), "ln"),
            ("visual.ln_post.bias", (vw,), 0.02),
            ("visual.proj", (vw, E), vw ** -0.5),
            ("text.token_embedding", (cfg["vocab_size"], tw), 0.02),
            ("text.positional_embedding", (cfg["context_length"], tw),
             0.01)]
    out += _blocks("text", cfg["transformer_layers"], tw,
                   schema.mlp_width(cfg, "transformer"))
    out += [("text.ln_final.scale", (tw,), "ln"),
            ("text.ln_final.bias", (tw,), 0.02),
            ("text.text_projection", (tw, E), tw ** -0.5),
            ("logit_scale", (), "logit_scale")]
    return out


@torch.no_grad()
def make(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration from ``seed``, on ``device``."""
    spec = layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    dtype = DTYPES[cfg["precision"]]
    out, at = {}, 0
    for (name, shape, std), n in zip(spec, sizes):
        x = flat[at:at + n].reshape(shape)
        at += n
        if std == "ln":
            x = 1.0 + 0.02 * x
        elif std == "logit_scale":
            x = torch.full(shape, math.log(1 / 0.07), device=device)
        else:
            x = x * std
        if name.rsplit(".", 1)[-1] in MATMUL_WEIGHTS:
            x = x.to(dtype)
        out[name] = x
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into the port's module; the names have to match
    its parameters one for one."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"weights and module differ: only in the module "
            f"{sorted(set(params) - set(weights))[:5]}, only in the "
            f"weights {sorted(set(weights) - set(params))[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
    return model
