"""Operations and bytes of the work the benchmark measures, from shapes.

Two kinds of count, both functions of shapes alone, so they stay the same
whatever implements the work:

- per kernel launch (K1 attention forward, K2 its backward, K3 the int8
  product): a frozen copy of ``chip_smoke.py``'s arithmetic. Each input
  byte is read once and each output byte written once. An attention
  launch is counted at the data's token count L, not at the length the
  port pads it to, so a later change that pads less reads as the same
  work done faster;
- per unit of model work (an image through the vision tower, a class row
  through the text tower, a text row's input-gradient pass), split by the
  type its products run in, for ``mfu``. A product of [m, k] by [k, n]
  is 2mkn operations; a block's MLP is counted at the tower's MLP width
  (``schema.mlp_width``); attention over L tokens of h heads of width d
  is 4hL^2d forward (QK^T and PV) and 10hL^2d backward (K2's count: PV's
  two gradients, QK^T's two, and QK^T again). Element-wise work
  (LayerNorm, GELU, softmax, residual adds) is not counted.
"""

from __future__ import annotations

from typing import Dict

from . import schema

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


# -- kernel launches --------------------------------------------------------

def k1(B: int, L: int, D3: int, heads: int, dtype: str) -> Dict[str, float]:
    """K1 (``mha_qkv_fwd``) on packed qkv [B, L, D3] with an fp32 [L, L]
    mask: reads qkv and the mask, writes [B, L, D3/3]."""
    D = D3 // 3
    elt = DTYPE_BYTES[dtype]
    return {"ops": 4.0 * B * heads * L * L * (D // heads),
            "bytes": float(B * L * D3 * elt + L * L * 4 + B * L * D * elt)}


def k2(B: int, L: int, D3: int, heads: int, dtype: str) -> Dict[str, float]:
    """K2 (``mha_qkv_bwd``): reads qkv, the output gradient [B, L, D3/3]
    and the mask, writes dqkv [B, L, D3]."""
    D = D3 // 3
    elt = DTYPE_BYTES[dtype]
    return {"ops": 10.0 * B * heads * L * L * (D // heads),
            "bytes": float((2 * B * L * D3 + B * L * D) * elt + L * L * 4)}


def k3(M: int, K: int, N: int, rescaled: bool) -> Dict[str, float]:
    """K3 (``int8_matmul``): int8 [M, K] @ int8 [K, N]; int32 out, or,
    rescaled, bf16 out plus fp32 scales of the rows and the columns."""
    if rescaled:
        nbytes = M * K + K * N + 2 * M * N + 4 * (M + N)
    else:
        nbytes = M * K + K * N + 4 * M * N
    return {"ops": 2.0 * M * N * K, "bytes": float(nbytes)}


# -- model work -------------------------------------------------------------

def _block_products(L: int, width: int, mlp: int) -> float:
    """A residual block's four projections over L tokens: qkv, the
    attention's output, and the MLP's two at its hidden width ``mlp``."""
    return 2.0 * L * width * (3 * width + width + mlp + mlp)


def _attention(L: int, cfg: dict, tower: str) -> float:
    """QK^T and PV over L tokens, at the tower's heads x head width."""
    heads = cfg[f"{tower}_heads"]
    return 4.0 * L * L * (heads * schema.head_width(cfg, tower))


def _tower(cfg: dict, tower: str, L: int) -> Dict[str, float]:
    """The tower's residual blocks over L tokens."""
    layers = cfg[f"{tower}_layers"]
    return {"products": layers * _block_products(
                L, cfg[f"{tower}_width"], schema.mlp_width(cfg, tower)),
            "attention": layers * _attention(L, cfg, tower)}


def vision_forward(cfg: dict) -> Dict[str, float]:
    """One image through the ViT: {"products": ..., "attention": ...}
    operations, at the real token count (patches + class token)."""
    L = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1
    w = cfg["vision_width"]
    patch = 2.0 * (L - 1) * 3 * cfg["vision_patch_size"] ** 2 * w
    proj = 2.0 * w * cfg["embed_dim"]
    blocks = _tower(cfg, "vision", L)
    return {"products": patch + blocks["products"] + proj,
            "attention": blocks["attention"]}


def text_forward(cfg: dict, L: int) -> Dict[str, float]:
    """One class row of L tokens through the text tower (L: the length
    the rows share, one past the furthest end-of-text token)."""
    blocks = _tower(cfg, "transformer", L)
    return {"products": blocks["products"]
            + 2.0 * cfg["transformer_width"] * cfg["embed_dim"],
            "attention": blocks["attention"]}


def text_input_grad(cfg: dict, L: int) -> Dict[str, float]:
    """The gradient of one text row's input: each frozen projection's
    input gradient (as many operations as its forward) and the attention
    backward (10hL^2d against the forward's 4)."""
    fwd = text_forward(cfg, L)
    return {"products": fwd["products"],
            "attention": fwd["attention"] * 10.0 / 4.0}
