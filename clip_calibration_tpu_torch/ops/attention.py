"""Multi-head attention and the per-token ops of the CLIP towers.

Batch-first [B, L, D] end to end. The QKV projection is one fused
[D, 3D] matmul, and its packed output goes straight into the fused
attention ``ops/mha_qkv.py`` (kernel K1 on the card): heads are never
split or transposed in device memory. Softmax and LayerNorm run in fp32
whatever the compute dtype (reference fp16-safe LayerNorm,
``clip/model.py:153-159``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .mha_qkv import mha_qkv
from .quant import qdot


def causal_mask(length: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask matching the reference text mask
    (``clip/model.py:585-591``): 0 on/below the diagonal, finfo.min
    above (never -inf, so a fully masked row stays finite)."""
    neg = torch.finfo(dtype).min
    return torch.triu(torch.full((length, length), neg, dtype=dtype,
                                 device=device), diagonal=1)


def multi_head_attention(x: torch.Tensor, wqkv, bqkv: torch.Tensor, wo,
                         bo: torch.Tensor, n_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         qmode: str = "dequant", return_ctx: bool = False):
    """Self-attention over x [B, L, D]: wqkv [D, 3D] (torch
    ``in_proj_weight`` transposed), wo [D, D], each a plain tensor or an
    int8 ``QuantizedWeight`` run in ``qmode`` (``ops/quant.py::qdot``; the
    attention itself stays float); mask [L, L] additive fp32 (zeros when
    None). ``return_ctx`` also returns the context [B, L, D] that feeds
    ``wo`` (the activation-scale calibration site)."""
    L = x.shape[1]
    qkv = qdot(x, wqkv, qmode) + bqkv.to(x.dtype)
    if mask is None:
        mask = torch.zeros((L, L), dtype=torch.float32, device=x.device)
    out = mha_qkv(qkv.contiguous(), mask.float().contiguous(), n_heads)
    final = qdot(out, wo, qmode) + bo.to(x.dtype)
    return (final, out) if return_ctx else final


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 regardless of input dtype, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (reference QuickGELU, ``clip/model.py:162-164``)."""
    return x * torch.sigmoid(1.702 * x)
