"""Multi-head attention and the per-token ops of the CLIP towers.

Batch-first [B, L, D] end to end. The QKV projection is one fused
[D, 3D] matmul, and its packed output goes straight into the fused
attention ``ops/mha_qkv.py`` (kernel K1 on the card): heads are never
split or transposed in device memory. Softmax and LayerNorm run in fp32
whatever the compute dtype (reference fp16-safe LayerNorm,
``clip/model.py:153-159``); ``layer_norm`` is ``ops/layer_norm.py``'s
(one kernel forward and one backward on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from .layer_norm import layer_norm  # noqa: F401  (the towers' LayerNorm)
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


def biased_qdot(x: torch.Tensor, w, b: torch.Tensor, qmode: str = "dequant",
                row_amax=None, reduce=None) -> torch.Tensor:
    """The towers' biased product: ``qdot(x, w, qmode, row_amax)``
    (``ops/quant.py``), summed by ``reduce`` when given (the model ranks'
    partial products of a row-cut weight, ``parallel/tp.py``), then the
    fp32 bias ``b`` cast to x's dtype added."""
    y = qdot(x, w, qmode, row_amax)
    if reduce is not None:
        y = reduce(y)
    return y + b.to(x.dtype)


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
    if mask is None:
        L = x.shape[1]
        mask = torch.zeros((L, L), dtype=torch.float32, device=x.device)
    qkv = biased_qdot(x, wqkv, bqkv, qmode)
    ctx = mha_qkv(qkv.contiguous(), mask.float().contiguous(), n_heads)
    final = biased_qdot(ctx, wo, bo, qmode)
    return (final, ctx) if return_ctx else final


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) (reference QuickGELU, ``clip/model.py:162-164``)."""
    return x * torch.sigmoid(1.702 * x)


#: the MLP activations a ``CLIPConfig`` names: OpenAI's QuickGELU and the
#: exact (erf) GELU of OpenCLIP's towers (``nn.GELU()``)
ACTIVATIONS = {"quick_gelu": quick_gelu,
               "gelu": torch.nn.functional.gelu}
