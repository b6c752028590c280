"""Fused multi-head attention over a packed QKV tensor: forward (kernel
K1) and backward (kernel K2).

``mha_qkv`` replaces ``clip_calibration_tpu/ops/pallas_attention.py``'s
``pallas_mha_qkv`` with its custom VJP: one ``torch.autograd.Function``
whose forward launches K1 (``csrc/mha_qkv_fwd.cu``) and saves
``(qkv, mask)``, the JAX ``_fwd``'s residuals, and whose backward launches
K2 (``csrc/mha_qkv_bwd.cu``) and returns ``dqkv``; the mask gets no
gradient (JAX's is zero). Both are built at first use (``ops/build.py``).
CPU tensors run the plain versions ``mha_qkv_reference`` and
``mha_qkv_bwd_reference`` below, in both directions. Any other input
raises. Unlike the JAX ``_bwd``, which routes small shapes to an einsum
backward (a crossover measured on a TPU v5e), the card launches K2 at
every shape.

Numerics: scores, softmax and sums are fp32 on both sides. The forward
kernel applies the 1/sqrt(d) scale to the fp32 scores and normalises once
at the end (online softmax); the plain version, like the JAX code, scales
q in the input dtype and normalises P before rounding it to v's dtype. The
backward kernel recomputes P from stored row statistics and rounds P and
ds to the input dtype where the JAX kernel does. In fp32 kernel and plain
version agree to summation order; in bf16 they differ by bf16 rounding
(tolerances in ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import torch

#: head dims the CUDA kernels are compiled for (ViT-Test: 16; every public
#: CLIP preset: 64)
KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.reshape(B, L, n_heads, D // n_heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, L, d = t.shape
    return t.transpose(1, 2).reshape(B, L, H * d)


def mha_qkv_reference(qkv: torch.Tensor, mask: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """Plain PyTorch version: split heads, scaled QK^T + mask, fp32
    softmax, P in qkv's dtype, P.V with fp32 sums, heads merged."""
    D = qkv.shape[-1] // 3
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(D, dim=-1))
    d = D // n_heads
    scores = torch.matmul((q / d ** 0.5).float(), k.float().transpose(-1, -2))
    scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.matmul(probs.float(), v.float()).to(qkv.dtype)
    return _merge_heads(out)


def mha_qkv_bwd_reference(qkv: torch.Tensor, mask: torch.Tensor,
                          g: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the backward, step by step as the JAX
    kernel (``_mha_qkv_bwd_kernel``): recompute fp32 P from q scaled in
    qkv's dtype, dv = bf16(P)^T g, dp = g v^T, ds = P (dp - rowsum(dp P)),
    dq = scale bf16(ds) k, dk = scale bf16(ds)^T q, fp32 sums; returns
    dqkv [B, L, 3D] in qkv's dtype."""
    D = qkv.shape[-1] // 3
    d = D // n_heads
    scale = 1.0 / d ** 0.5
    q, k, v = (_split_heads(t, n_heads) for t in qkv.split(D, dim=-1))
    gh = _split_heads(g.to(qkv.dtype), n_heads).float()
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    p = torch.softmax(s + mask.float(), dim=-1)
    pb = p.to(v.dtype).float()
    dv = torch.matmul(pb.transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(q.dtype).float()
    dq = scale * torch.matmul(dsb, k.float())
    dk = scale * torch.matmul(dsb.transpose(-1, -2), q.float())
    return torch.cat([_merge_heads(t) for t in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


def _check(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int):
    if not isinstance(qkv, torch.Tensor) or qkv.ndim != 3:
        raise ValueError("qkv must be a [B, L, 3D] tensor")
    B, L, D3 = qkv.shape
    if D3 % 3 or (D3 // 3) % n_heads:
        raise ValueError(f"qkv width {D3} is not 3 x a multiple of "
                         f"n_heads={n_heads}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != (L, L):
        raise ValueError(f"mask must be float32 [{L}, {L}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != qkv.device:
        raise ValueError(f"mask on {mask.device}, qkv on {qkv.device}")
    if not (qkv.is_contiguous() and mask.is_contiguous()):
        raise ValueError("qkv and mask must be contiguous")
    if mask.requires_grad:
        raise ValueError("the attention mask gets no gradient; pass it "
                         "without requires_grad")
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mha_qkv runs on cuda or cpu, not {qkv.device}")
    if qkv.device.type == "cuda":
        if D3 // 3 // n_heads not in KERNEL_HEAD_DIMS:
            raise ValueError(f"head dim {D3 // 3 // n_heads} not in "
                             f"{KERNEL_HEAD_DIMS}")
        if qkv.data_ptr() % 16:
            raise ValueError("qkv must be 16-byte aligned (vector loads)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(qkv: torch.Tensor, mask: torch.Tensor,
             n_heads: int) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return mha_qkv_reference(qkv, mask, n_heads)
    B, L, D3 = qkv.shape
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _library("mha_qkv_fwd").mha_qkv_fwd(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), B, L, D3 // 3,
            n_heads, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    if err != 0:
        raise RuntimeError(f"mha_qkv_fwd launch failed: cudaError_t {err}")
    mha_qkv.launches += 1
    return out


def mha_qkv_bwd(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    """K2: d(sum(out * g))/d(qkv) for out = mha_qkv(qkv, mask, n_heads).
    g [B, L, D] in qkv's dtype -> dqkv [B, L, 3D], packed like qkv."""
    _check(qkv, mask, n_heads)
    B, L, D3 = qkv.shape
    if (g.dtype != qkv.dtype or tuple(g.shape) != (B, L, D3 // 3)
            or g.device != qkv.device or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {qkv.dtype} "
                         f"[{B}, {L}, {D3 // 3}] tensor on {qkv.device}")
    if qkv.device.type == "cpu":
        return mha_qkv_bwd_reference(qkv, mask, g, n_heads)
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned (vector loads)")
    dqkv = torch.empty_like(qkv)
    # per (row, head): softmax max, 1 / sum, rowsum(dp * P)
    stats = torch.empty((3, B, n_heads, L), dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _library("mha_qkv_bwd").mha_qkv_bwd(
            qkv.data_ptr(), mask.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            stats.data_ptr(), B, L, D3 // 3, n_heads,
            _DTYPE_CODES[qkv.dtype], _stream(qkv))
    if err != 0:
        raise RuntimeError(f"mha_qkv_bwd launch failed: cudaError_t {err}")
    mha_qkv_bwd.launches += 1
    return dqkv


class _MhaQkv(torch.autograd.Function):
    """The JAX custom VJP: forward K1, backward K2 (module-level
    ``mha_qkv_bwd``, looked up at call time)."""

    @staticmethod
    def forward(ctx, qkv, mask, n_heads):
        ctx.save_for_backward(qkv, mask)
        ctx.n_heads = n_heads
        return _forward(qkv, mask, n_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        dqkv = mha_qkv_bwd(qkv, mask, g.to(qkv.dtype).contiguous(),
                           ctx.n_heads)
        return dqkv, None, None


def mha_qkv(qkv: torch.Tensor, mask: torch.Tensor,
            n_heads: int) -> torch.Tensor:
    """qkv [B, L, 3D] (heads not split: head h of q/k/v at columns
    h*d, D+h*d, 2D+h*d), mask [L, L] additive fp32 -> [B, L, D] with the
    heads concatenated. Differentiable in qkv."""
    _check(qkv, mask, n_heads)
    return _MhaQkv.apply(qkv, mask, n_heads)


#: launches of the CUDA kernels since the last reset (CPU calls run the
#: plain versions and do not count)
mha_qkv.launches = 0
mha_qkv_bwd.launches = 0

_ARGTYPES = {
    "mha_qkv_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "mha_qkv_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _library(name: str) -> ctypes.CDLL:
    from . import build
    lib = build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib
