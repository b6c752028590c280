"""Fused multi-head attention over a packed QKV tensor (kernel K1).

``mha_qkv`` replaces ``clip_calibration_tpu/ops/pallas_attention.py``'s
``pallas_mha_qkv`` forward. A CUDA tensor launches the hand-written
Hopper kernel ``csrc/mha_qkv_fwd.cu`` (built at first use, see
``ops/build.py``); a CPU tensor runs the plain version
``mha_qkv_reference`` below. Any other input raises.

Numerics: scores, softmax and sums are fp32 on both sides. The kernel
applies the 1/sqrt(d) scale to the fp32 scores and normalises once at the
end (online softmax); the plain version, like the JAX code, scales q in
the input dtype and normalises P before rounding it to v's dtype. In fp32
the two agree to summation order; in bf16 they differ by bf16 rounding
of P and of the output (tolerances in ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import torch

#: head dims the CUDA kernel is compiled for (ViT-Test: 16; every public
#: CLIP preset: 64)
KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mha_qkv_reference(qkv: torch.Tensor, mask: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """Plain PyTorch version: split heads, scaled QK^T + mask, fp32
    softmax, P in qkv's dtype, P.V with fp32 sums, heads merged."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    d = D // n_heads
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.reshape(B, L, n_heads, d).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = torch.matmul((q / d ** 0.5).float(), k.float().transpose(-1, -2))
    scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.matmul(probs.float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, L, D)


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
    if qkv.requires_grad or mask.requires_grad:
        raise NotImplementedError(
            "mha_qkv has no backward yet; run under torch.inference_mode()")


def mha_qkv(qkv: torch.Tensor, mask: torch.Tensor,
            n_heads: int) -> torch.Tensor:
    """qkv [B, L, 3D] (heads not split: head h of q/k/v at columns
    h*d, D+h*d, 2D+h*d), mask [L, L] additive fp32 -> [B, L, D] with the
    heads concatenated."""
    _check(qkv, mask, n_heads)
    if qkv.device.type == "cpu":
        return mha_qkv_reference(qkv, mask, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_qkv runs on cuda or cpu, not {qkv.device}")
    B, L, D3 = qkv.shape
    D = D3 // 3
    if D // n_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D // n_heads} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned (vector loads)")
    out = torch.empty((B, L, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _library().mha_qkv_fwd(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), B, L, D,
            n_heads, _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mha_qkv_fwd launch failed: cudaError_t {err}")
    mha_qkv.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (CPU calls run the
#: plain version and do not count)
mha_qkv.launches = 0


def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load("mha_qkv_fwd")
    if lib.mha_qkv_fwd.argtypes is None:
        lib.mha_qkv_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.mha_qkv_fwd.restype = ctypes.c_int
    return lib
