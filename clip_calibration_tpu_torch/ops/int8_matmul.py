"""Exact int8 x int8 -> int32 matrix product (kernel K3) and the w8a8
product built on it.

``int8_matmul`` replaces ``clip_calibration_tpu/ops/pallas_int8_matmul.py``'s
``int8_matmul``: on a CUDA tensor it launches K3 (``csrc/int8_matmul.cu``,
built at first use by ``ops/build.py``); on a CPU tensor it runs the plain
version ``int8_matmul_reference``. Any other input raises. Unlike the JAX
wrapper, which zero-pads every dimension to its block multiple, the kernel
masks the ragged edges itself, so no padded copy is made.

``w8a8_matmul`` is the JAX ``w8a8_matmul``: dynamic per-row activation
quantization (``ops/quant.py::quantize_activations_int8``), K3, then the
fp32 rescale ``acc * x_scale * w_scale`` in that order, cast to x's dtype.
"""

from __future__ import annotations

import ctypes

import torch


def int8_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int64 sums on the CPU; on the card, where
    ``torch.matmul`` takes no integer types, float64 sums, which are
    exact while every partial sum stays below 2^53."""
    if x.device.type == "cpu":
        return (x.long() @ w.long()).to(torch.int32)
    if x.shape[1] * 128 * 128 >= 2 ** 53:
        raise ValueError(f"K = {x.shape[1]}: float64 sums would round")
    return (x.double() @ w.double()).to(torch.int32)


def _check(x: torch.Tensor, w: torch.Tensor):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul needs int8 operands, got "
                        f"{x.dtype} @ {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] int8 @ w [K, N] int8 -> [M, N] int32`` (exact)."""
    _check(x, w)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().int8_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError_t {err}")
    int8_matmul.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (CPU calls run the
#: plain version and do not count)
int8_matmul.launches = 0


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """w8a8 ``x @ dequant(w)``: dynamic per-row activation quantization,
    K3, the fp32 rescale; returns x's dtype. Leading dims of x ride
    along."""
    from .quant import quantize_activations_int8

    xq, xs = quantize_activations_int8(x)
    return rescaled_int8_matmul(xq, xs, w_q, w_scale, x.dtype)


def rescaled_int8_matmul(xq: torch.Tensor, xs: torch.Tensor,
                         w_q: torch.Tensor, w_scale: torch.Tensor,
                         dtype) -> torch.Tensor:
    """``int8_matmul`` over xq's last axis (leading dims ride along), then
    the fp32 rescale ``acc * xs * w_scale`` in that order, cast to
    ``dtype``. xs: per-row [..., 1] or a 0-d static scale."""
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]).contiguous(), w_q)
    acc = acc.reshape(*lead, w_q.shape[-1])
    return (acc.float() * xs
            * w_scale.reshape(w_scale.shape[-1])).to(dtype)


def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load("int8_matmul")
    if lib.int8_matmul.argtypes is None:
        lib.int8_matmul.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.int8_matmul.restype = ctypes.c_int
    return lib
