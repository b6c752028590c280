"""Exact int8 x int8 -> int32 matrix product (kernel K3) and the w8a8
product built on it.

``int8_matmul`` replaces ``clip_calibration_tpu/ops/pallas_int8_matmul.py``'s
``int8_matmul``: on a CUDA tensor it launches K3 (``csrc/int8_matmul.cu``,
built at first use by ``ops/build.py``); on a CPU tensor it runs the plain
version ``int8_matmul_reference``. Any other input raises. Unlike the JAX
wrapper, which zero-pads every dimension to its block multiple, the kernel
masks the ragged M and N edges itself; only a K that is not a multiple of
16 is zero-padded here (the kernel's 16-byte copies).

K3 reads the weight K-major ([N, K]). ``ops/quant.py::QuantizedWeight``
keeps that copy beside its [K, N] ``int8`` (buffer ``kmajor``) and every
``qdot`` int8 mode passes it as ``w_t``; a caller without one gets a
transposed copy per call.

``w8a8_matmul`` is the JAX ``w8a8_matmul``: dynamic per-row activation
quantization (``ops/quant.py::quantize_activations_int8``), K3, then the
fp32 rescale ``acc * x_scale * w_scale`` in that order, cast to x's dtype.
On the card the rescale is K3's epilogue (``rescaled_int8_matmul``); on
the CPU it is the plain PyTorch rescale below, which the epilogue matches
bit for bit (same products, same order, one rounding to the dtype).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

#: the output dtypes the rescaled epilogue writes, as the kernel's codes
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int64 sums on the CPU; on the card, where
    ``torch.matmul`` takes no integer types, float64 sums, which are
    exact while every partial sum stays below 2^53."""
    if x.device.type == "cpu":
        return (x.long() @ w.long()).to(torch.int32)
    if x.shape[1] * 128 * 128 >= 2 ** 53:
        raise ValueError(f"K = {x.shape[1]}: float64 sums would round")
    return (x.double() @ w.double()).to(torch.int32)


def rescale_reference(acc: torch.Tensor, xs: torch.Tensor,
                      w_scale: torch.Tensor, dtype) -> torch.Tensor:
    """The plain rescale: ``acc * xs * w_scale`` in fp32, in that order,
    cast to ``dtype``. acc [..., N] int32, xs per row [..., 1] or 0-d."""
    return (acc.float() * xs * w_scale.reshape(w_scale.shape[-1])).to(dtype)


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


def _operand(t: torch.Tensor, pad: int) -> torch.Tensor:
    """A contiguous 2-D int8 operand as the kernel takes it: 16-byte
    aligned, K (the last axis) zero-padded by ``pad``."""
    if pad:
        t = F.pad(t, (0, pad))
    return t.clone() if t.data_ptr() % 16 else t


def launch(lib: ctypes.CDLL, x: torch.Tensor, w_t: torch.Tensor,
           xs: torch.Tensor = None, w_scale: torch.Tensor = None,
           dtype=torch.int32) -> torch.Tensor:
    """K3 from the library ``lib`` on CUDA tensors: x [M, K] int8 @ w_t
    [N, K]^T (the weight K-major) -> [M, N] int32, or with ``xs`` (fp32,
    [M] / [M, 1] per row, or 0-d) and ``w_scale`` (fp32, N values) the
    rescaled product in ``dtype`` (fp32 or bf16). Where the launcher
    splits K (``int8_matmul_split``), a rescaled product goes through an
    int32 scratch and the elementwise rescale kernel."""
    M, K = x.shape
    N = w_t.shape[0]
    pad = -K % 16
    x, w_t = _operand(x, pad), _operand(w_t, pad)
    K += pad
    stream = build.stream(x)
    rescaled = xs is not None
    if rescaled:
        if dtype not in _OUT_CODES:
            raise TypeError(f"rescaled int8_matmul writes float32 or "
                            f"bfloat16, not {dtype}")
        if xs.dtype != torch.float32 or w_scale.dtype != torch.float32:
            raise TypeError("x and w scales must be float32")
        per_row = int(xs.ndim > 0)
        if xs.numel() != (M if per_row else 1) or w_scale.numel() != N:
            raise ValueError(f"scales {tuple(xs.shape)}, "
                             f"{tuple(w_scale.shape)} for [{M}, {N}]")
        xs, w_scale = xs.reshape(-1).contiguous(), \
            w_scale.reshape(-1).contiguous()
        out = torch.empty((M, N), dtype=dtype, device=x.device)
        acc = (torch.empty((M, N), dtype=torch.int32, device=x.device)
               if lib.int8_matmul_split(M, N, K) > 1 else None)
        err = lib.int8_matmul_rescaled(
            x.data_ptr(), w_t.data_ptr(), xs.data_ptr(), per_row,
            w_scale.data_ptr(), out.data_ptr(), _OUT_CODES[dtype],
            None if acc is None else acc.data_ptr(), M, N, K, stream)
    else:
        out = torch.empty((M, N), dtype=torch.int32, device=x.device)
        err = lib.int8_matmul(x.data_ptr(), w_t.data_ptr(), out.data_ptr(),
                              M, N, K, stream)
    build.check("int8_matmul", err)
    return out


def k3_route(M: int, N: int, K: int, rescaled: bool) -> str:
    """The route the launcher takes for a product on the card (it builds
    the library): ``split_k`` (K split across blocks, int32 atomics; a
    rescaled product then the elementwise rescale), ``rescaled`` (the
    rescale in the epilogue) or ``int32``."""
    lib = build.load("int8_matmul", ARGTYPES)
    if lib.int8_matmul_split(M, N, K + -K % 16) > 1:
        return "split_k"
    return "rescaled" if rescaled else "int32"


def kernel_product(x: torch.Tensor, w: torch.Tensor,
                   w_t: torch.Tensor = None, xs: torch.Tensor = None,
                   w_scale: torch.Tensor = None,
                   dtype=torch.int32) -> torch.Tensor:
    """Every K3 launch of the port goes through here (one count a
    product, whatever the route): x [M, K] and w [K, N] int8 on the card,
    ``w_t`` w's K-major copy if the caller keeps one (else made here),
    and for a rescaled product its scales and dtype (``launch``)."""
    if w_t is None:
        w_t = w.t().contiguous()
    elif (w_t.shape != (w.shape[1], w.shape[0]) or w_t.device != w.device
          or w_t.dtype != torch.int8 or not w_t.is_contiguous()):
        raise ValueError(f"w_t {tuple(w_t.shape)} {w_t.dtype} on "
                         f"{w_t.device} is not the contiguous K-major copy "
                         f"of w {tuple(w.shape)}")
    out = launch(build.load("int8_matmul", ARGTYPES), x, w_t, xs, w_scale,
                 dtype)
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                w_t: torch.Tensor = None) -> torch.Tensor:
    """``x [M, K] int8 @ w [K, N] int8 -> [M, N] int32`` (exact). On the
    card ``w_t``, w's K-major copy [N, K], spares a transposition."""
    _check(x, w)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w)
    return kernel_product(x, w, w_t)


#: launches of the CUDA kernel since the last reset, one per product
#: (CPU calls run the plain version and do not count)
int8_matmul.launches = 0


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                w_t: torch.Tensor = None) -> torch.Tensor:
    """w8a8 ``x @ dequant(w)``: dynamic per-row activation quantization,
    K3, the fp32 rescale; returns x's dtype. Leading dims of x ride
    along."""
    from .quant import quantize_activations_int8

    xq, xs = quantize_activations_int8(x)
    return rescaled_int8_matmul(xq, xs, w_q, w_scale, x.dtype, w_t)


def rescaled_int8_matmul(xq: torch.Tensor, xs: torch.Tensor,
                         w_q: torch.Tensor, w_scale: torch.Tensor,
                         dtype, w_t: torch.Tensor = None) -> torch.Tensor:
    """``int8_matmul`` over xq's last axis (leading dims ride along), then
    the fp32 rescale ``acc * xs * w_scale`` in that order, cast to
    ``dtype``. xs: per-row [..., 1] or a 0-d static scale. On the card
    one K3 launch with the rescale in its epilogue."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1]).contiguous()
    _check(x2, w_q)
    if x2.device.type == "cpu":
        acc = int8_matmul_reference(x2, w_q).reshape(*lead, w_q.shape[-1])
        return rescale_reference(acc, xs, w_scale, dtype)
    out = kernel_product(x2, w_q, w_t, xs if xs.ndim == 0 else
                         xs.reshape(-1), w_scale, dtype)
    return out.reshape(*lead, w_q.shape[-1])


#: the library's C entry points (``ops/build.py::load``)
ARGTYPES = {"int8_matmul": {
    "int8_matmul_split": [ctypes.c_int] * 3,
    "int8_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "int8_matmul_rescaled": [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}}
