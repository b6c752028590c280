"""Multi-head attention over a packed QKV tensor with int8 score and PV
products (kernel K4), in three variants.

``int8_attention`` replaces ``benchmarks/probe_int8_attention.py``'s
``_attn`` (its ``_kernel``): on a CUDA tensor it launches K4
(``csrc/int8_attention.cu``, built at first use by ``ops/build.py``); on a
CPU tensor it runs the plain version ``int8_attention_reference``. Any
other input raises. The kernel takes bf16 qkv, the only type the probe
runs, and head dims 32 and 64.

Variants (per batch row and head, q, k, v the head's [L, d] slices):

- ``fp32_scores``: ``softmax((q * scale) k^T + mask)``, q scaled in qkv's
  dtype (the scale rounded to it too), fp32 scores; P rounded to qkv's
  dtype, then P v with fp32 sums.
- ``int8_qk``: q (scaled in fp32) and k quantized per row
  (``quantize_rows``), ``si = qi ki^T`` summed in integers, scores
  ``si * (sq * sk^T) + mask`` in that order; softmax and P v as above.
- ``int8_qk_pv``: as ``int8_qk``, then the normalised P rounded to
  ``round(p * 127)`` and v quantized per column over all L keys
  (``sv = max|v| / 127 + 1e-30``), ``oi = pi vi`` in integers, the output
  ``oi * (sv / 127)``.

The output is cast to qkv's dtype. Rounding is half to even everywhere,
as ``jnp.round``.
"""

from __future__ import annotations

import ctypes

import torch

VARIANTS = ("fp32_scores", "int8_qk", "int8_qk_pv")
#: head dims the CUDA kernel is compiled for (ViT-B/16 and every larger
#: CLIP preset: 64)
KERNEL_HEAD_DIMS = (32, 64)
#: the int32 sums of the PV product reach L * 127^2, which must stay exact
#: in fp32 (< 2^24) where the kernel converts them
MAX_KERNEL_LEN = 1024


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can differ in the last
    bit."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def quantize_rows(x: torch.Tensor, eps: float = 1e-30):
    """Per-row symmetric int8 quantization of fp32 ``x [..., d]``:
    ``s = max|x| / 127 + eps``, ``round(x / s)``. Returns (int8, fp32
    scale [..., 1])."""
    s = _div127(x.abs().amax(dim=-1, keepdim=True)) + eps
    return torch.round(x / s).to(torch.int8), s


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of int8 operands, as fp32: int64 sums on the CPU;
    float64 on the card, where ``torch.matmul`` takes no integer types
    (exact while the sums stay below 2^53)."""
    if a.device.type == "cpu":
        return (a.long() @ b.long()).float()
    return (a.double() @ b.double()).float()


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s order: exp(s - max), divided by its sum."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def int8_attention_reference(qkv: torch.Tensor, mask: torch.Tensor,
                             n_heads: int, variant: str) -> torch.Tensor:
    """Plain PyTorch version, operation for operation as the TPU kernel;
    all heads at once."""
    B, L, D3 = qkv.shape
    D = D3 // 3
    d = D // n_heads
    scale = 1.0 / d ** 0.5
    q, k, v = (t.reshape(B, L, n_heads, d).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    if variant == "fp32_scores":
        qs = q * torch.tensor(scale, dtype=qkv.dtype)
        s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) + mask
    else:
        qi, sq = quantize_rows(q.float() * scale)
        ki, sk = quantize_rows(k.float())
        si = _int_matmul(qi, ki.transpose(-1, -2))
        s = si * (sq * sk.transpose(-1, -2)) + mask
    p = _softmax(s)
    if variant == "int8_qk_pv":
        pi = torch.round(p * 127.0).to(torch.int8)
        vf = v.float()
        sv = _div127(vf.abs().amax(dim=-2, keepdim=True)) + 1e-30
        vi = torch.round(vf / sv).to(torch.int8)
        o = _int_matmul(pi, vi) * _div127(sv)
    else:
        o = torch.matmul(p.to(qkv.dtype).float(), v.float())
    return o.to(qkv.dtype).transpose(1, 2).reshape(B, L, D)


def _check(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
           variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if not isinstance(qkv, torch.Tensor) or qkv.ndim != 3:
        raise ValueError("qkv must be a [B, L, 3D] tensor")
    B, L, D3 = qkv.shape
    if D3 % 3 or (D3 // 3) % n_heads:
        raise ValueError(f"qkv width {D3} is not 3 x a multiple of "
                         f"n_heads={n_heads}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != (L, L):
        raise ValueError(f"mask must be float32 [{L}, {L}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != qkv.device:
        raise ValueError(f"mask on {mask.device}, qkv on {qkv.device}")
    if not (qkv.is_contiguous() and mask.is_contiguous()):
        raise ValueError("qkv and mask must be contiguous")
    if qkv.device.type == "cpu":
        if not qkv.is_floating_point():
            raise TypeError(f"qkv must be floating point, got {qkv.dtype}")
        return
    if qkv.device.type != "cuda":
        raise ValueError(f"int8_attention runs on cuda or cpu, not "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 qkv, got {qkv.dtype}")
    if D3 // 3 // n_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D3 // 3 // n_heads} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if L > MAX_KERNEL_LEN:
        raise ValueError(f"L = {L} > {MAX_KERNEL_LEN}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned (vector loads)")


def int8_attention(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
                   variant: str) -> torch.Tensor:
    """qkv [B, L, 3D] (head h of q/k/v at columns h*d, D+h*d, 2D+h*d),
    mask [L, L] additive fp32 -> [B, L, D] in qkv's dtype, heads
    concatenated."""
    _check(qkv, mask, n_heads, variant)
    if qkv.device.type == "cpu":
        return int8_attention_reference(qkv, mask, n_heads, variant)
    B, L, D3 = qkv.shape
    out = torch.empty((B, L, D3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _library().int8_attention(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), B, L, D3 // 3,
            n_heads, VARIANTS.index(variant),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_attention launch failed: cudaError_t {err}")
    int8_attention.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (CPU calls run the
#: plain version and do not count)
int8_attention.launches = 0


def _library() -> ctypes.CDLL:
    from . import build
    lib = build.load("int8_attention")
    if lib.int8_attention.argtypes is None:
        lib.int8_attention.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.int8_attention.restype = ctypes.c_int
    return lib
