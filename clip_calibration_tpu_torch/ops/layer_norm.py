"""LayerNorm over the last dimension with fp32 statistics, as the CLIP
towers run it (reference fp16-safe LayerNorm, ``clip/model.py:153-159``):
one CUDA kernel forward and one backward (``csrc/layer_norm.cu``).

``layer_norm`` is a ``torch.autograd.Function`` whose forward launches
``layer_norm_fwd`` and saves x (in its own dtype) with the fp32 mean and
rstd = rsqrt(var + eps) of each row, and whose backward launches
``layer_norm_bwd`` for dx; both are built at first use
(``ops/build.py``). CPU tensors run the plain versions below:
``layer_norm_reference`` is the decomposition the towers ran before the
kernel, op for op, and ``layer_norm_bwd_reference`` the closed form the
backward kernel computes. Any other device raises; nothing falls back.
There is no TPU kernel behind this one: XLA fuses the JAX package's
LayerNorm by itself.

Statistics and arithmetic are fp32 for bf16 and fp32 inputs, fp64 for
fp64 ones (CPU only), and y and dx are rounded once to x's dtype. Kernel
and plain version differ in the order of their fp32 sums only
(tolerances in ``chip_smoke.py``). The scale and shift get a gradient
only where they require one (no trainer trains them): a column sum in
plain PyTorch from the saved statistics, on either device.

The kernels take contiguous rows: a strided view (``ln_post``'s
``x[:, 0]``, ``ln_final``'s unpadded ``x[:, :L]``) is copied first.
"""

from __future__ import annotations

import ctypes

import torch

from ..tools import profiling
from . import build

#: elements a vector load takes: a width must be a multiple of it
VECTOR = 8
#: the widest row the kernels take: 32 lanes x 8 vectors x VECTOR
#: (``csrc/layer_norm.cu``, which refuses wider ones itself)
MAX_WIDTH = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CPU_DTYPES = (torch.bfloat16, torch.float32, torch.float64)


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5):
    """Plain PyTorch version: (y in x's dtype, mean, rstd), mean and rstd
    [..., 1] in fp32 (fp64 for fp64 x)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    return (y * scale.to(xf.dtype) + bias.to(xf.dtype)).to(x.dtype), mean, rstd


def layer_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: dx = rstd (g' - mean(g') -
    xh mean(g' xh)), g' = g scale, xh = (x - mean) rstd, in the statistics'
    dtype, rounded to x's."""
    xh = (x.to(mean.dtype) - mean) * rstd
    gs = g.to(mean.dtype) * scale.to(mean.dtype)
    a = gs.mean(dim=-1, keepdim=True)
    b = (gs * xh).mean(dim=-1, keepdim=True)
    return (rstd * (gs - a - xh * b)).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    if not isinstance(x, torch.Tensor) or x.ndim < 1:
        raise ValueError("layer_norm: x must be a [..., D] tensor")
    D = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.ndim != 1 or t.shape[0] != D:
            raise ValueError(f"layer_norm: {name} must be a [{D}] tensor, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"layer_norm: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"layer_norm runs on cuda or cpu, not {x.device}")
    allowed = _DTYPE_CODES if x.device.type == "cuda" else _CPU_DTYPES
    if x.dtype not in allowed:
        raise TypeError(f"layer_norm on {x.device.type} takes "
                        f"{', '.join(str(d)[6:] for d in allowed)}, got "
                        f"{x.dtype}")
    if D % VECTOR:
        raise ValueError(f"layer_norm: width {D} is not a multiple of "
                         f"{VECTOR} (the kernel's vector loads)")
    if x.device.type == "cuda" and D > MAX_WIDTH:
        raise ValueError(f"layer_norm: width {D} is over the kernel's "
                         f"widest row, {MAX_WIDTH}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous [rows, D] that starts 16-byte aligned (the kernels'
    vector loads): a view where t is one, else a copy."""
    t2 = t.reshape(-1, t.shape[-1]).contiguous()
    return t2 if t2.data_ptr() % 16 == 0 else t2.clone()


def _params(*ts: torch.Tensor):
    out = tuple(t.float().contiguous() for t in ts)
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError("layer_norm: scale and bias must be 16-byte "
                         "aligned (vector loads)")
    return out


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor:
    (y, mean, rstd), mean and rstd [..., 1]."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                       device=x.device)
    rstd = torch.empty_like(mean)
    if y.numel() == 0:
        return y, mean, rstd
    x2 = _rows(x)
    gamma, beta = _params(scale, bias)
    with torch.cuda.device(x.device):
        err = build.load("layer_norm", ARGTYPES).layer_norm_fwd(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), x2.shape[0],
            x2.shape[1], eps, _DTYPE_CODES[x.dtype], build.stream(x))
    build.check("layer_norm_fwd", err)
    layer_norm.launches += 1
    profiling.count("ln.calls", 1)
    return y, mean, rstd


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx for y = layer_norm(x, scale, bias) and the gradient g of y, from
    the forward's mean and rstd: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, scale, mean, rstd, g)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx
    x2, g2 = _rows(x), _rows(g.to(x.dtype))
    (gamma,) = _params(scale)
    with torch.cuda.device(x.device):
        err = build.load("layer_norm", ARGTYPES).layer_norm_bwd(
            x2.data_ptr(), g2.data_ptr(), gamma.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), x2.shape[0],
            x2.shape[1], _DTYPE_CODES[x.dtype], build.stream(x))
    build.check("layer_norm_bwd", err)
    layer_norm_bwd.launches += 1
    profiling.count("ln.calls", 1)
    return dx


class _LayerNorm(torch.autograd.Function):
    """Forward kernel, backward kernel; the scale's and shift's
    gradients, where asked for, as column sums."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = _forward(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dx = layer_norm_bwd(x, scale, mean, rstd, g)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gf = g.to(mean.dtype).reshape(-1, x.shape[-1])
            if ctx.needs_input_grad[1]:
                xh = ((x.to(mean.dtype) - mean) * rstd).reshape(gf.shape)
                dscale = (gf * xh).sum(0).to(scale.dtype)
            if ctx.needs_input_grad[2]:
                dbias = gf.sum(0).to(ctx.bias_dtype)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x [..., D] over D with scale and bias [D], statistics
    in fp32 whatever x's dtype, the result in x's dtype. Differentiable in
    all three."""
    _check(x, scale, bias)
    return _LayerNorm.apply(x, scale, bias, eps)


#: launches of the CUDA kernels since the last reset (CPU calls run the
#: plain versions and do not count)
layer_norm.launches = 0
layer_norm_bwd.launches = 0

#: the library's C entry points (``ops/build.py::load``)
ARGTYPES = {"layer_norm": {
    "layer_norm_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "layer_norm_bwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}}
