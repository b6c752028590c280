"""Device-side image normalisation.

Batches arrive as uint8 [B, H, W, 3] on the device; scaling to [0, 1] and
the CLIP mean/std normalisation happen there (reference does this on the
host per image in torchvision, ``clip/clip.py:74-81``).
"""

from __future__ import annotations

import torch

# OpenAI CLIP normalization constants (``clip/clip.py:79``)
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images(images: torch.Tensor, mean=CLIP_PIXEL_MEAN,
                     std=CLIP_PIXEL_STD,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (or float [0,1]) NHWC -> normalized compute-dtype NHWC.

    ``mean=None`` skips the mean/std step (Dassl's pipeline without
    "normalize" in ``INPUT.TRANSFORMS`` is ToTensor only: just /255)."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    if mean is None:
        return x.to(dtype)
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5 (the kernel of
    ``jax.image.resize(method="bicubic")``; ``F.interpolate`` uses
    a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int,
                   device=None) -> torch.Tensor:
    """[in, out] fp32 interpolation matrix of an antialiased Keys-cubic
    resize, step for step ``jax.image``'s ``compute_weight_mat`` (scale
    out/in, no translation): the kernel is widened by in/out when
    downsampling, each output column normalised to sum 1, and samples
    outside the input zeroed."""
    f32 = torch.float32
    # Python floats, rounded to fp32 where they meet a tensor (JAX's weak
    # types do the same)
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]
         ).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(torch.finfo(f32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def device_preprocess(images: torch.Tensor, size: int,
                      mean=CLIP_PIXEL_MEAN, std=CLIP_PIXEL_STD,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Test-time preprocessing on the device: uint8 [B, H, W, 3] at any
    uniform source size -> normalised [B, size, size, 3] in ``dtype``.

    The geometry of the host eval pipeline (``data/transforms.py``:
    shorter side to ``size`` with the long side int-truncated, then the
    center crop), with the resampler of the JAX package's
    ``device_preprocess``: ``jax.image.resize(..., "bicubic",
    antialias=True)``, rebuilt as one [in, out] weight matrix per resized
    axis (``resize_weights``) applied as two fp32 matmuls; an axis
    already at its target size is left alone, as ``jax.image`` does.
    Cubic overshoot is clipped to [0, 1]."""
    b, h, w, c = images.shape
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    if (h, w) != (size, size):
        if w <= h:
            nw, nh = size, max(1, int(h * size / w))
        else:
            nw, nh = max(1, int(w * size / h)), size
        if nh != h:
            wh = resize_weights(h, nh, x.device)
            x = torch.einsum("bhwc,ho->bowc", x, wh)
        if nw != w:
            ww = resize_weights(w, nw, x.device)
            x = torch.einsum("bhwc,wo->bhoc", x, ww)
        left = int(round((nw - size) / 2.0))
        top = int(round((nh - size) / 2.0))
        x = x[:, top:top + size, left:left + size, :]
        x = torch.clamp(x, 0.0, 1.0)
    if mean is None:
        return x.to(dtype)
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def pixel_stats_from_cfg(cfg):
    """(mean, std) for the device-side normalize, honoring the Dassl
    contract: ``Normalize(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)``
    applies only when "normalize" is listed in ``cfg.INPUT.TRANSFORMS``
    (the reference trainer yamls all list it, with the CLIP constants);
    otherwise the pipeline is ToTensor only -> (None, None)."""
    if "normalize" not in tuple(cfg.INPUT.TRANSFORMS):
        return None, None
    return tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
