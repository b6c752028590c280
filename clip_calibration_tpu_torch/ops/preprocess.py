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


def pixel_stats_from_cfg(cfg):
    """(mean, std) for the device-side normalize, honoring the Dassl
    contract: ``Normalize(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)``
    applies only when "normalize" is listed in ``cfg.INPUT.TRANSFORMS``
    (the reference trainer yamls all list it, with the CLIP constants);
    otherwise the pipeline is ToTensor only -> (None, None)."""
    if "normalize" not in tuple(cfg.INPUT.TRANSFORMS):
        return None, None
    return tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
