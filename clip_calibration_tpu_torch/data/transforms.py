"""Host-side image transforms.

Geometry (resize / crop / flip) runs on host PIL per sample; photometric
normalization runs ON DEVICE in the jit'd step (see ``ops/preprocess.py``)
so batches cross PCIe as uint8 — 4x fewer H2D bytes than the reference's
fp32 CHW tensors (torchvision pipeline, ``clip/clip.py:74-81``).

Semantics match torchvision: bicubic shorter-side resize + center crop for
eval; RandomResizedCrop(scale, ratio 3/4..4/3, 10 attempts) + horizontal
flip for training (Dassl's ``random_resized_crop``/``random_flip``).

Train transforms draw from a ``random.Random`` the caller passes in, one
per item (``data/loader.py`` seeds it from the loader seed, the epoch and
the item's place in the epoch order), so a batch's pixels never depend on
which worker thread ran which item. Eval transforms draw nothing.
"""

from __future__ import annotations

import random
from typing import Callable, Optional, Tuple

import numpy as np
from PIL import Image

_PIL_INTERP = {
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "nearest": Image.NEAREST,
}


def _resize_shorter(img: Image.Image, size: int, interp) -> Image.Image:
    w, h = img.size
    # torchvision truncates the long side (int(size * long / short),
    # _compute_resized_output_size) — round() differs on ~half of
    # non-square images by one pixel
    if w <= h:
        nw, nh = size, max(1, int(h * size / w))
    else:
        nw, nh = max(1, int(w * size / h)), size
    return img.resize((nw, nh), interp)


def _center_crop(img: Image.Image, size: Tuple[int, int]) -> Image.Image:
    w, h = img.size
    th, tw = size
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


def _random_resized_crop(img: Image.Image, size: Tuple[int, int],
                         scale: Tuple[float, float], interp,
                         rng: random.Random) -> Image.Image:
    """torchvision RandomResizedCrop: sample area in ``scale`` x img area,
    aspect in log-uniform [3/4, 4/3]; 10 attempts then center fallback."""
    w, h = img.size
    area = w * h
    log_ratio = (np.log(3 / 4), np.log(4 / 3))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            img = img.crop((left, top, left + cw, top + ch))
            return img.resize((size[1], size[0]), interp)
    # fallback: center crop to the constrained aspect; torchvision uses
    # floor-div offsets here (unlike CenterCrop's round)
    in_ratio = w / h
    if in_ratio < 3 / 4:
        cw, ch = w, int(round(w / (3 / 4)))
    elif in_ratio > 4 / 3:
        cw, ch = int(round(h * 4 / 3)), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    img = img.crop((left, top, left + cw, top + ch))
    return img.resize((size[1], size[0]), interp)


def build_transform(cfg, is_train: bool) -> Callable[..., np.ndarray]:
    """Returns the (PIL.Image, rng) -> uint8 [H, W, 3] transform; ``rng``
    (a ``random.Random``) is required for train transforms and unused by
    eval ones."""
    size = tuple(cfg.INPUT.SIZE)
    interp = _PIL_INTERP[cfg.INPUT.INTERPOLATION]
    transforms = tuple(cfg.INPUT.TRANSFORMS)
    scale = tuple(cfg.INPUT.RRCROP_SCALE)

    known = {"random_resized_crop", "random_flip", "normalize"}
    unknown = set(transforms) - known
    if unknown:
        # silently substituting a different pipeline would train on
        # different pixels than the (Dassl) reference with no diagnostic
        raise ValueError(
            f"Unsupported INPUT.TRANSFORMS {sorted(unknown)}; "
            f"supported: {sorted(known)}")

    use_rrc = is_train and "random_resized_crop" in transforms
    use_flip = is_train and "random_flip" in transforms

    def apply(img: Image.Image,
              rng: Optional[random.Random] = None) -> np.ndarray:
        if (use_rrc or use_flip) and rng is None:
            raise ValueError("a train transform needs its random.Random")
        img = img.convert("RGB")
        if use_rrc:
            img = _random_resized_crop(img, size, scale, interp, rng)
        elif is_train:
            # Dassl's train pipeline without random_resized_crop squash-
            # resizes the full image to INPUT.SIZE (no crop)
            img = img.resize((size[1], size[0]), interp)
        else:
            # Dassl test pipeline: shorter side to max(INPUT.SIZE),
            # then center-crop to INPUT.SIZE
            img = _resize_shorter(img, max(size), interp)
            img = _center_crop(img, size)
        if use_flip and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(img, dtype=np.uint8)

    return apply
