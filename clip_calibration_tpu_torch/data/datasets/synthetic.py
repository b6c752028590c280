"""Synthetic dataset for tests and data-free demos.

No reference counterpart (the reference has zero tests and requires real
datasets). Generates small deterministic per-class images — each class is
a distinct color+frequency pattern with sample noise — and materializes
them as PNGs under a cache dir so the standard file-based loader path is
exercised end to end. Follows the standard fewshot->subsample pipeline.
"""

from __future__ import annotations

import os

import numpy as np

from ...engine.registry import DATASET_REGISTRY
from ..base import Datum, mkdir_if_missing
from .common import StandardDataset

N_CLASSES = 10
N_TRAIN, N_VAL, N_TEST = 20, 8, 12
IMG_SIZE = 64

CLASSNAMES = ["red swirl", "green checker", "blue wave", "yellow dot",
              "purple stripe", "orange grid", "cyan blob", "magenta ring",
              "white noise", "dark cross"]

_ADJ = ["pale", "bright", "faded", "deep", "dotted", "striped", "soft",
        "sharp", "coarse", "fine"]


def _dims():
    """Dataset size, overridable via env for scale benchmarking
    (e.g. CC_SYNTH_CLASSES=100 CC_SYNTH_TRAIN=64 python train.py ...).
    Defaults match the test fixtures; different sizes use different
    cache dirs so fixtures never collide."""
    return (int(os.environ.get("CC_SYNTH_CLASSES", N_CLASSES)),
            int(os.environ.get("CC_SYNTH_TRAIN", N_TRAIN)),
            int(os.environ.get("CC_SYNTH_VAL", N_VAL)),
            int(os.environ.get("CC_SYNTH_TEST", N_TEST)))


def _classname(c: int) -> str:
    base = CLASSNAMES[c % len(CLASSNAMES)]
    return base if c < len(CLASSNAMES) else \
        f"{_ADJ[(c // len(CLASSNAMES)) % len(_ADJ)]} {base} {c}"


def _render(class_idx: int, sample_idx: int) -> np.ndarray:
    """Deterministic class pattern + per-sample jitter, uint8 HWC."""
    rng = np.random.default_rng(class_idx * 10007 + sample_idx)
    yy, xx = np.mgrid[0:IMG_SIZE, 0:IMG_SIZE].astype(np.float32) / IMG_SIZE
    freq = 2 + class_idx
    phase = rng.uniform(0, 2 * np.pi)
    base = np.sin(2 * np.pi * freq * xx + phase) * \
        np.cos(2 * np.pi * freq * yy)
    hue = np.array([np.cos(class_idx), np.cos(class_idx + 2),
                    np.cos(class_idx + 4)]) * 0.5 + 0.5
    img = (base[..., None] * 0.5 + 0.5) * hue
    img = img + rng.normal(0, 0.1, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@DATASET_REGISTRY.register()
class Synthetic(StandardDataset):

    dataset_dir = "synthetic"

    def __init__(self, cfg):
        root = cfg.DATASET.ROOT or os.path.join(
            os.path.expanduser("~"), ".cache", "clip_calibration_tpu")
        dims = _dims()
        self.n_classes, self.n_train, self.n_val, self.n_test = dims
        subdir = type(self).dataset_dir
        if dims != (N_CLASSES, N_TRAIN, N_VAL, N_TEST):
            subdir += "_{}x{}_{}_{}".format(*dims)
        self.dataset_dir = os.path.join(os.path.abspath(root), subdir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.split_fewshot_dir = os.path.join(self.dataset_dir,
                                              "split_fewshot")
        mkdir_if_missing(self.split_fewshot_dir)

        self._materialize()
        train = self._items("train", self.n_train, 0)
        val = self._items("val", self.n_val, self.n_train)
        test = self._items("test", self.n_test,
                           self.n_train + self.n_val)
        self.finalize(cfg, train, val, test)

    def _materialize(self):
        from PIL import Image
        done_marker = os.path.join(self.image_dir, ".done")
        if os.path.exists(done_marker):
            return
        mkdir_if_missing(self.image_dir)
        total = self.n_train + self.n_val + self.n_test
        for c in range(self.n_classes):
            cdir = os.path.join(self.image_dir, f"class_{c:02d}")
            mkdir_if_missing(cdir)
            for s in range(total):
                path = os.path.join(cdir, f"img_{s:03d}.png")
                if not os.path.exists(path):
                    Image.fromarray(_render(c, s)).save(path)
        with open(done_marker, "w") as f:
            f.write("ok")

    def _items(self, split, count, offset):
        items = []
        for c in range(self.n_classes):
            cdir = os.path.join(self.image_dir, f"class_{c:02d}")
            for s in range(offset, offset + count):
                items.append(Datum(
                    impath=os.path.join(cdir, f"img_{s:03d}.png"),
                    label=c, classname=_classname(c)))
        return items
