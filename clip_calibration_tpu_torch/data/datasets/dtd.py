"""Describable Textures loader (reference ``datasets/dtd.py``)."""

from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..base import read_and_split_data, read_split, save_split
from .common import StandardDataset


@DATASET_REGISTRY.register()
class DescribableTextures(StandardDataset):

    dataset_dir = "dtd"

    def __init__(self, cfg):
        self.setup_dirs(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.split_path = os.path.join(
            self.dataset_dir, "split_zhou_DescribableTextures.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = read_and_split_data(self.image_dir)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)
