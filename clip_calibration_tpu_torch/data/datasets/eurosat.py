"""EuroSAT loader (reference ``datasets/eurosat.py``)."""

from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..base import read_and_split_data, read_split, save_split
from .common import StandardDataset

NEW_CNAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


@DATASET_REGISTRY.register()
class EuroSAT(StandardDataset):

    dataset_dir = "eurosat"

    def __init__(self, cfg):
        self.setup_dirs(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "2750")
        self.split_path = os.path.join(self.dataset_dir,
                                       "split_zhou_EuroSAT.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = read_and_split_data(
                self.image_dir, new_cnames=NEW_CNAMES)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)
