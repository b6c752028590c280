"""OxfordPets loader (reference ``datasets/oxford_pets.py:11-75``)."""

from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..base import Datum, read_split, save_split, split_trainval
from .common import StandardDataset


@DATASET_REGISTRY.register()
class OxfordPets(StandardDataset):

    dataset_dir = "oxford_pets"

    def __init__(self, cfg):
        self.setup_dirs(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.anno_dir = os.path.join(self.dataset_dir, "annotations")
        self.split_path = os.path.join(self.dataset_dir,
                                       "split_zhou_OxfordPets.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            trainval = self.read_data("trainval.txt")
            test = self.read_data("test.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, split_file):
        filepath = os.path.join(self.anno_dir, split_file)
        items = []
        with open(filepath, "r") as f:
            for line in f:
                imname, label, _species, _ = line.strip().split(" ")
                breed = "_".join(imname.split("_")[:-1]).lower()
                items.append(Datum(
                    impath=os.path.join(self.image_dir, imname + ".jpg"),
                    label=int(label) - 1,
                    classname=breed))
        return items
