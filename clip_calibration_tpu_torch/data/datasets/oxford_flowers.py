"""Oxford Flowers loader (reference ``datasets/oxford_flowers.py``)."""

from __future__ import annotations

import os
import random
from collections import defaultdict

from ...engine.registry import DATASET_REGISTRY
from ..base import Datum, read_json, read_split, save_split
from .common import StandardDataset


@DATASET_REGISTRY.register()
class OxfordFlowers(StandardDataset):

    dataset_dir = "oxford_flowers"

    def __init__(self, cfg):
        self.setup_dirs(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "jpg")
        self.label_file = os.path.join(self.dataset_dir, "imagelabels.mat")
        self.lab2cname_file = os.path.join(self.dataset_dir,
                                           "cat_to_name.json")
        self.split_path = os.path.join(self.dataset_dir,
                                       "split_zhou_OxfordFlowers.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            train, val, test = self.read_data()
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self):
        from scipy.io import loadmat
        tracker = defaultdict(list)
        label_file = loadmat(self.label_file)["labels"][0]
        for i, label in enumerate(label_file):
            imname = f"image_{str(i + 1).zfill(5)}.jpg"
            tracker[int(label)].append(
                os.path.join(self.image_dir, imname))

        print("Splitting data into 50% train, 20% val, and 30% test")

        def _collate(ims, y, c):
            # 1-based mat labels -> 0-based
            return [Datum(impath=im, label=y - 1, classname=c)
                    for im in ims]

        lab2cname = read_json(self.lab2cname_file)
        train, val, test = [], [], []
        for label, impaths in tracker.items():
            random.shuffle(impaths)
            n_total = len(impaths)
            n_train = round(n_total * 0.5)
            n_val = round(n_total * 0.2)
            assert n_train > 0 and n_val > 0 and \
                n_total - n_train - n_val > 0
            cname = lab2cname[str(label)]
            train.extend(_collate(impaths[:n_train], label, cname))
            val.extend(_collate(impaths[n_train:n_train + n_val], label,
                                cname))
            test.extend(_collate(impaths[n_train + n_val:], label, cname))
        return train, val, test
