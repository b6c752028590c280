"""SUN397 loader (reference ``datasets/sun397.py``)."""

from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..base import Datum, read_split, save_split, split_trainval
from .common import StandardDataset


@DATASET_REGISTRY.register()
class SUN397(StandardDataset):

    dataset_dir = "sun397"

    def __init__(self, cfg):
        self.setup_dirs(cfg)
        self.image_dir = os.path.join(self.dataset_dir, "SUN397")
        self.split_path = os.path.join(self.dataset_dir,
                                       "split_zhou_SUN397.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.image_dir)
        else:
            classnames = []
            with open(os.path.join(self.dataset_dir, "ClassName.txt")) as f:
                for line in f:
                    classnames.append(line.strip()[1:])  # remove leading /
            cname2lab = {c: i for i, c in enumerate(classnames)}
            trainval = self.read_data(cname2lab, "Training_01.txt")
            test = self.read_data(cname2lab, "Testing_01.txt")
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.image_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, cname2lab, text_file):
        text_file = os.path.join(self.dataset_dir, text_file)
        items = []
        with open(text_file) as f:
            for line in f:
                imname = line.strip()[1:]  # remove leading /
                classname = os.path.dirname(imname)
                label = cname2lab[classname]
                # "a/abbey" -> "abbey"; "i/indoor/x" -> "x indoor"
                names = classname.split("/")[1:][::-1]
                items.append(Datum(
                    impath=os.path.join(self.image_dir, imname),
                    label=label, classname=" ".join(names)))
        return items
