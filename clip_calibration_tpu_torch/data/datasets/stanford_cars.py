"""Stanford Cars loader (reference ``datasets/stanford_cars.py``)."""

from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..base import Datum, read_split, save_split, split_trainval
from .common import StandardDataset


@DATASET_REGISTRY.register()
class StanfordCars(StandardDataset):

    dataset_dir = "stanford_cars"

    def __init__(self, cfg):
        self.setup_dirs(cfg)
        self.split_path = os.path.join(self.dataset_dir,
                                       "split_zhou_StanfordCars.json")

        if os.path.exists(self.split_path):
            train, val, test = read_split(self.split_path, self.dataset_dir)
        else:
            trainval_file = os.path.join(self.dataset_dir, "devkit",
                                         "cars_train_annos.mat")
            test_file = os.path.join(self.dataset_dir,
                                     "cars_test_annos_withlabels.mat")
            meta_file = os.path.join(self.dataset_dir, "devkit",
                                     "cars_meta.mat")
            trainval = self.read_data("cars_train", trainval_file, meta_file)
            test = self.read_data("cars_test", test_file, meta_file)
            train, val = split_trainval(trainval)
            save_split(train, val, test, self.split_path, self.dataset_dir)

        self.finalize(cfg, train, val, test)

    def read_data(self, image_dir, anno_file, meta_file):
        from scipy.io import loadmat
        annos = loadmat(anno_file)["annotations"][0]
        meta = loadmat(meta_file)["class_names"][0]
        items = []
        for i in range(len(annos)):
            imname = annos[i]["fname"][0]
            label = int(annos[i]["class"][0, 0]) - 1
            classname = meta[label][0]
            # move the year to the front ("2012 Tesla Model S")
            names = classname.split(" ")
            year = names.pop(-1)
            names.insert(0, year)
            classname = " ".join(names)
            items.append(Datum(
                impath=os.path.join(self.dataset_dir, image_dir, imname),
                label=label, classname=classname))
        return items
