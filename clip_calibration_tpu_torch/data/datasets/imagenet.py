"""ImageNet loader (reference ``datasets/imagenet.py``): classnames.txt
folder->name map, preprocessed.pkl cache, val split used as test."""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict

from ...engine.registry import DATASET_REGISTRY
from ..base import (Datum, DatasetBase, listdir_nohidden, mkdir_if_missing,
                    subsample_classes)


@DATASET_REGISTRY.register()
class ImageNet(DatasetBase):

    dataset_dir = "imagenet"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        self.preprocessed = os.path.join(self.dataset_dir,
                                         "preprocessed.pkl")
        self.split_fewshot_dir = os.path.join(self.dataset_dir,
                                              "split_fewshot")
        mkdir_if_missing(self.split_fewshot_dir)

        if os.path.exists(self.preprocessed):
            with open(self.preprocessed, "rb") as f:
                pre = pickle.load(f)
            train, test = pre["train"], pre["test"]
        else:
            text_file = os.path.join(self.dataset_dir, "classnames.txt")
            classnames = self.read_classnames(text_file)
            train = self.read_data(classnames, "train")
            # standard practice: evaluate on the val set
            test = self.read_data(classnames, "val")
            with open(self.preprocessed, "wb") as f:
                pickle.dump({"train": train, "test": test}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)

        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots >= 1:
            seed = cfg.SEED
            path = os.path.join(self.split_fewshot_dir,
                                f"shot_{num_shots}-seed_{seed}.pkl")
            if os.path.exists(path):
                print(f"Loading preprocessed few-shot data from {path}")
                with open(path, "rb") as f:
                    train = pickle.load(f)["train"]
            else:
                train = self.generate_fewshot_dataset(train,
                                                      num_shots=num_shots)
                print(f"Saving preprocessed few-shot data to {path}")
                with open(path, "wb") as f:
                    pickle.dump({"train": train}, f,
                                protocol=pickle.HIGHEST_PROTOCOL)

        subsample = cfg.DATASET.SUBSAMPLE_CLASSES
        train, test = subsample_classes(train, test, subsample=subsample)
        super().__init__(train_x=train, val=test, test=test)

    @staticmethod
    def read_classnames(text_file):
        """<folder name> -> <class name> map, file order preserved."""
        classnames = OrderedDict()
        with open(text_file) as f:
            for line in f:
                parts = line.strip().split(" ")
                classnames[parts[0]] = " ".join(parts[1:])
        return classnames

    def read_data(self, classnames, split_dir):
        split_dir = os.path.join(self.image_dir, split_dir)
        folders = sorted(f.name for f in os.scandir(split_dir)
                         if f.is_dir())
        items = []
        for label, folder in enumerate(folders):
            classname = classnames[folder]
            for imname in listdir_nohidden(os.path.join(split_dir, folder)):
                items.append(Datum(
                    impath=os.path.join(split_dir, folder, imname),
                    label=label, classname=classname))
        return items
