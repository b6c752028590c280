"""ImageNet distribution-shift test sets: V2, Sketch, A, R.

Reference: ``datasets/imagenetv2.py``, ``imagenet_sketch.py``,
``imagenet_a.py``, ``imagenet_r.py`` — all test-only loaders for
cross-dataset evaluation.
"""

from __future__ import annotations

import os

from ...engine.registry import DATASET_REGISTRY
from ..base import Datum, DatasetBase, listdir_nohidden
from .imagenet import ImageNet


def _read_folder_data(image_dir, classnames, ignored=()):
    """Folder-per-wnid tree -> Datum list, labels by sorted folder order."""
    folders = [f for f in listdir_nohidden(image_dir, sort=True)
               if f not in ignored]
    items = []
    for label, folder in enumerate(folders):
        classname = classnames[folder]
        for imname in listdir_nohidden(os.path.join(image_dir, folder)):
            items.append(Datum(
                impath=os.path.join(image_dir, folder, imname),
                label=label, classname=classname))
    return items


@DATASET_REGISTRY.register()
class ImageNetV2(DatasetBase):
    """Test-only; folders named by numeric label 0..999."""

    dataset_dir = "imagenetv2"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(
            self.dataset_dir, "imagenetv2-matched-frequency-format-val")
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        folders = list(classnames.keys())
        items = []
        for label in range(1000):
            class_dir = os.path.join(self.image_dir, str(label))
            classname = classnames[folders[label]]
            for imname in listdir_nohidden(class_dir):
                items.append(Datum(
                    impath=os.path.join(class_dir, imname),
                    label=label, classname=classname))
        super().__init__(train_x=items, test=items)


@DATASET_REGISTRY.register()
class ImageNetSketch(DatasetBase):
    """Test-only; full 1000-class sketch renditions."""

    dataset_dir = "imagenet-sketch"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        items = _read_folder_data(self.image_dir, classnames)
        super().__init__(train_x=items, test=items)


@DATASET_REGISTRY.register()
class ImageNetA(DatasetBase):
    """Test-only; 200-class natural adversarial examples."""

    dataset_dir = "imagenet-adversarial"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "imagenet-a")
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        items = _read_folder_data(self.image_dir, classnames,
                                  ignored=("README.txt",))
        super().__init__(train_x=items, test=items)


@DATASET_REGISTRY.register()
class ImageNetR(DatasetBase):
    """Test-only; 200-class renditions."""

    dataset_dir = "imagenet-rendition"

    def __init__(self, cfg):
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.image_dir = os.path.join(self.dataset_dir, "imagenet-r")
        text_file = os.path.join(self.dataset_dir, "classnames.txt")
        classnames = ImageNet.read_classnames(text_file)
        items = _read_folder_data(self.image_dir, classnames,
                                  ignored=("README.txt",))
        super().__init__(train_x=items, test=items)
