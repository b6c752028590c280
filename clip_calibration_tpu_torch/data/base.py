"""Dataset primitives: Datum, DatasetBase, split helpers.

Clean-room equivalents of the Dassl dataset layer as consumed by the
reference loaders (reference ``datasets/oxford_pets.py``):

- ``Datum(impath, label, classname)`` sample records,
- deterministic 80/20 trainval split, split JSON persistence,
- few-shot sampling with per-(shots, seed) pickle caching (uses the global
  ``random`` module, matching Dassl's seeding contract via
  ``set_random_seed``),
- ``subsample_classes`` — the open-vocabulary base/new split: sorted labels,
  first ceil(n/2) = base, rest = new, with relabeling
  (``oxford_pets.py:140-186``),
- ``read_and_split_data`` 50/20/30 folder splitter (``dtd.py:54-101``).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


def mkdir_if_missing(dirname: str) -> None:
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname, exist_ok=True)


def read_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def write_json(obj, path: str) -> None:
    mkdir_if_missing(os.path.dirname(path))
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


def listdir_nohidden(path: str, sort: bool = True) -> List[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


class Datum:
    """A single data sample: image path, integer label, class name."""

    __slots__ = ("impath", "label", "classname")

    def __init__(self, impath: str = "", label: int = 0,
                 classname: str = ""):
        self.impath = impath
        self.label = label
        self.classname = classname

    def __repr__(self):
        return (f"Datum(impath={self.impath!r}, label={self.label}, "
                f"classname={self.classname!r})")


class DatasetBase:
    """Holds train_x/val/test item lists and derived class metadata."""

    dataset_dir = ""

    def __init__(self, train_x=None, val=None, test=None):
        self.train_x: List[Datum] = train_x or []
        self.val: List[Datum] = val if val is not None else []
        self.test: List[Datum] = test if test is not None else []

        scan = self.train_x or self.test
        self.num_classes = max((item.label for item in scan), default=-1) + 1
        mapping = {}
        for item in scan:
            mapping[item.label] = item.classname
        self.lab2cname: Dict[int, str] = {
            label: mapping[label] for label in sorted(mapping)}
        self.classnames: List[str] = [self.lab2cname[label]
                                      for label in sorted(self.lab2cname)]

    # -- few-shot sampling ------------------------------------------------------
    @staticmethod
    def split_dataset_by_label(data_source: Sequence[Datum]):
        tracker = defaultdict(list)
        for item in data_source:
            tracker[item.label].append(item)
        return tracker

    def generate_fewshot_dataset(self, data_source: Sequence[Datum],
                                 num_shots: int = -1,
                                 repeat: bool = False) -> List[Datum]:
        """Sample num_shots items per class via the global ``random`` module
        (Dassl semantics: reproducible under set_random_seed)."""
        if num_shots < 1:
            return list(data_source)
        print(f"Creating a {num_shots}-shot dataset")
        tracker = self.split_dataset_by_label(data_source)
        out: List[Datum] = []
        for label, items in tracker.items():
            if len(items) >= num_shots:
                sampled = random.sample(items, num_shots)
            elif repeat:
                sampled = random.choices(items, k=num_shots)
            else:
                sampled = items
            out.extend(sampled)
        return out

    def fewshot_with_cache(self, train, val, cfg, cap_val: bool = True):
        """Few-shot sample train/val with the per-(shots, seed) pickle cache
        every reference loader uses (``oxford_pets.py:33-49``)."""
        num_shots = cfg.DATASET.NUM_SHOTS
        if num_shots < 1:
            return train, val
        seed = cfg.SEED
        cache_dir = getattr(self, "split_fewshot_dir", None)
        path = (os.path.join(cache_dir, f"shot_{num_shots}-seed_{seed}.pkl")
                if cache_dir else None)
        if path and os.path.exists(path):
            print(f"Loading preprocessed few-shot data from {path}")
            with open(path, "rb") as f:
                data = pickle.load(f)
            return data["train"], data["val"]
        train = self.generate_fewshot_dataset(train, num_shots=num_shots)
        if val is not None:
            cap = min(num_shots, 4) if cap_val else num_shots
            val = self.generate_fewshot_dataset(val, num_shots=cap)
        if path:
            print(f"Saving preprocessed few-shot data to {path}")
            mkdir_if_missing(os.path.dirname(path))
            with open(path, "wb") as f:
                pickle.dump({"train": train, "val": val}, f,
                            protocol=pickle.HIGHEST_PROTOCOL)
        return train, val


# ---------------------------------------------------------------------------
# splits (static helpers shared across loaders)
# ---------------------------------------------------------------------------

def split_trainval(trainval: Sequence[Datum], p_val: float = 0.2):
    """Per-class 80/20 shuffled split (``oxford_pets.py:77-98``)."""
    p_trn = 1 - p_val
    print(f"Splitting trainval into {p_trn:.0%} train and {p_val:.0%} val")
    tracker = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item.label].append(idx)
    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            (val if n < n_val else train).append(trainval[idx])
    return train, val


def save_split(train, val, test, filepath: str, path_prefix: str) -> None:
    def _extract(items):
        out = []
        for item in items:
            impath = item.impath.replace(path_prefix, "")
            if impath.startswith("/"):
                impath = impath[1:]
            out.append((impath, item.label, item.classname))
        return out

    split = {"train": _extract(train), "val": _extract(val),
             "test": _extract(test)}
    write_json(split, filepath)
    print(f"Saved split to {filepath}")


def read_split(filepath: str, path_prefix: str):
    def _convert(items):
        return [Datum(impath=os.path.join(path_prefix, impath),
                      label=int(label), classname=classname)
                for impath, label, classname in items]

    print(f"Reading split from {filepath}")
    split = read_json(filepath)
    return (_convert(split["train"]), _convert(split["val"]),
            _convert(split["test"]))


def subsample_classes(*args, subsample: str = "all"):
    """Open-vocabulary base/new class split with relabeling
    (``oxford_pets.py:140-186``)."""
    assert subsample in ("all", "base", "new")
    if subsample == "all":
        return args

    labels = sorted({item.label for item in args[0]})
    m = math.ceil(len(labels) / 2)
    print(f"SUBSAMPLE {subsample.upper()} CLASSES!")
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabeler = {y: y_new for y_new, y in enumerate(selected)}
    sel = set(selected)

    output = []
    for dataset in args:
        output.append([
            Datum(impath=item.impath, label=relabeler[item.label],
                  classname=item.classname)
            for item in dataset if item.label in sel])
    return output


def read_and_split_data(image_dir: str, p_trn: float = 0.5,
                        p_val: float = 0.2,
                        ignored: Optional[Sequence[str]] = None,
                        new_cnames: Optional[Dict[str, str]] = None):
    """50/20/30 split over a folder-per-class tree (``dtd.py:54-101``)."""
    ignored = set(ignored or [])
    categories = [c for c in listdir_nohidden(image_dir)
                  if c not in ignored]
    categories.sort()

    p_tst = 1 - p_trn - p_val
    print(f"Splitting into {p_trn:.0%} train, {p_val:.0%} val, and "
          f"{p_tst:.0%} test")

    def _collate(ims, y, c):
        return [Datum(impath=im, label=y, classname=c) for im in ims]

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        category_dir = os.path.join(image_dir, category)
        images = [os.path.join(category_dir, im)
                  for im in listdir_nohidden(category_dir)]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        assert n_train > 0 and n_val > 0 and n_total - n_train - n_val > 0
        if new_cnames is not None and category in new_cnames:
            category = new_cnames[category]
        train.extend(_collate(images[:n_train], label, category))
        val.extend(_collate(images[n_train:n_train + n_val], label,
                            category))
        test.extend(_collate(images[n_train + n_val:], label, category))
    return train, val, test


def set_random_seed(seed: int) -> None:
    """Seed python + numpy + torch RNGs (Dassl set_random_seed
    equivalent; the port's own generators take explicit seeds)."""
    import numpy as np
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
