"""Shared loader pipeline.

Every fine-grained loader in the reference repeats the same tail
(``datasets/caltech101.py:38-63`` etc.): few-shot sample with pickle cache,
then base/new subsample. Factored here once.
"""

from __future__ import annotations

import os

from ..base import DatasetBase, mkdir_if_missing, subsample_classes


class StandardDataset(DatasetBase):
    """Base for loaders following the standard split->fewshot->subsample
    pipeline."""

    dataset_dir = ""

    def setup_dirs(self, cfg) -> str:
        root = os.path.abspath(os.path.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = os.path.join(root, type(self).dataset_dir)
        self.split_fewshot_dir = os.path.join(self.dataset_dir,
                                              "split_fewshot")
        mkdir_if_missing(self.split_fewshot_dir)
        return root

    def finalize(self, cfg, train, val, test):
        train, val = self.fewshot_with_cache(train, val, cfg)
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES)
        super().__init__(train_x=train, val=val, test=test)
