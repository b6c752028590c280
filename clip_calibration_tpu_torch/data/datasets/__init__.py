"""Dataset loaders — importing this package registers them (mirrors the
side-effect imports in reference ``train.py:14-28``)."""

from . import caltech101, synthetic  # noqa: F401
