"""Trainers — importing this package registers them (mirrors the
side-effect imports in reference ``train.py:31-46``)."""

from . import base_learner  # noqa: F401
from . import zsclip  # noqa: F401
from . import coop  # noqa: F401
from .calibration import tempscaling  # noqa: F401
