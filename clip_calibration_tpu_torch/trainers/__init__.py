"""Trainers — importing this package registers them (mirrors the
side-effect imports in reference ``train.py:31-46``)."""

from . import base_learner  # noqa: F401
from . import zsclip  # noqa: F401
from . import coop  # noqa: F401
from . import kgcoop  # noqa: F401
from . import maple  # noqa: F401
from . import promptsrc  # noqa: F401
from . import vpt  # noqa: F401
from . import taskres  # noqa: F401
from . import clip_adapter  # noqa: F401
from . import cocoop  # noqa: F401
from . import prograd  # noqa: F401
from . import proda  # noqa: F401
from .calibration import tempscaling  # noqa: F401
from .calibration import parameterized_tempscaling  # noqa: F401
