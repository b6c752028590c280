from .node import CfgNode
from .defaults import get_cfg_default

__all__ = ["CfgNode", "get_cfg_default"]
