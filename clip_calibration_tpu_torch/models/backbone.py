"""CLIP backbone resolution, local-first (no downloads):

1. native npz: ``$CLIP_CHECKPOINT_DIR/<name>.npz`` or
   ``~/.cache/clip/<name>.npz`` (the JAX package's files load as they are)
2. torch checkpoint: same dirs, ``<name>.pt`` (OpenAI naming, e.g.
   ``ViT-B-16.pt``) — converted on the fly
3. seeded random init (loud warning) — keeps tests/demos runnable with no
   weights on disk.

Matmul weights are cast to the run's precision on every route.
"""

from __future__ import annotations

import os
import os.path as osp
import zlib

from ..tools.device import resolve_device
from .clip import CLIP, PRESETS, init_clip
from .weights import (TORCH_DTYPES, load_params, load_torch_clip,
                      params_from_numpy)


def _candidate_names(backbone_name: str):
    """``ViT-B/16`` -> ``ViT-B-16``; ``ViT-L/14@336px`` also matches
    OpenAI's ``ViT-L-14-336px``."""
    safe = backbone_name.replace("/", "-")
    names = [safe]
    if "@" in safe:
        names.append(safe.replace("@", "-"))
    return names


def _search_dirs():
    dirs = []
    env = os.environ.get("CLIP_CHECKPOINT_DIR")
    if env:
        dirs.append(env)
    dirs.append(osp.expanduser("~/.cache/clip"))
    return dirs


def load_clip_backbone(backbone_name: str, dtype_str: str = "bfloat16",
                       device="cuda"):
    """Returns (CLIP module on ``device``, CLIPConfig), frozen."""
    device = resolve_device(device)
    if backbone_name not in PRESETS:
        raise KeyError(f"Unknown backbone {backbone_name!r}; known: "
                       f"{sorted(PRESETS)}")
    cfg = PRESETS[backbone_name]
    dtype = TORCH_DTYPES[dtype_str]

    for d in _search_dirs():
        # every spelling of the npz outranks any .pt
        for fname in _candidate_names(backbone_name):
            npz = osp.join(d, fname + ".npz")
            if osp.exists(npz):
                print(f"Loading CLIP weights from {npz}")
                return params_from_numpy(load_params(npz), cfg, dtype,
                                         device), cfg
        for fname in _candidate_names(backbone_name):
            pt = osp.join(d, fname + ".pt")
            if osp.exists(pt):
                print(f"Converting CLIP torch weights from {pt}")
                model, inferred = load_torch_clip(pt, dtype_str, device)
                if inferred != cfg:
                    print(f"WARNING: {pt} does not match the "
                          f"{backbone_name!r} preset (inferred "
                          f"{inferred}); using the inferred config")
                return model, inferred

    print(f"WARNING: no pretrained weights found for {backbone_name!r} "
          f"(searched {_search_dirs()}); using seeded random init. "
          f"Set CLIP_CHECKPOINT_DIR to point at real weights.")
    seed = zlib.crc32(backbone_name.encode()) % (2 ** 31)
    return init_clip(CLIP(cfg, dtype, device), seed), cfg
