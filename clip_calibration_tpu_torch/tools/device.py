"""Device selection: every entry point names its device, default ``cuda``.

There is no probe that falls back to the CPU: asking for ``cuda``
without a usable card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # a concrete index, so tensors' devices compare equal to it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
