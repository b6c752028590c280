"""Checkpoint I/O, in the JAX package's formats.

Layout matches the reference scripts
(reference ``trainers/classification/coop.py:318-343``):
``<output>/<model-name>/model.pth.tar-<epoch>`` plus ``model-best.pth.tar``.
Native content is an npz payload (flat ``/``-joined param keys, bf16 as a
``B::``-prefixed uint16 view, ``__epoch__``, and the optimizer state as
optax-ordered leaves under ``__opt__::<i>`` / ``__opt__::B::<i>``, see
``engine/optim.py::opt_state_leaves``), so a checkpoint written by either
package, optimizer state included, resumes in the other; genuine torch
``.pth.tar`` prompt checkpoints of the reference load too, and
``export_torch_checkpoint`` writes them.
"""

from __future__ import annotations

import io
import os
import os.path as osp
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.weights import to_tensor


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = v
    return out


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _cpu(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return to_tensor(v)


def _npz_array(t: torch.Tensor) -> tuple:
    """(key prefix, numpy array): bf16 as a "B::"-prefixed uint16 view."""
    if t.dtype == torch.bfloat16:
        return "B::", t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def save_checkpoint(state: Dict[str, Any], save_dir: str, epoch: int,
                    is_best: bool = False, model_name: str = "model") -> str:
    """state: {"state_dict": nested dict of tensors/arrays, "epoch": int,
    "opt_leaves": optional list of optimizer-state tensors}."""
    os.makedirs(save_dir, exist_ok=True)
    arrays = {}
    for k, v in flatten_params(state["state_dict"]).items():
        prefix, a = _npz_array(_cpu(v))
        arrays[prefix + k] = a
    arrays["__epoch__"] = np.asarray(state.get("epoch", epoch))
    for i, leaf in enumerate(state.get("opt_leaves") or []):
        prefix, a = _npz_array(_cpu(leaf))
        arrays[f"__opt__::{prefix}{i}"] = a
    fpath = osp.join(save_dir, f"{model_name}.pth.tar-{epoch}")
    # np.savez appends .npz to string paths; write through a file object
    paths = [fpath] + ([osp.join(save_dir, f"{model_name}-best.pth.tar")]
                       if is_best else [])
    for path in paths:
        with open(path, "wb") as f:
            np.savez(f, **arrays)
    return fpath


def export_torch_checkpoint(state_dict: Dict[str, Any], epoch: int,
                            dst_path: str) -> str:
    """Write a reference-consumable torch ``.pth.tar``: a nested dict
    becomes a dotted-key fp32 tensor state dict inside
    ``{"state_dict", "epoch"}`` (what Dassl's ``load_checkpoint`` +
    ``load_state_dict(strict=False)`` consume, reference
    ``coop.py:330-343``)."""
    os.makedirs(osp.dirname(dst_path) or ".", exist_ok=True)
    sd = {}
    for k, v in flatten_params(state_dict).items():
        t = _cpu(v)
        if t.is_floating_point():
            t = t.float()
        elif t.dtype not in (torch.bool, torch.uint8, torch.int8,
                             torch.int16, torch.int32, torch.int64):
            raise TypeError(f"export_torch_checkpoint: unexpected dtype "
                            f"{t.dtype} for leaf {k!r}")
        sd[k.replace("/", ".")] = t.clone()
    torch.save({"state_dict": sd, "epoch": int(epoch)}, dst_path)
    return dst_path


def load_checkpoint(fpath: str) -> Dict[str, Any]:
    """Load a native npz checkpoint or a reference torch .pth.tar; the
    ``"native"`` key says which. Leaves come back as CPU tensors."""
    if not osp.exists(fpath):
        raise FileNotFoundError(f'Checkpoint not found at "{fpath}"')
    try:
        return _load_npz(fpath)
    except (ValueError, OSError):
        return _load_torch(fpath)


def _load_npz(fpath: str) -> Dict[str, Any]:
    def tensor(a, bf16):
        if bf16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    with open(fpath, "rb") as f:
        data = np.load(io.BytesIO(f.read()), allow_pickle=False)
        if "__epoch__" not in data.files:
            # torch zip archives also open as (empty) npz — not ours
            raise ValueError(f"{fpath} is not a native npz checkpoint")
        flat = {}
        epoch = 0
        opt_leaves: Dict[int, torch.Tensor] = {}
        for k in data.files:
            if k == "__epoch__":
                epoch = int(data[k])
            elif k.startswith("__opt__::B::"):
                opt_leaves[int(k[12:])] = tensor(data[k], True)
            elif k.startswith("__opt__::"):
                opt_leaves[int(k[9:])] = tensor(data[k], False)
            elif k.startswith("B::"):
                flat[k[3:]] = tensor(data[k], True)
            else:
                flat[k] = tensor(data[k], False)
    out = {"state_dict": unflatten_params(flat), "epoch": epoch,
           "native": True}
    if opt_leaves:
        out["opt_leaves"] = [opt_leaves[i] for i in range(len(opt_leaves))]
    return out


def _load_torch(fpath: str) -> Dict[str, Any]:
    """Read a reference torch checkpoint ({'state_dict', 'epoch', ...})."""
    ckpt = torch.load(fpath, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    flat = {k.replace(".", "/"): v.detach().float() for k, v in sd.items()}
    return {"state_dict": unflatten_params(flat),
            "epoch": int(ckpt.get("epoch", 0)), "native": False}


def resolve_model_file(directory: str, epoch: Optional[int] = None,
                       model_name: str = "model",
                       latest: bool = False) -> str:
    """model.pth.tar-<epoch> when given, else model-best, else the
    highest-epoch file (reference ``coop.py:312-343`` semantics).

    ``latest=True`` skips the model-best preference and returns the
    highest-epoch periodic checkpoint (the resume semantics: resuming a
    best_val run from model-best would rewind past the epochs trained
    after it), falling back to model-best when there is none yet."""
    if epoch is not None:
        path = osp.join(directory, f"{model_name}.pth.tar-{epoch}")
        if not osp.exists(path):
            raise FileNotFoundError(f'Checkpoint not found at "{path}"')
        return path
    best = osp.join(directory, f"{model_name}-best.pth.tar")
    if not latest and osp.exists(best):
        return best
    cands = [f for f in os.listdir(directory)
             if f.startswith(f"{model_name}.pth.tar-")]
    if not cands:
        if latest and osp.exists(best):
            return best
        raise FileNotFoundError(
            f"No checkpoint under {directory!r} for {model_name!r}")
    cands.sort(key=lambda f: int(f.rsplit("-", 1)[1]))
    return osp.join(directory, cands[-1])
