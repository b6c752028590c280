"""KNN feature-space distances for proximity-based calibration.

Parity target: reference ``trainers/calibration/proximity.py``. Each
chunk of queries is one distance matrix (a matmul in the d^2 expansion)
plus ``torch.topk(largest=False)`` on the device, so a huge test set never
materialises the whole [N_test, N_base] matrix at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ...tools import profiling
from ...tools.device import resolve_device


def _knn_chunk(queries: torch.Tensor, base: torch.Tensor,
               k: int) -> torch.Tensor:
    """Smallest k L2 distances from each query row to base rows."""
    d2 = ((queries ** 2).sum(-1)[:, None] + (base ** 2).sum(-1)[None, :]
          - 2.0 * queries @ base.T)
    d2 = torch.clamp(d2, min=0.0)
    return torch.sqrt(torch.topk(d2, k, dim=1, largest=False).values)


@profiling.span("calib.knn")
@torch.inference_mode()
def get_knn_dists(val_base_class_features, image_features_cur, k_nns: int,
                  chunk: int = 8192, device="cuda") -> np.ndarray:
    """[N_test, k] distances of test features to base-val features
    (reference ``proximity.py:19-46``). k is clamped to the base-set size
    for tiny val sets."""
    device = resolve_device(device)
    base = torch.as_tensor(np.asarray(val_base_class_features, np.float32),
                           device=device)
    cur = np.asarray(image_features_cur, np.float32)
    k_nns = min(k_nns, base.shape[0])
    out = []
    for i in range(0, len(cur), chunk):
        q = torch.as_tensor(cur[i:i + chunk], device=device)
        out.append(_knn_chunk(q, base, k_nns).cpu().numpy())
    return np.concatenate(out, axis=0)


@torch.inference_mode()
def get_val_image_knn_dists(image_features_cur, k_nns: int,
                            chunk: int = 8192, device="cuda") -> np.ndarray:
    """Self-KNN over the val set, excluding each sample itself
    (reference ``proximity.py:49-70``: top k+1 smallest, drop the first)."""
    device = resolve_device(device)
    feats = np.asarray(image_features_cur, np.float32)
    base = torch.as_tensor(feats, device=device)
    # k+1 neighbors include the sample itself; clamp for tiny val sets
    k_nns = min(k_nns, len(feats) - 1)
    if k_nns < 1:
        # a 1-sample val set has no neighbors at all; a silent clamp to
        # zero columns would propagate NaN proximities downstream
        raise ValueError(
            "val set too small for image-KNN proximity: need >= 2 "
            f"samples, got {len(feats)}")
    out = []
    for i in range(0, len(feats), chunk):
        q = torch.as_tensor(feats[i:i + chunk], device=device)
        d = _knn_chunk(q, base, k_nns + 1).cpu().numpy()
        out.append(d[:, 1:])  # drop self (distance 0)
    return np.concatenate(out, axis=0)


def proximity_from_dists(knndists: np.ndarray) -> np.ndarray:
    """exp(-mean distance to K nearest neighbors)
    (reference ``base_learner.py:136-137``)."""
    return np.exp(-np.mean(np.asarray(knndists), axis=-1))
