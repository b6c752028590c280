"""Distance-Aware Calibration (DAC) — the paper's method.

Parity target: reference ``trainers/calibration/distanse_aware_calibration.py``.

fit: for each current (new) class i, compute L2 distances from its text
feature to all base-class text features under both the zero-shot and the
tuned encoder; score = exp(-mean of top-k distances); per-class confidence
= tuned_score / zs_score, or 1.0 when the nearest *tuned* base distance is
< 0.05 (base-class detection — the reference reuses the tuned top-k array
in that check, preserved here).

predict: scale each sample's logit row by the confidence of its argmax
class. Runs as one vectorized device op (the reference loops per sample on
GPU); see also ops/scoring.py for the fused normalize-matmul-DAC kernel.
"""

from __future__ import annotations

import numpy as np


def _topk_scores(base: np.ndarray, current: np.ndarray, k: int):
    """For each current row: (exp(-mean of k smallest L2 distances to base),
    smallest distance). Vectorized [n_cur, n_base] distance matrix."""
    base = np.asarray(base, np.float64)
    current = np.asarray(current, np.float64)
    # class counts are small; exact fp64 pairwise norms for parity
    d = np.linalg.norm(current[:, None, :] - base[None, :, :], axis=-1)
    # reference always divides by k even when fewer than k base classes
    # exist (np.sort(...)[:k] just yields them all)
    k_eff = min(k, d.shape[1])
    part = np.partition(d, k_eff - 1, axis=1)[:, :k_eff]
    scores = np.exp(-np.sum(part, axis=1) / k)
    return scores, part.min(axis=1)


class DistanceAwareCalibration:
    def __init__(self):
        self.class_confidence: np.ndarray | None = None

    def fit(self, base_text_features_zs, current_text_features_zs,
            base_text_features_tuned, current_text_features_tuned,
            k: int = 5) -> None:
        zs_score, _ = _topk_scores(base_text_features_zs,
                                   current_text_features_zs, k)
        fs_score, fs_min = _topk_scores(base_text_features_tuned,
                                        current_text_features_tuned, k)
        conf = fs_score / zs_score
        # base-class awareness: nearest tuned base feature almost identical
        self.class_confidence = np.where(fs_min < 0.05, 1.0,
                                         conf).astype(np.float64)

    def predict(self, logits: np.ndarray) -> np.ndarray:
        logits = np.asarray(logits, np.float32)
        preds = np.argmax(logits, axis=1)
        return logits * self.class_confidence[preds][:, None].astype(
            np.float32)
