"""Distance-Aware Calibration (DAC) — the paper's method.

Parity target: reference ``trainers/calibration/distanse_aware_calibration.py``.

fit: for each current (new) class i, compute L2 distances from its text
feature to all base-class text features under both the zero-shot and the
tuned encoder; score = exp(-mean of top-k distances); per-class confidence
= tuned_score / zs_score, or 1.0 when the nearest *tuned* base distance is
< 0.05 (base-class detection — the reference reuses the tuned top-k array
in that check, preserved here).

The fit runs on the trainer's device in float64 (ops/scoring.py); the
per-class confidences live on the host.

predict: scale each sample's logit row by the confidence of its argmax
class. Runs as one vectorized device op (the reference loops per sample on
GPU); see also ops/scoring.py for the fused normalize-matmul-DAC kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.scoring import dac_class_confidence
from ...tools.device import resolve_device


class DistanceAwareCalibration:
    def __init__(self):
        self.class_confidence: np.ndarray | None = None

    def fit(self, base_text_features_zs, current_text_features_zs,
            base_text_features_tuned, current_text_features_tuned,
            k: int = 5, device="cuda") -> None:
        """The fit runs on ``device`` in float64
        (``ops/scoring.py::dac_class_confidence``); the confidences come
        back to the host as float64."""
        dev = resolve_device(device)
        feats = (torch.as_tensor(np.asarray(a, np.float64), device=dev)
                 for a in (base_text_features_zs, current_text_features_zs,
                           base_text_features_tuned,
                           current_text_features_tuned))
        self.class_confidence = dac_class_confidence(
            *feats, k=k).cpu().numpy()

    def predict(self, logits: np.ndarray) -> np.ndarray:
        logits = np.asarray(logits, np.float32)
        preds = np.argmax(logits, axis=1)
        return logits * self.class_confidence[preds][:, None].astype(
            np.float32)
