"""Calibrated scoring on the device.

``fused_dac_scores``: cosine logits, the DAC per-class confidence applied
to each row's argmax class, and softmax, in one pass over device tensors
(the reference runs the DAC row scaling as a separate torch pass after a
numpy hop, ``trainers/calibration/distanse_aware_calibration.py:49-58``).
``dac_class_confidence``: the port's DAC fit (top-k text-feature
distances), in float64 on the device. Both are plain PyTorch: neither was
a TPU kernel.
"""

from __future__ import annotations

import torch

from ..models.clip import normalize


def dac_class_confidence(base_zs: torch.Tensor, cur_zs: torch.Tensor,
                         base_tuned: torch.Tensor, cur_tuned: torch.Tensor,
                         k: int = 5,
                         base_thresh: float = 0.05) -> torch.Tensor:
    """Per-class confidence from top-k text-feature distances (reference
    ``fit``): exp(-sum of the k smallest L2 distances to the base classes
    / k), tuned over zero-shot, and 1.0 where the nearest tuned base
    distance is under ``base_thresh``. Computes in float64 on the inputs'
    device and returns a float64 tensor there."""
    def topk_scores(base, cur):
        # the difference form, as the reference's numpy fit: the Gram
        # expansion loses digits to cancellation exactly where a current
        # feature nearly coincides with a base one (the threshold's case)
        d = torch.cdist(cur.double(), base.double(),
                        compute_mode="donot_use_mm_for_euclid_dist")
        # fewer base classes than k: take them all, still divide by k
        # (reference semantics)
        top = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False).values
        return torch.exp(-top.sum(dim=1) / k), top.min(dim=1).values

    zs_score, _ = topk_scores(base_zs, cur_zs)
    fs_score, fs_min = topk_scores(base_tuned, cur_tuned)
    return torch.where(fs_min < base_thresh, torch.ones_like(fs_score),
                       fs_score / zs_score)


def fused_dac_scores(image_features: torch.Tensor,
                     text_features: torch.Tensor,
                     logit_scale: torch.Tensor,
                     class_confidence: torch.Tensor,
                     normalized: bool = False):
    """(img_f [B,E], txt_f [C,E], scalar log-scale, conf [C]) ->
    (calibrated probs [B,C], calibrated logits [B,C]).

    logits = scale * norm(img) @ norm(txt).T, each row multiplied by the
    DAC confidence of its argmax class, then softmax. ``normalized=True``
    skips the normalize (features already unit-norm)."""
    if normalized:
        img, txt = image_features.float(), text_features.float()
    else:
        img = normalize(image_features).float()
        txt = normalize(text_features).float()
    scale = torch.exp(logit_scale.float())
    logits = scale * (img @ txt.T)
    preds = logits.argmax(dim=1)
    logits = logits * class_confidence.float()[preds][:, None]
    return torch.softmax(logits, dim=-1), logits
