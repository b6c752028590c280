"""Binning-based post-hoc calibrators.

The reference consumes ``netcal.binning.{HistogramBinning, IsotonicRegression}``
(reference ``trainers/calibration/vl_calibrator.py:20-21``) plus its own
``MultiIsotonicRegression`` (``multi_isotonic_regression.py``). netcal is a
small external dependency; the first two are re-implemented here with the
standard one-vs-rest multiclass reduction, and MultiIsotonicRegression
follows the reference formula exactly (single shared isotonic fit over all
flattened class probabilities, Mix-n-Match style).

Shared API (matching how VLCalibration drives them):
  fit(probs, labels) / transform(probs) / fit_transform(probs, labels)
where probs is [N, C] and labels is [N] int (or [N, C] one-hot).
"""

from __future__ import annotations

import numpy as np


def _one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    labels = np.asarray(labels)
    if labels.ndim == 2:
        return labels.astype(np.float64)
    out = np.zeros((len(labels), n_classes))
    out[np.arange(len(labels)), labels] = 1.0
    return out


class HistogramBinning:
    """Per-class one-vs-rest histogram binning, rows renormalized."""

    def __init__(self, bins: int = 10):
        self.bins = bins
        self._bin_means: np.ndarray | None = None  # [C, bins]

    def fit(self, probs, labels):
        probs = np.asarray(probs, np.float64)
        onehot = _one_hot(labels, probs.shape[1])
        edges = np.linspace(0.0, 1.0, self.bins + 1)
        idx = np.clip(np.digitize(probs, edges) - 1, 0, self.bins - 1)
        n_classes = probs.shape[1]
        means = np.zeros((n_classes, self.bins))
        for c in range(n_classes):
            counts = np.bincount(idx[:, c], minlength=self.bins)
            hits = np.bincount(idx[:, c], weights=onehot[:, c],
                               minlength=self.bins)
            occ = counts > 0
            means[c, occ] = hits[occ] / counts[occ]
            # empty bins fall back to the bin midpoint (identity mapping)
            mids = (edges[:-1] + edges[1:]) / 2
            means[c, ~occ] = mids[~occ]
        self._bin_means = means
        return self

    def transform(self, probs):
        probs = np.asarray(probs, np.float64)
        edges = np.linspace(0.0, 1.0, self.bins + 1)
        idx = np.clip(np.digitize(probs, edges) - 1, 0, self.bins - 1)
        out = np.take_along_axis(self._bin_means.T, idx, axis=0)
        row_sum = out.sum(axis=1, keepdims=True)
        row_sum[row_sum == 0] = 1.0
        return out / row_sum

    def fit_transform(self, probs, labels):
        return self.fit(probs, labels).transform(probs)


class IsotonicRegression:
    """Per-class one-vs-rest isotonic regression, rows renormalized."""

    def __init__(self):
        self._models: list | None = None

    def fit(self, probs, labels):
        from sklearn.isotonic import IsotonicRegression as SkIso
        probs = np.asarray(probs, np.float64)
        onehot = _one_hot(labels, probs.shape[1])
        self._models = []
        for c in range(probs.shape[1]):
            iso = SkIso(out_of_bounds="clip")
            iso.fit(probs[:, c], onehot[:, c])
            self._models.append(iso)
        return self

    def transform(self, probs):
        probs = np.asarray(probs, np.float64)
        out = np.stack([m.predict(probs[:, c])
                        for c, m in enumerate(self._models)], axis=1)
        # tie-break toward the raw probs so argmax stays stable, then
        # renormalize
        out = out + 1e-9 * probs
        row_sum = out.sum(axis=1, keepdims=True)
        row_sum[row_sum == 0] = 1.0
        return out / row_sum

    def fit_transform(self, probs, labels):
        return self.fit(probs, labels).transform(probs)


class MultiIsotonicRegression:
    """Multiclass isotonic regression à la Mix-n-Match: one shared isotonic
    fit over all flattened class probabilities (reference
    ``multi_isotonic_regression.py:6-36``; input there is named ``logit``
    but VLCalibration feeds probabilities — softmax is applied again,
    preserved for parity)."""

    def __init__(self):
        from sklearn.isotonic import IsotonicRegression as SkIso
        self.calibrator = SkIso(out_of_bounds="clip")

    def _resoftmax(self, x):
        x = np.asarray(x, np.float64)
        e = np.exp(x)
        return e / e.sum(axis=1, keepdims=True)

    def fit_transform(self, x, label):
        p = self._resoftmax(x)
        onehot = _one_hot(label, x.shape[1])
        y = self.calibrator.fit_transform(p.flatten(), onehot.flatten())
        return y.reshape(x.shape) + 1e-9 * p

    def fit(self, x, label):
        self.fit_transform(x, label)
        return self

    def transform(self, x):
        p = self._resoftmax(x)
        y = self.calibrator.predict(p.flatten())
        return y.reshape(x.shape) + 1e-9 * p
