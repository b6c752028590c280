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

The JAX package fits the isotonic maps with scikit-learn, which the GPU
machine lacks; here ``Isotonic`` does the same fit in numpy, step for step
as ``sklearn.isotonic.IsotonicRegression(out_of_bounds="clip")``.
"""

from __future__ import annotations

import numpy as np


def _pool_ties(x, y, w):
    """sklearn's ``_make_unique``: x sorted; a run of x values within
    float64 resolution of its first becomes one point at that x, with the
    weighted mean of its y and the sum of its weights."""
    eps = np.finfo(np.float64).resolution
    xs, ys, ws = [], [], []
    cur_x, cur_y, cur_w = x[0], 0.0, 0.0
    for xj, yj, wj in zip(x, y, w):
        if xj - cur_x >= eps:
            xs.append(cur_x)
            ws.append(cur_w)
            ys.append(cur_y / cur_w)
            cur_x, cur_w, cur_y = xj, wj, yj * wj
        else:
            cur_w += wj
            cur_y += yj * wj
    xs.append(cur_x)
    ws.append(cur_w)
    ys.append(cur_y / cur_w)
    return np.array(xs), np.array(ys), np.array(ws)


def _pava(y, w):
    """Weighted non-decreasing least-squares fit by pool adjacent
    violators: Busing (2022), Algorithm 1, as ``scipy.optimize.
    isotonic_regression`` runs it (ties pooled, ``>=``)."""
    y = np.array(y, np.float64)
    w = np.array(w, np.float64)
    n = len(y)
    r = np.zeros(n + 1, np.int64)  # block b covers [r[b], r[b + 1])
    r[1] = 1
    b = 0
    yb_prev, wb_prev = y[0], w[0]
    i = 1
    while i < n:
        b += 1
        yb, wb = y[i], w[i]
        if yb_prev >= yb:
            b -= 1
            sb = wb_prev * yb_prev + wb * yb
            wb += wb_prev
            yb = sb / wb
            while i < n - 1 and yb >= y[i + 1]:
                i += 1
                sb += w[i] * y[i]
                wb += w[i]
                yb = sb / wb
            while b > 0 and y[b - 1] >= yb:
                b -= 1
                sb += w[b] * y[b]
                wb += w[b]
                yb = sb / wb
        y[b] = yb_prev = yb
        w[b] = wb_prev = wb
        r[b + 1] = i + 1
        i += 1
    return np.repeat(y[:b + 1], np.diff(r[:b + 2]))


class Isotonic:
    """1-D non-decreasing isotonic regression that clips out of bounds:
    ``sklearn.isotonic.IsotonicRegression(out_of_bounds="clip")`` in
    numpy. Fit: sort by (x, y), pool tied x, pool adjacent violators, drop
    the interior points of flat runs. Predict: clip to the fitted x range,
    interpolate linearly between the thresholds."""

    def fit(self, x, y):
        x = np.asarray(x, np.float64).reshape(-1)
        y = np.asarray(y, np.float64).reshape(-1)
        order = np.lexsort((y, x))
        ux, uy, uw = _pool_ties(x[order], y[order], np.ones(len(x)))
        fy = _pava(uy, uw)
        self.x_min, self.x_max = ux.min(), ux.max()
        keep = np.ones(len(fy), bool)
        keep[1:-1] = (fy[1:-1] != fy[:-2]) | (fy[1:-1] != fy[2:])
        self.x_thresholds, self.y_thresholds = ux[keep], fy[keep]
        return self

    def predict(self, t):
        t = np.clip(np.asarray(t, np.float64).reshape(-1), self.x_min,
                    self.x_max)
        if len(self.y_thresholds) == 1:
            return np.repeat(self.y_thresholds, t.shape)
        return np.interp(t, self.x_thresholds, self.y_thresholds)

    def fit_transform(self, x, y):
        return self.fit(x, y).predict(x)


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
        probs = np.asarray(probs, np.float64)
        onehot = _one_hot(labels, probs.shape[1])
        self._models = [Isotonic().fit(probs[:, c], onehot[:, c])
                        for c in range(probs.shape[1])]
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
        self.calibrator = Isotonic()

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
