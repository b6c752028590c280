"""BinMeanShift: proximity-binned wrapper around binning calibrators.

Parity target: reference ``trainers/calibration/multi_proximity_isotonic.py:230-347``
(class BinMeanShift): cluster samples into proximity bins (quantile /
kmeans / uniform edges), fit an independent calibrator per bin, and
re-scatter calibrated rows back to input order.

The JAX package clusters with scikit-learn's ``KMeans``, which the GPU
machine lacks; ``kmeans_1d`` runs the same Lloyd iterations in numpy.
"""

from __future__ import annotations

import numpy as np


def _lloyd_step(x, centers):
    """One Lloyd iteration as scikit-learn's ``lloyd_iter_chunked_dense``
    runs it on 1-D data: labels by the least ``c^2 - 2 x c`` (ties to the
    lower index), summed centres, empty clusters relocated to the points
    farthest from their old centre, then centres scaled by 1 / weight.
    Returns (labels, new centres, centre shifts)."""
    k = len(centers)
    labels = np.argmin(centers * centers + (-2.0 * x[:, None]) * centers,
                       axis=1)
    weights = np.bincount(labels, minlength=k).astype(np.float64)
    sums = np.bincount(labels, weights=x, minlength=k)
    empty = np.flatnonzero(weights == 0)
    if len(empty):
        dist = (x - centers[labels]) ** 2
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if dist.max() != 0:
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= x[idx]
                sums[new] = x[idx]
                weights[new] = 1.0
                weights[old] -= 1.0
    new_centers = sums.copy()
    full = weights > 0
    new_centers[full] *= 1.0 / weights[full]
    new_centers[~full] = new_centers[np.argmax(weights)]
    return labels, new_centers, np.abs(new_centers - centers)


def kmeans_1d(x, init, max_iter: int = 300, tol: float = 1e-4):
    """Centres of ``KMeans(n_clusters=len(init), init=init[:, None],
    n_init=1).fit(x[:, None])`` (the ``lloyd`` algorithm): data and
    initial centres shifted by the data's mean, tolerance ``tol`` times
    the data's variance, stop when the labels repeat or the squared centre
    shift falls to the tolerance; the labels of the last centres are not
    needed here."""
    x = np.asarray(x, np.float64).reshape(-1)
    centers = np.array(init, np.float64).reshape(-1)
    if len(x) < len(centers):
        raise ValueError(f"n_samples={len(x)} should be >= "
                         f"n_clusters={len(centers)}.")
    tol = np.var(x) * tol
    mean = x.mean()
    x = x - mean
    centers = centers - mean
    labels_old = np.full(len(x), -1)
    for _ in range(max_iter):
        labels, centers, shift = _lloyd_step(x, centers)
        if np.array_equal(labels, labels_old):
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    return centers + mean


class BinMeanShift:
    def __init__(self, method_name: str, method, bin_strategy: str =
                 "quantile", normalize_conf: bool = False,
                 proximity_bin: int = 10, **kwargs):
        self.method_name = method_name
        self.proximity_bin = proximity_bin
        self.bin_strategy = bin_strategy
        self.normalize_conf = normalize_conf
        self.calibrators = [method(**kwargs) for _ in range(proximity_bin)]
        self.bin_edges: np.ndarray | None = None

    # -- edge strategies ----------------------------------------------------
    def _edges_quantile(self, proximity):
        qs = np.linspace(0, 100, self.proximity_bin + 1)
        return np.asarray(np.percentile(proximity, qs))

    def _edges_uniform(self, proximity):
        return np.linspace(proximity.min(), proximity.max(),
                           self.proximity_bin + 1)

    def _edges_kmeans(self, proximity):
        lo, hi = proximity.min(), proximity.max()
        uniform = np.linspace(lo, hi, self.proximity_bin + 1)
        init = (uniform[1:] + uniform[:-1]) * 0.5
        centers = kmeans_1d(proximity, init)
        centers.sort()
        inner = (centers[1:] + centers[:-1]) * 0.5
        return np.r_[lo, inner, hi]

    def _compute_edges(self, proximity):
        strat = {"quantile": self._edges_quantile,
                 "kmeans": self._edges_kmeans,
                 "uniform": self._edges_uniform}[self.bin_strategy]
        return strat(np.asarray(proximity, np.float64))

    # -- fit/predict ----------------------------------------------------------
    def _bin_assign(self, proximity):
        return np.searchsorted(self.bin_edges[1:-1], proximity,
                               side="right")

    def _maybe_softmax(self, x):
        # histogram_binning / isotonic_regression consume probabilities;
        # the reference re-softmaxes here (multi_proximity_isotonic.py:221)
        if self.method_name in ("histogram_binning", "isotonic_regression"):
            x = np.asarray(x, np.float64)
            e = np.exp(x)
            return e / e.sum(axis=1, keepdims=True)
        return np.asarray(x, np.float64)

    def fit_transform(self, x, proximity, label):
        proximity = np.asarray(proximity, np.float64)
        self.bin_edges = self._compute_edges(proximity)
        bin_no = self._bin_assign(proximity)
        x = self._maybe_softmax(x)
        label = np.asarray(label)

        groups = [np.where(bin_no == b)[0]
                  for b in range(self.proximity_bin)]
        # bins left empty by duplicate edges (tied proximities) have no
        # calibrator fit; test samples routed to them later pass through
        # uncalibrated instead of hitting an unfitted calibrator
        self._fitted = [len(idx) > 0 for idx in groups]
        parts = []
        for b, idx in enumerate(groups):
            if len(idx) == 0:
                parts.append(np.zeros((0, x.shape[1])))
                continue
            parts.append(self.calibrators[b].fit_transform(x[idx],
                                                           label[idx]))
        probs = np.concatenate(parts, axis=0)
        if self.normalize_conf:
            probs = probs / probs.sum(axis=1, keepdims=True)
        order = np.argsort(np.concatenate(groups))
        return probs[order]

    def transform(self, x, proximity):
        proximity = np.asarray(proximity, np.float64)
        bin_no = self._bin_assign(proximity)
        x = self._maybe_softmax(x)
        groups = [np.where(bin_no == b)[0]
                  for b in range(self.proximity_bin)]
        fitted = getattr(self, "_fitted", [True] * self.proximity_bin)
        parts = []
        for b, idx in enumerate(groups):
            if len(idx) == 0:
                parts.append(np.zeros((0, x.shape[1])))
            elif not fitted[b]:  # empty at fit time: identity
                parts.append(x[idx])
            else:
                parts.append(self.calibrators[b].transform(x[idx]))
        probs = np.concatenate(parts, axis=0)
        order = np.argsort(np.concatenate(groups))
        return probs[order]
