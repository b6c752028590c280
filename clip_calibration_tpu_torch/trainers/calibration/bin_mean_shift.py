"""BinMeanShift: proximity-binned wrapper around binning calibrators.

Parity target: reference ``trainers/calibration/multi_proximity_isotonic.py:230-347``
(class BinMeanShift): cluster samples into proximity bins (quantile /
kmeans / uniform edges), fit an independent calibrator per bin, and
re-scatter calibrated rows back to input order.
"""

from __future__ import annotations

import numpy as np


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
        from sklearn.cluster import KMeans
        lo, hi = proximity.min(), proximity.max()
        uniform = np.linspace(lo, hi, self.proximity_bin + 1)
        init = ((uniform[1:] + uniform[:-1]) * 0.5)[:, None]
        km = KMeans(n_clusters=self.proximity_bin, init=init, n_init=1)
        centers = km.fit(proximity[:, None]).cluster_centers_[:, 0]
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
