"""Calibration metrics: ECE, MCE, AdaptiveECE (ACE), PIECE.

Vectorized numpy re-implementations with exact output parity against the
reference formulas (reference ``tools/metrics.py:90-236``), verified
on golden fixtures. Notable reference quirks preserved deliberately:

- ECE: per-bin membership uses ``digitize(conf, linspace(0,1,11)) - 1`` but
  bin weights use ``np.histogram`` — a sample with conf == 1.0 lands in no
  accuracy bin yet still contributes weight to the last bin.
- MCE here is the *weighted* max bin gap (|acc-conf| * count / N), not the
  textbook unweighted max (``metrics.py:181-208``).
- ACE/PIECE quantile bins follow scikit-learn's KBinsDiscretizer semantics
  (quantile edges, duplicate-edge collapse), reimplemented in numpy so the
  metrics need no scikit-learn.

These run on host numpy: metric inputs are small (N test samples x nothing)
and arrive post-inference; keeping them fp64 on CPU gives bit-stable
parity, which matters more than device residency here.
"""

from __future__ import annotations

import numpy as np


def _kbins(values: np.ndarray, n_bins: int, strategy: str) -> np.ndarray:
    """Ordinal binning with the semantics of scikit-learn's
    ``KBinsDiscretizer(encode="ordinal")`` (its default
    ``quantile_method="averaged_inverted_cdf"``): quantile or uniform
    edges, bins narrower than 1e-8 dropped (quantile), a constant input
    all in bin 0."""
    values = np.asarray(values, np.float64)
    lo, hi = values.min(), values.max()
    if lo == hi:
        return np.zeros(len(values), np.int64)
    if strategy == "quantile":
        edges = np.percentile(values, np.linspace(0, 100, n_bins + 1),
                              method="averaged_inverted_cdf")
        edges = edges[np.ediff1d(edges, to_begin=np.inf) > 1e-8]
    else:
        edges = np.linspace(lo, hi, n_bins + 1)
    return np.searchsorted(edges[1:-1], values, side="right").astype(
        np.int64)


def _quantile_bins(values: np.ndarray, n_bins: int) -> np.ndarray:
    return _kbins(values, n_bins, "quantile")


def _grouped_gap(bin_ids: np.ndarray, conf: np.ndarray,
                 correct: np.ndarray) -> np.ndarray:
    """Per-group |mean(acc) - mean(conf)| * count / N over occupied groups."""
    n = len(conf)
    uniq, inv = np.unique(bin_ids, return_inverse=True)
    counts = np.bincount(inv)
    acc = np.bincount(inv, weights=correct) / counts
    mean_conf = np.bincount(inv, weights=conf) / counts
    return np.abs(acc - mean_conf) * counts / n


def ECE(conf, pred, gt, conf_bin_num: int = 10) -> float:
    """Expected Calibration Error (reference ``metrics.py:90-130``)."""
    conf = np.asarray(conf, np.float64)
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    bins = np.linspace(0, 1, conf_bin_num + 1)
    idx = np.digitize(conf, bins) - 1  # conf==1.0 -> conf_bin_num (dropped)

    bin_acc = np.zeros(conf_bin_num)
    bin_conf = np.zeros(conf_bin_num)
    in_range = (idx >= 0) & (idx < conf_bin_num)
    counts = np.bincount(idx[in_range], minlength=conf_bin_num)
    occupied = counts > 0
    sums_acc = np.bincount(idx[in_range],
                           weights=(gt == pred)[in_range].astype(np.float64),
                           minlength=conf_bin_num)
    sums_conf = np.bincount(idx[in_range], weights=conf[in_range],
                            minlength=conf_bin_num)
    bin_acc[occupied] = sums_acc[occupied] / counts[occupied]
    bin_conf[occupied] = sums_conf[occupied] / counts[occupied]

    weights = np.histogram(conf, bins)[0] / len(conf)
    return float(np.sum(weights * np.abs(bin_conf - bin_acc)))


def MCE(conf, pred, gt, conf_bin_num: int = 10) -> float:
    """Weighted maximal calibration error (reference ``metrics.py:181-208``:
    groupby digitize(conf, inner bounds), max of |acc-conf|*count/N)."""
    conf = np.asarray(conf, np.float64)
    correct = (np.asarray(pred) == np.asarray(gt)).astype(np.float64)
    bounds = np.linspace(0, 1, conf_bin_num + 1)[1:-1]
    bin_ids = np.digitize(conf, bounds)
    return float(_grouped_gap(bin_ids, conf, correct).max())


def AdaptiveECE(conf, pred, gt, conf_bin_num: int = 10) -> float:
    """Quantile-binned ECE (reference ``metrics.py:212-236``)."""
    conf = np.asarray(conf, np.float64)
    correct = (np.asarray(pred) == np.asarray(gt)).astype(np.float64)
    bin_ids = _quantile_bins(conf, conf_bin_num)
    return float(_grouped_gap(bin_ids, conf, correct).sum())


def PIECE(conf, knndist, pred, gt, dist_bin_num: int = 10,
          conf_bin_num: int = 10, knn_strategy: str = "quantile") -> float:
    """Proximity-Informed ECE: 2-D (proximity-bin x conf-bin) groupby
    (reference ``metrics.py:132-178``)."""
    conf = np.asarray(conf, np.float64)
    knndist = np.asarray(knndist, np.float64)
    correct = (np.asarray(pred) == np.asarray(gt)).astype(np.float64)

    if knn_strategy == "quantile":
        knn_ids = _quantile_bins(knndist, dist_bin_num)
    elif knn_strategy == "uniform":
        knn_ids = _kbins(knndist, dist_bin_num, "uniform")
    else:
        raise ValueError(knn_strategy)

    bounds = np.linspace(0, 1, conf_bin_num + 1)[1:-1]
    conf_ids = np.digitize(conf, bounds)
    combined = knn_ids * (conf_bin_num + 1) + conf_ids
    return float(_grouped_gap(combined, conf, correct).sum())
