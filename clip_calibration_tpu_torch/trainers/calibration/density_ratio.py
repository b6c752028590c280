"""Density-ratio (ProCal) calibration.

Parity target: reference ``trainers/calibration/density_ratio_calibration.py:29-117``.
Fits 2-D kernel density estimates over (confidence, proximity) separately
for correctly and incorrectly classified validation samples, then applies
Bayes' rule at predict time:

    p(correct | conf, prox) = d_true / (d_true + d_false * ratio)

The reference uses ``statsmodels.nonparametric.KDEMultivariate`` with the
normal-reference bandwidth; statsmodels is not a dependency here, so an
equivalent product-Gaussian KDE with Scott's normal-reference rule
(bw_j = 1.06 * sigma_j * n^(-1/(d+4)), the same rule statsmodels applies
for var_type='cc') is implemented in-line, evaluated as one vectorized
numpy broadcast.
"""

from __future__ import annotations

import numpy as np


class GaussianKDE2D:
    """Product-Gaussian KDE over [n, 2] data, normal-reference bandwidth."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float64)  # [n, 2]
        n, d = self.data.shape
        sigma = np.std(self.data, axis=0, ddof=1)
        sigma = np.maximum(sigma, 1e-6)
        self.bw = 1.06 * sigma * n ** (-1.0 / (d + 4))

    def pdf(self, points: np.ndarray, chunk: int = 4096) -> np.ndarray:
        points = np.asarray(points, np.float64)
        out = np.empty(len(points))
        norm = np.prod(self.bw) * (2 * np.pi) ** (self.data.shape[1] / 2)
        for i in range(0, len(points), chunk):
            p = points[i:i + chunk]
            z = (p[:, None, :] - self.data[None, :, :]) / self.bw
            k = np.exp(-0.5 * np.sum(z ** 2, axis=-1))
            out[i:i + chunk] = k.mean(axis=1) / norm
        return out


class DensityRatioCalibration:
    def __init__(self):
        self.dens_true: GaussianKDE2D | None = None
        self.dens_false: GaussianKDE2D | None = None
        self.false_true_ratio: float = 0.0
        self.degenerate: bool = False

    def fit(self, probs, preds, true, proximity) -> None:
        probs = np.asarray(probs, np.float64)
        assert np.all(probs >= 0) and np.all(probs <= 1), (
            "All elements in 'probs' should be in the range [0, 1].")
        preds = np.asarray(preds)
        true = np.asarray(true)
        proximity = np.asarray(proximity, np.float64)
        confs = np.max(probs, axis=-1)
        correct = preds == true

        # a 2-D KDE needs >= 2 samples per class for a finite bandwidth
        # (ddof=1 std of one point is NaN; n=0 crashes the bandwidth
        # rule). Few-shot val splits are tiny (<= 4/class) and often
        # near-perfectly classified, so a (near-)empty incorrect set is
        # common — fall back to identity calibration rather than
        # poisoning every probability. (The reference's statsmodels KDE
        # degenerates the same way; this guard is a deviation for
        # robustness.)
        self.degenerate = correct.sum() < 2 or (~correct).sum() < 2
        if self.degenerate:
            print("DensityRatioCalibration: <2 correct or incorrect "
                  "val samples; falling back to identity calibration")
            return

        self.dens_true = GaussianKDE2D(
            np.stack([confs[correct], proximity[correct]], axis=1))
        self.dens_false = GaussianKDE2D(
            np.stack([confs[~correct], proximity[~correct]], axis=1))
        self.false_true_ratio = float((~correct).sum()) / float(
            correct.sum())

    def predict(self, probs, proximities) -> np.ndarray:
        probs = np.asarray(probs, np.float64)
        assert np.all(probs >= 0) and np.all(probs <= 1), (
            "All elements in 'probs' should be in the range [0, 1].")
        if self.degenerate:
            return probs.copy()
        proximities = np.asarray(proximities, np.float64)
        preds = np.argmax(probs, axis=-1)
        confs = np.max(probs, axis=-1)

        data = np.stack([confs, proximities], axis=1)
        d_true = self.dens_true.pdf(data)
        d_false = self.dens_false.pdf(data)
        eps = 1e-10
        conf_cal = d_true / np.maximum(
            d_true + d_false * self.false_true_ratio, eps)

        # redistribute the non-argmax mass to sum to 1 - conf_cal
        out = probs.copy()
        mask = np.ones_like(out, dtype=bool)
        mask[np.arange(len(out)), preds] = False
        out = out * mask
        rest = out.sum(axis=-1)
        rest[rest == 0] = 1.0
        out = out * ((1 - conf_cal) / rest)[:, None]
        out[np.arange(len(out)), preds] = conf_cal
        return out


# ---------------------------------------------------------------------------
# CustomizedDensityRatioCalibration (reference density_ratio_calibration.py:
# 173-459) — the mirrored-boundary / fixed-bandwidth variant. Dead code in
# the reference (vl_calibrator.py:25,118 imports only
# DensityRatioCalibration), carried here for belt-and-braces parity and
# gated by a live oracle against the reference's own class
# (tests/test_calibrators.py). Only the full-covariance Gaussian backend
# is provided (the reference's 'scipy_gaussian_kde' semantics): the
# sklearn/statsmodels backends differ only in kernel bookkeeping, and the
# commented-out KDEpy ones never existed.
# ---------------------------------------------------------------------------

def _softmax(x: np.ndarray) -> np.ndarray:
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def mirror2d(data: np.ndarray, xmin: float = 0.0, xmax: float = 1.0,
             ymin: float = 0.0) -> np.ndarray:
    """Reflecting boundary conditions on [n, 2] (conf, proximity) data
    (reference ``mirror_2d``/``mirror_1d_along_axis``,
    ``density_ratio_calibration.py:121-170``): the conf axis reflects
    rows below the midpoint across xmin and the rest across xmax; the
    proximity axis (half-open domain) prepends a full reflection across
    ymin. Output row ORDER differs from the reference's concatenation
    order — KDE sums are order-invariant."""
    data = np.asarray(data, np.float64)
    mid = 0.5 * (xmin + xmax)
    lo = data[:, 0] < mid
    refl_x = data.copy()
    refl_x[:, 0] = np.where(lo, 2.0 * xmin - data[:, 0],
                            2.0 * xmax - data[:, 0])
    stage1 = np.concatenate([refl_x, data], axis=0)
    refl_y = stage1.copy()
    refl_y[:, 1] = 2.0 * ymin - stage1[:, 1]
    return np.concatenate([refl_y, stage1], axis=0)


class GaussianKDEFull:
    """Full-covariance Gaussian KDE with a scalar bandwidth factor —
    the semantics of ``scipy.stats.gaussian_kde(data.T, bw_method=h)``:
    kernel covariance = h^2 * sample covariance (ddof=1)."""

    def __init__(self, data: np.ndarray, factor: float):
        self.data = np.asarray(data, np.float64)
        n, d = self.data.shape
        cov = np.cov(self.data.T, ddof=1) * factor ** 2
        self._inv = np.linalg.inv(cov)
        self._norm = np.sqrt((2 * np.pi) ** d * np.linalg.det(cov))

    def pdf(self, points: np.ndarray, chunk: int = 4096) -> np.ndarray:
        points = np.asarray(points, np.float64)
        out = np.empty(len(points))
        for i in range(0, len(points), chunk):
            diff = points[i:i + chunk, None, :] - self.data[None, :, :]
            maha = np.einsum("pnd,de,pne->pn", diff, self._inv, diff)
            out[i:i + chunk] = np.exp(-0.5 * maha).mean(axis=1)
        return out / self._norm


class CustomizedDensityRatioCalibration:
    """fit(logits) -> Bayes-rule predict with optional boundary
    mirroring. Matches the reference's ``is_conf=False`` contract
    (confidence = max softmax(logits)); the reference's ``is_conf=True``
    predict path is internally inconsistent (it still softmaxes the
    1-D confidence vector, ``density_ratio_calibration.py:443``) and is
    not carried."""

    def __init__(self, mirror: bool = False, bandwidth: float = 0.1):
        self.mirror = mirror
        self.bandwidth = bandwidth
        self.degenerate = False

    def fit(self, logits, preds, true, proximity) -> None:
        confs = np.max(_softmax(np.asarray(logits, np.float64)), axis=-1)
        preds = np.asarray(preds)
        true = np.asarray(true)
        correct = preds == true
        # same degenerate-split guard as DensityRatioCalibration above:
        # a 2-D KDE needs >= 2 samples per class for a finite covariance
        self.degenerate = correct.sum() < 2 or (~correct).sum() < 2
        if self.degenerate:
            print("CustomizedDensityRatioCalibration: <2 correct or "
                  "incorrect val samples; falling back to identity "
                  "calibration")
            return
        t = np.stack([confs[correct],
                      np.asarray(proximity, np.float64)[correct]], axis=1)
        f = np.stack([confs[~correct],
                      np.asarray(proximity, np.float64)[~correct]],
                     axis=1)
        if self.mirror:
            t, f = mirror2d(t), mirror2d(f)
        self.dens_true = GaussianKDEFull(t, self.bandwidth)
        self.dens_false = GaussianKDEFull(f, self.bandwidth)
        self.false_true_ratio = float((~correct).sum()) / float(
            correct.sum())

    def predict(self, logits, proximities) -> np.ndarray:
        logits = np.asarray(logits, np.float64)
        probs = _softmax(logits)
        if self.degenerate:
            return probs
        confs = np.max(probs, axis=-1)
        preds = np.argmax(probs, axis=-1)
        data = np.stack([confs,
                         np.asarray(proximities, np.float64)], axis=1)
        d_true = self.dens_true.pdf(data)
        d_false = self.dens_false.pdf(data)
        if self.mirror:
            # densities are zeroed outside [0, 1] and quadrupled to
            # re-normalize the reflected mass (reference :408-415) —
            # the zeroing is vacuous for real confidences, kept for
            # contract parity
            oob = (confs < 0.0) | (confs > 1.0)
            d_true = np.where(oob, 0.0, d_true * 4.0)
            d_false = np.where(oob, 0.0, d_false * 4.0)
        eps = 1e-10
        conf_cal = d_true / np.maximum(
            d_true + d_false * self.false_true_ratio, eps)

        out = probs.copy()
        mask = np.ones_like(out, dtype=bool)
        mask[np.arange(len(out)), preds] = False
        out = out * mask
        # one-hot float64 rows have zero non-argmax mass — guard the
        # division like DensityRatioCalibration.predict above
        rest = out.sum(axis=-1)
        rest[rest == 0] = 1.0
        out = out * ((1 - conf_cal) / rest)[:, None]
        out[np.arange(len(out)), preds] = conf_cal
        return out
