"""Calibrator composition facade.

Parity target: reference ``trainers/calibration/vl_calibrator.py:28-180``
(class VLCalibration): optional DAC applied to logits first, then softmax,
then an optional base calibrator — ``scaling_based`` + ProCal uses
DensityRatioCalibration, ``bin_based`` uses one of the binning calibrators,
each optionally wrapped in proximity-binned BinMeanShift when ProCal is on.
"""

from __future__ import annotations

import numpy as np
from scipy.special import softmax

from ...tools import profiling
from .bin_mean_shift import BinMeanShift
from .binning import (HistogramBinning, IsotonicRegression,
                      MultiIsotonicRegression)
from .dac import DistanceAwareCalibration
from .density_ratio import DensityRatioCalibration


class VLCalibration:
    """Composes post-hoc calibrators from config flags.

    Args mirror the reference: ``base_calibration_mode`` in
    {None, 'scaling_based', 'bin_based'}; ``base_bin_calibrator_name`` in
    {histogram_binning, isotonic_regression, multi_isotonic_regression};
    ``val_dict`` holds cached base-class validation logits/features/labels/
    knn-dists; ``text_feature_dict`` the 4-way zs/tuned x base/current text
    features; ``device`` where the DAC fit runs.
    """

    def __init__(self, cfg, base_calibration_mode=None,
                 base_bin_calibrator_name=None, dac_flag=False,
                 procal_flag=False, val_dict=None, text_feature_dict=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = device
        self.base_calibration_mode = base_calibration_mode
        self.base_bin_calibrator_name = base_bin_calibrator_name
        self.dac_flag = dac_flag
        self.procal_flag = procal_flag
        self.text_feature_dict = text_feature_dict

        self.k_dac = cfg.CALIBRATION.DAC.K

        self.val_logits = np.asarray(val_dict["val_logits"], np.float64)
        self.val_probs = softmax(self.val_logits, axis=1)
        self.val_preds = np.argmax(self.val_probs, axis=1)
        self.val_labels = np.asarray(val_dict["val_labels"])
        self.val_image_knn_dists = np.asarray(
            val_dict["val_image_knn_dists"], np.float64)
        from .proximity import proximity_from_dists
        self.val_image_proximity = proximity_from_dists(
            self.val_image_knn_dists)

        self.dac_calibrator = None
        self.base_calibrator = None

    # -- fit -------------------------------------------------------------------
    @profiling.span("calib.fit")
    def fit(self):
        if self.dac_flag:
            self.dac_calibrator = self._build_dac()
        if self.base_calibration_mode is not None:
            self.base_calibrator = self._build_base()

    def _build_dac(self):
        t = self.text_feature_dict
        dac = DistanceAwareCalibration()
        dac.fit(t["base_text_features_zs"], t["current_text_features_zs"],
                t["base_text_features_tuned"],
                t["current_text_features_tuned"], k=self.k_dac,
                device=self.device)
        return dac

    def _build_base(self):
        name = self.base_bin_calibrator_name
        prox = self.val_image_proximity

        if self.base_calibration_mode == "scaling_based":
            if not self.procal_flag:
                return None
            cal = DensityRatioCalibration()
            cal.fit(self.val_probs, self.val_preds, self.val_labels, prox)
            return cal

        if self.base_calibration_mode != "bin_based":
            raise ValueError(self.base_calibration_mode)

        method = {"histogram_binning": HistogramBinning,
                  "isotonic_regression": IsotonicRegression,
                  "multi_isotonic_regression": MultiIsotonicRegression}[name]

        if self.procal_flag:
            kwargs = {"bins": 10} if name == "histogram_binning" else {}
            cal = BinMeanShift(name, method, bin_strategy="quantile",
                               normalize_conf=False, proximity_bin=5,
                               **kwargs)
            cal.fit_transform(self.val_probs, prox, self.val_labels)
            return cal

        if name == "histogram_binning":
            cal = method(bins=10)
            cal.fit(self.val_probs, self.val_labels)
        elif name == "isotonic_regression":
            cal = method()
            cal.fit(self.val_probs, self.val_labels)
        else:  # multi_isotonic_regression
            cal = method()
            cal.fit_transform(self.val_probs, self.val_labels)
        return cal

    # -- predict -------------------------------------------------------------
    def predict(self, logits, test_proximity):
        logits = np.asarray(logits, np.float64)
        test_proximity = np.asarray(test_proximity, np.float64)
        assert logits.shape[0] == test_proximity.shape[0], (
            f"Shape mismatch: logits {logits.shape[0]} != "
            f"proximity {test_proximity.shape[0]}")

        if self.dac_calibrator is not None:
            logits = self.dac_calibrator.predict(logits)

        probs = softmax(logits, axis=-1)

        if self.base_calibrator is None:
            return probs

        if self.base_calibration_mode == "scaling_based" and \
                self.procal_flag:
            return self.base_calibrator.predict(probs, test_proximity)
        if self.base_calibration_mode == "bin_based":
            if self.procal_flag:
                return self.base_calibrator.transform(probs, test_proximity)
            return self.base_calibrator.transform(probs)
        return probs
