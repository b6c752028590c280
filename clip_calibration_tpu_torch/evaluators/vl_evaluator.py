"""Vision-language classification evaluator.

Port of ``VLClassification`` (reference ``evaluators/vl_evaluator.py``):
accumulates logits/labels/features during the inference loop, then computes
accuracy, error rate, macro F1, mean confidence, ECE, MCE, ACE, PIECE
(x100), prints the ``=> result`` block that parse_test_res.py scrapes, and
writes the reliability-diagram PNG named after the active calibrator combo.

``process`` keeps accumulation on host numpy, matching the reference's
``.data.cpu()`` boundary. Macro F1 is computed in numpy (scikit-learn's
``f1_score(average="macro")`` semantics), and the reliability diagram is
skipped where matplotlib is absent.
"""

from __future__ import annotations

import os.path as osp
from collections import OrderedDict

import numpy as np

from ..engine.registry import EVALUATOR_REGISTRY
from ..tools import profiling
from ..tools.metrics import ECE, MCE, AdaptiveECE, PIECE
from ..tools.plot import plot_reliability_diagram


def macro_f1(labels: np.ndarray, preds: np.ndarray) -> float:
    """Mean over the classes present in ``labels`` of 2TP/(2TP+FP+FN)
    (0 for a class with no TP, FP or FN), as ``sklearn.metrics.f1_score(
    labels, preds, average="macro", labels=np.unique(labels))``."""
    scores = []
    for c in np.unique(labels):
        tp = np.sum((preds == c) & (labels == c))
        fp = np.sum((preds == c) & (labels != c))
        fn = np.sum((preds != c) & (labels == c))
        denom = 2 * tp + fp + fn
        scores.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(scores))


@EVALUATOR_REGISTRY.register()
class VLClassification:
    """Evaluator for vision-language models."""

    def __init__(self, cfg, lab2cname=None, **kwargs):
        self.cfg = cfg
        self._lab2cname = lab2cname
        self.reset()

    def reset(self):
        self._y_score = []
        self._y_true = []

    def process(self, mo, gt, image_features=None, text_features=None):
        """mo: [batch, n_cls] logits; gt: [batch] int labels.

        Accumulates logits/labels for callers that evaluate through the
        evaluator alone; the VLBaseLearner pipeline already holds these
        arrays and passes them to evaluate() directly, so features are
        deliberately NOT copied here (the reference duplicates everything
        to host lists, ``vl_evaluator.py:40-51``).
        """
        self._y_score.append(np.asarray(mo, np.float32))
        self._y_true.append(np.asarray(gt))

    @property
    def logits(self) -> np.ndarray:
        return np.concatenate(self._y_score, axis=0)

    @property
    def labels(self) -> np.ndarray:
        return np.concatenate(self._y_true, axis=0)

    @profiling.span("eval.metrics")
    def evaluate(self, probs, labels, text_proximity):
        results = OrderedDict()
        ece_bin = self.cfg.CALIBRATION.METRICS.ECE_BINS
        piece_bin = self.cfg.CALIBRATION.METRICS.PIECE_BINS

        probs = np.asarray(probs, np.float64)
        labels = np.asarray(labels)
        total = len(labels)
        preds = np.argmax(probs, axis=1)
        correct = int(np.sum(preds == labels))
        accuracy = 100.0 * correct / total
        error = 100.0 - accuracy
        f1 = 100.0 * macro_f1(labels, preds)
        confs = probs[np.arange(total), preds]
        avg_conf = float(np.mean(confs))

        ece = 100.0 * ECE(confs, preds, labels, ece_bin)
        mce = 100.0 * MCE(confs, preds, labels, ece_bin)
        ace = 100.0 * AdaptiveECE(confs, preds, labels, ece_bin)
        piece = 100.0 * PIECE(confs, np.asarray(text_proximity), preds,
                              labels, piece_bin, ece_bin)

        # The first value will be returned by trainer.test()
        results["accuracy"] = accuracy
        results["error_rate"] = error
        results["macro_f1"] = f1
        results["confidence"] = avg_conf
        results["ece"] = ece
        results["mce"] = mce
        results["ace"] = ace
        results["piece"] = piece

        print(
            "=> result\n"
            f"* total: {total:,}\n"
            f"* correct: {correct:,}\n"
            f"* accuracy: {accuracy:.2f}%\n"
            f"* error: {error:.2f}%\n"
            f"* macro_f1: {f1:.2f}%\n"
            f"* confidence: {avg_conf:.2f}%\n"
            f"* ece: {ece:.2f}%\n"
            f"* mce: {mce:.2f}%\n"
            f"* ace: {ace:.2f}%\n"
            f"* piece: {piece:.2f}%"
        )

        # reliability diagram named by the active calibrator combo
        # (reference vl_evaluator.py:119-137)
        base_name = self.cfg.DATASET.NAME + "_" + self.cfg.TRAINER.NAME
        if self.cfg.CALIBRATION.SCALING.IF_SCALING:
            base_name += "_" + str(self.cfg.CALIBRATION.SCALING.MODE)
        if self.cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME:
            base_name += "_" + str(self.cfg.CALIBRATION.BIN.BIN_CALIBRATOR_NAME)
        if self.cfg.CALIBRATION.DAC.IF_DAC:
            base_name += "_dac"
        if self.cfg.CALIBRATION.PROCAL.IF_PROCAL:
            base_name += "_procal"
        plot_dir = osp.join(self.cfg.OUTPUT_DIR, base_name + "_ece.png")
        try:
            plot_reliability_diagram(preds, confs, labels, ece_bin, None,
                                     plot_dir)
        except (OSError, ImportError) as e:  # no output dir / matplotlib
            print(f"skip reliability plot: {e}")

        return results
