"""Faults planted in the port under the benchmark, to show that
``correct`` catches them (``test_portbench_contract.py`` on the CPU,
``controls.py`` on the card). Each ``plant(name)`` patches one entry of
the port and returns the function that undoes it.

- ``unchanged``: the optimizer step leaves the trained tensors as they
  were (training cells);
- ``half_batch``: the loss of a step is the mean over the first half of
  its batch only (training cells);
- ``answer_altered``: each answer's two largest probabilities trade
  places where the answer is produced (the eval cell's calibrated
  probabilities, the serving Predictor's output).
"""

from __future__ import annotations

import numpy as np

#: the faults each driver's cells can have
FAULTS = {"train": ("unchanged", "half_batch"),
          "eval": ("answer_altered",), "serve": ("answer_altered",)}


def _swap_top2(probs: np.ndarray) -> np.ndarray:
    probs = np.array(probs, copy=True)
    top = np.argsort(probs, axis=1)[:, -2:]
    rows = np.arange(len(probs))
    a, b = probs[rows, top[:, 0]].copy(), probs[rows, top[:, 1]].copy()
    probs[rows, top[:, 0]], probs[rows, top[:, 1]] = b, a
    return probs


def _patch(owner, name, value):
    old = owner.__dict__[name]
    setattr(owner, name, value)
    return lambda: setattr(owner, name, old)


def plant(fault: str, driver: str):
    if fault not in FAULTS[driver]:
        raise ValueError(f"{driver} cells have no fault {fault!r}")
    if fault == "unchanged":
        from clip_calibration_tpu_torch.engine.trainer import TrainerX

        def step(self, name):
            self._models[name]["step"] += 1
        return _patch(TrainerX, "optimizer_step", step)
    if fault == "half_batch":
        from clip_calibration_tpu_torch.trainers.coop import CoOp
        loss = CoOp._loss

        def half(self, images, labels):
            n = images.shape[0] // 2
            return loss(self, images[:n], labels[:n])
        return _patch(CoOp, "_loss", half)
    if driver == "eval":
        from clip_calibration_tpu_torch.trainers.base_learner import \
            VLBaseLearner
        probs = VLBaseLearner._calibrated_probs

        def altered(self, *args, **kwargs):
            return _swap_top2(probs(self, *args, **kwargs))
        return _patch(VLBaseLearner, "_calibrated_probs", altered)
    from clip_calibration_tpu_torch.serving import Predictor
    predict = Predictor.predict

    def altered_predict(self, images):
        out = predict(self, images)
        probs = _swap_top2(out["probs"])
        return {"probs": probs, "preds": probs.argmax(axis=1),
                "confidences": probs.max(axis=1)}
    return _patch(Predictor, "predict", altered_predict)
