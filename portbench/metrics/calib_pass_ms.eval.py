"""Mean host time from an eval pass's last logits on the host to its metrics out: DAC fit, KNN distances, calibrated scoring, the evaluator."""

from portbench import readers


def read(reading):
    return readers.span_mean_ms(reading, "calib_pass")
