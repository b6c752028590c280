"""Mean host ms of the program's calib.score span (base_learner.py::_calibrated_probs) over the window's passes."""

from portbench import program


def read(reading):
    v = program.recent("calib.score", len(reading.spans["calib_pass"]))
    return None if v is None else 1e3 * float(v.mean())
