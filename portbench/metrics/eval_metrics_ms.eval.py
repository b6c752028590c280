"""Mean host ms of the program's eval.metrics span (VLClassification.evaluate) over the window's passes."""

from portbench import program


def read(reading):
    v = program.recent("eval.metrics", len(reading.spans["calib_pass"]))
    return None if v is None else 1e3 * float(v.mean())
