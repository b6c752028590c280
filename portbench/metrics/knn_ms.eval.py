"""Mean host ms of the program's calib.knn span (proximity.py::get_knn_dists) over the window's passes."""

from portbench import program


def read(reading):
    v = program.recent("calib.knn", len(reading.spans["calib_pass"]))
    return None if v is None else 1e3 * float(v.mean())
