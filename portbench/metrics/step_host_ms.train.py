"""Mean host ms of the program's train.step span (trainers/base_learner.py::loss_step) over the window's untraced steps; the in-program twin of host_enqueue_ms.train."""

from portbench import program


def read(reading):
    v = program.recent("train.step", len(reading.spans["forward_backward"]))
    return None if v is None else 1e3 * float(v.mean())
