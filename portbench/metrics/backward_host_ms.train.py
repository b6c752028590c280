"""Mean host ms of the program's train.backward span (loss.backward() in loss_step) over the window's untraced steps."""

from portbench import program


def read(reading):
    v = program.recent("train.backward",
                       len(reading.spans["forward_backward"]))
    return None if v is None else 1e3 * float(v.mean())
