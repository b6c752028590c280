"""Mean host ms of the program's tower.vision span (models/clip.py::encode_image) over the window's untraced steps."""

from portbench import program


def read(reading):
    v = program.recent("tower.vision",
                       len(reading.spans["forward_backward"]))
    return None if v is None else 1e3 * float(v.mean())
