"""Mean host ms of the program's tower.text span (models/clip.py::encode_text_embedded) over the window's untraced steps."""

from portbench import program


def read(reading):
    v = program.recent("tower.text", len(reading.spans["forward_backward"]))
    return None if v is None else 1e3 * float(v.mean())
