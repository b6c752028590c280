"""Share of the traced slice in which the device was idle while the host was inside tower.vision (the innermost program span at the gap)."""

from portbench import program


def read(reading):
    return program.idle_in_span_pct(reading.summary, "tower.vision")
