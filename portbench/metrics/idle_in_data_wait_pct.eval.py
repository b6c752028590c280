"""Share of the traced slice in which the device was idle while the host was inside data.wait (the loader's next() in _device_staged)."""

from portbench import program


def read(reading):
    return program.idle_in_span_pct(reading.summary, "data.wait")
