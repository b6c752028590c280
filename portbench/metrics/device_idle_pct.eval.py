"""Share of the traced slice in which no operation ran on the device."""

from portbench import readers


def read(reading):
    return readers.idle_pct(reading)
