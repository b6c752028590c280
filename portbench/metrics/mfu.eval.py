"""The least time of the model work the traced slice completed (products at the cell's precision's peak) over the slice."""

from portbench import readers


def read(reading):
    return readers.mfu_pct(reading)
