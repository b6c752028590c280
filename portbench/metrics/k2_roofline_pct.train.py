"""K2 (mha_qkv_bwd): the sum of its launches' bounds (flops.k2, bounds.py) over its device time in the traced slice."""

from portbench import readers


def read(reading):
    return readers.roofline_pct(reading, "k2")
