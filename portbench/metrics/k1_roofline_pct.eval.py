"""K1 (mha_qkv_fwd): the sum of its launches' bounds (flops.k1, bounds.py) over its device time in the traced slice."""

from portbench import readers


def read(reading):
    return readers.roofline_pct(reading, "k1")
