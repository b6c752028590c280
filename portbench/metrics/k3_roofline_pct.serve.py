"""K3 (int8_matmul and its split-K rescale): the sum of its launches' bounds (flops.k3, bounds.py) over its device time in the traced slice."""

from portbench import readers


def read(reading):
    return readers.roofline_pct(reading, "k3")
