"""Mean host time of one forward_backward call over the window's untraced steps (no sync: what the host takes to enqueue a step)."""

from portbench import readers


def read(reading):
    return readers.span_mean_ms(reading, "forward_backward")
