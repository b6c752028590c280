"""Mean host ms of the program's batcher.flush span (stack, predict, fan-out) over every batch recorded outside the traced slice."""

from portbench import program


def read(reading):
    v = program.recent("batcher.flush")
    return None if v is None else 1e3 * float(v.mean())
