"""Share of the batcher thread's time spent flushing: sum of batcher.flush over the sum of batcher.flush and batcher.collect."""

from portbench import program


def read(reading):
    flush = program.recent("batcher.flush")
    collect = program.recent("batcher.collect")
    if flush is None or collect is None:
        return None
    return 100.0 * float(flush.sum()) / float(flush.sum() + collect.sum())
