"""Rows per batch the DynamicBatcher flushes, from the program's batcher.rows count over the batcher.flush count; the in-program twin of batch_rows_mean.serve."""

from portbench import program


def read(reading):
    rows = program.recent("batcher.rows")
    flush = program.recent("batcher.flush")
    if rows is None or flush is None:
        return None
    return float(rows.sum()) / len(flush)
