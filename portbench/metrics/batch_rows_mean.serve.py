"""Mean rows per predict call the DynamicBatcher makes, counted by the benchmark's wrapper of the predict function."""

from portbench import readers


def read(reading):
    return readers.counter_mean(reading, "batch_rows")
