"""95th percentile of the program's batcher.queue_wait (submit to the batch's flush) over every request recorded outside the traced slice."""

import numpy as np

from portbench import program


def read(reading):
    v = program.recent("batcher.queue_wait")
    return None if v is None else 1e3 * float(np.percentile(v, 95))
