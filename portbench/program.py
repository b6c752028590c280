"""What the readers of the program's own spans and counters share.

The port records its spans and counters in
``clip_calibration_tpu_torch/tools/profiling.py``: with no profiler
running, into a ring per name (``snapshot()``); under the traced slice's
profiler, as ``user_annotation`` events in its trace instead. A checkout
whose port has no recorder, or a name with too few values, reads as
None, and the metric is left out of the result.
"""

from __future__ import annotations

import numpy as np

#: the program's spans (``tools/profiling.py::span``), the names a gap
#: of the traced slice is put down to
SPANS = ("train.step", "train.backward", "tower.text", "tower.vision",
         "data.wait", "calib.fit", "calib.knn", "calib.score",
         "eval.metrics", "batcher.collect", "batcher.flush")


def recent(name: str, n: int = None):
    """The last ``n`` values the program recorded under ``name`` (every
    value the ring holds when ``n`` is None), oldest first; None if the
    port has no recorder or fewer than ``n`` (or no) values."""
    try:
        from clip_calibration_tpu_torch.tools.profiling import snapshot
    except ImportError:
        return None
    entry = snapshot().get(name)
    if entry is None:
        return None
    values = np.asarray(entry["recent"], np.float64)
    n = len(values) if n is None else n
    if n <= 0 or len(values) < n:
        return None
    return values[len(values) - n:]


def idle_in_span_pct(summary, name: str):
    """Idle time of the traced slice spent while ``name`` was the
    innermost program span open on the host (at each gap's middle), in %
    of the slice; None without device operations or without a ``name``
    span in the trace."""
    if not summary.device_ops:
        return None
    spans = [(s, s + d, n) for n, s, d in summary.host if n in SPANS]
    if not any(n == name for *_, n in spans):
        return None
    gaps = np.asarray(summary.gaps(), np.float64).reshape(-1, 2)
    mids = gaps.mean(axis=1)
    order = np.argsort(mids)
    mids, lengths = mids[order], (gaps[:, 1] - gaps[:, 0])[order]
    owner = np.full(len(mids), -1)
    # longest first, so the innermost (shortest) span open at a gap wins
    spans.sort(key=lambda sp: sp[0] - sp[1])
    for i, (s, e, _) in enumerate(spans):
        owner[np.searchsorted(mids, s):np.searchsorted(mids, e)] = i
    mine = np.array([n == name for *_, n in spans] + [False])
    idle_us = lengths[mine[owner]].sum()
    return 100.0 * idle_us * 1e-6 / summary.window_s
