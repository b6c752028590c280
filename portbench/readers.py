"""What the per-layer metric readers (``metrics/<metric>.py``) share.

A reader takes the run's ``reading``: ``summary`` (``tracing.Summary`` of
the traced slice), ``calls`` (the K1/K2/K3 shapes launched in it, an
attention call at its real token count: ``tracing.Slice.real_calls``),
``work_bound_s`` (the least time the model work the slice
completed could take, ``flops.py``), and the driver's ``spans`` (host
seconds per call) and ``counters``. It returns a number, or None where
there is nothing to read (no device operation in the trace, no call of
the kernel), and then the metric is left out of the result.
"""

from __future__ import annotations

import statistics

from . import flops
from .bounds import bound_seconds

#: the trace names of each kernel's device functions
KERNEL_NAMES = {"k1": ("mha_qkv_fwd",), "k2": ("mha_qkv_bwd",),
                "k3": ("int8_matmul", "int8_rescale")}


def _launch_bound(kernel: str, call: tuple) -> float:
    if kernel == "k3":
        M, K, N, rescaled = call
        c = flops.k3(M, K, N, rescaled)
        return bound_seconds(c["ops"], c["bytes"], "int8")
    B, L, D3, heads, dtype = call
    c = getattr(flops, kernel)(B, L, D3, heads, dtype)
    return bound_seconds(c["ops"], c["bytes"], dtype)


def roofline_pct(reading, kernel: str):
    """The sum of the kernel's launches' bounds over its device time in
    the slice, in %."""
    calls = reading.calls.get(kernel, [])
    t = reading.summary.kernel_seconds(*KERNEL_NAMES[kernel])
    if not calls or t <= 0:
        return None
    return 100.0 * sum(_launch_bound(kernel, c) for c in calls) / t


def mfu_pct(reading):
    """The least time of the slice's model work over the slice, in %."""
    s = reading.summary
    if not s.device_ops or reading.work_bound_s <= 0:
        return None
    return 100.0 * reading.work_bound_s / s.window_s


def idle_pct(reading):
    s = reading.summary
    if not s.device_ops:
        return None
    return 100.0 * (s.window_s - s.busy_s) / s.window_s


def span_mean_ms(reading, name: str):
    values = reading.spans.get(name) or []
    return 1e3 * statistics.fmean(values) if values else None


def counter_mean(reading, name: str):
    values = reading.counters.get(name) or []
    return statistics.fmean(values) if values else None
