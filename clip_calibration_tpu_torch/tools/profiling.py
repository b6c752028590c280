"""Profiling and timing utilities; counterpart of
``clip_calibration_tpu/tools/profiling.py``.

``trace`` (and ``Tracer``, its start/stop form) records ``torch.profiler``
CPU and CUDA activity and writes a Chrome trace (``trace_<pid>.json``,
viewable in Perfetto or ``chrome://tracing``) into its directory; the JAX
package's ``trace`` writes an XProf directory
(``plugins/profile/<run>/*.xplane.pb``) instead. The config-driven path
(``TPU.PROFILE_DIR`` traces the first ``TPU.PROFILE_STEPS`` train steps of
epoch 0) lives in ``engine/trainer.py::run_epoch``.

The program's own spans and counters: ``span(name)`` (a context manager,
or a decorator for a whole function), ``observe(name, seconds)`` (a
duration the caller measured, e.g. across threads), ``count(name, n)``
and ``snapshot()``. With no profiler running, a span reads
``perf_counter_ns`` twice and writes its duration into the name's ring
(the last ``RING`` values, preallocated; a count and a total with no
cap); it never enters ``record_function``, takes no lock and grows
nothing. Each name is written by one thread at a time. While a profiler
runs (``trace``, ``TPU.PROFILE_DIR``, a benchmark's traced slice) a span
is a ``record_function`` instead, on the thread the profiler traces (the
one that started it): it lands in the Chrome trace nested in its parent,
on the kernels' clock, and nothing goes into the rings; on any other
thread it is in neither (no annotation is left open there when the
profiler stops). A span open when a profiler starts goes into neither;
one open when it stops goes into no ring, and the trace holds it cut at
the stop (marked ``"finished": false``). A profiler started and stopped
wholly inside one span is not seen.

``time_ms`` is the port's kernel timer on the card (cold inputs, CUDA
events).
"""

from __future__ import annotations

import array
import contextlib
import functools
import os
import os.path as osp
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

#: values kept per name, most recent last
RING = 1 << 16


class _Series:
    """One name's record: how many values, their sum, and the last
    ``RING`` of them."""

    __slots__ = ("kind", "count", "total", "ring")

    def __init__(self, kind: str):
        self.kind = kind
        self.count = 0
        self.total = 0.0
        self.ring = array.array("d", bytes(8 * RING))

    def add(self, value) -> None:
        self.ring[self.count % RING] = value
        self.count += 1
        self.total += value

    def recent(self) -> np.ndarray:
        ring = np.frombuffer(self.ring, np.float64)
        if self.count <= RING:
            return ring[:self.count].copy()
        at = self.count % RING
        return np.concatenate([ring[at:], ring[:at]])


_SERIES = {}


def _series(name: str, kind: str) -> _Series:
    try:
        return _SERIES[name]
    except KeyError:
        return _SERIES.setdefault(name, _Series(kind))


#: stands in on a span's stack for a timing the span's owner cancelled
_CANCELLED = object()


class _Span:
    """The reusable span of one name (``span(name)``). Its stack holds,
    per open use, the start in ns, or the ``record_function`` entered
    when a profiler was running."""

    __slots__ = ("name", "series", "_open")

    def __init__(self, name: str):
        self.name = name
        self.series = _series(name, "span")
        self._open = []

    def __enter__(self) -> "_Span":
        if not _autograd_profiler._is_profiler_enabled:
            self._open.append(time.perf_counter_ns())
        elif torch.autograd._profiler_enabled():
            annotation = torch.profiler.record_function(self.name)
            annotation.__enter__()
            self._open.append(annotation)
        else:
            # a thread the profiler does not trace (the serving batcher's):
            # an annotation there would stay open across the profiler's
            # stop on its own thread, e.g. while this thread blocks in a
            # queue, so the use goes into neither the trace nor the ring
            self._open.append(_CANCELLED)
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._open.pop()
        if type(t0) is int:
            dt = time.perf_counter_ns() - t0
            if not _autograd_profiler._is_profiler_enabled:
                self.series.add(dt * 1e-9)
        elif t0 is not _CANCELLED:
            t0.__exit__(None, None, None)
        return False

    def cancel(self) -> None:
        """Leave the innermost open use out of the ring (a trace still
        shows it)."""
        if type(self._open[-1]) is int:
            self._open[-1] = _CANCELLED

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


_SPANS = {}


def span(name: str) -> _Span:
    """The span ``name``: ``with span(name):`` around a block, or
    ``@span(name)`` on a function."""
    try:
        return _SPANS[name]
    except KeyError:
        return _SPANS.setdefault(name, _Span(name))


def observe(name: str, seconds: float) -> None:
    """Records a duration measured by the caller (none while a profiler
    runs)."""
    if not _autograd_profiler._is_profiler_enabled:
        _series(name, "observe").add(seconds)


def count(name: str, n) -> None:
    """Adds ``n`` to the count ``name`` (not while a profiler runs)."""
    if not _autograd_profiler._is_profiler_enabled:
        _series(name, "count").add(n)


def snapshot() -> dict:
    """Per name: ``count`` (values recorded), ``total_s`` (their sum; a
    count's is ``total``, in its own units) and ``recent`` (the last
    ``RING`` values, oldest first)."""
    out = {}
    for name, s in list(_SERIES.items()):
        out[name] = {"count": s.count,
                     "total" if s.kind == "count" else "total_s": s.total,
                     "recent": s.recent()}
    return out


# written between timed calls: 5x the H100's 50 MB L2, so every timed call
# reads its inputs from device memory
L2_FLUSH_BYTES = 256 << 20


class Tracer:
    """``torch.profiler`` over CPU activity, and CUDA activity when a card
    is present, from ``start()`` to ``stop()``; ``stop`` waits for the
    queued work of ``device`` (default: the current card) first, since a
    train step only enqueues it, then writes the Chrome trace to
    ``path``."""

    def __init__(self, log_dir: str, device=None):
        self.path = osp.join(log_dir, f"trace_{os.getpid()}.json")
        self.device = device
        self._prof = None

    def start(self) -> "Tracer":
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(osp.dirname(self.path), exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.start()
        return self

    def stop(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        elif self.device is None and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        return self._prof


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager around ``torch.profiler``: yields the ``Tracer``
    (its ``path`` is the Chrome trace written on exit)."""
    tracer = Tracer(log_dir).start()
    try:
        yield tracer
    finally:
        tracer.stop()


def time_ms(fn, flush: torch.Tensor, repeats: int = 25) -> float:
    """Device time of one call with cold inputs: median over ``repeats``
    of the CUDA-event time around one call, each after ``flush`` (a
    tensor larger than L2) is overwritten. A sleep kernel keeps the card
    busy while the host queues the calls, so the host's launch overhead
    is not in the number."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(repeats)]
    torch.cuda._sleep(20_000_000)  # ~10 ms of device time
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
