"""Profiling and timing utilities; counterpart of
``clip_calibration_tpu/tools/profiling.py``.

``trace`` (and ``Tracer``, its start/stop form) records ``torch.profiler``
CPU and CUDA activity and writes a Chrome trace (``trace_<pid>.json``,
viewable in Perfetto or ``chrome://tracing``) into its directory; the JAX
package's ``trace`` writes an XProf directory
(``plugins/profile/<run>/*.xplane.pb``) instead. The config-driven path
(``TPU.PROFILE_DIR`` traces the first ``TPU.PROFILE_STEPS`` train steps of
epoch 0) lives in ``engine/trainer.py::run_epoch``.

``StepTimer`` is the JAX package's, unchanged. ``time_ms`` is the port's
kernel timer on the card (cold inputs, CUDA events).
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import statistics
import subprocess
import time

import torch

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


class StepTimer:
    """Aggregates per-step wall times; report() returns summary stats."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def report(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[int(n * 0.9)],
            "max_s": ts[-1],
        }


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
