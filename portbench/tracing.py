"""The traced slice of a ``--trace 1`` run.

``Slice`` profiles a bounded part of the window with ``torch.profiler``
(CPU and, on a card, CUDA activity), marked by a ``bench.slice``
annotation, and records the shapes of every K1, K2 and K3 call the port
makes meanwhile by wrapping the entry points the port looks up at call
time (``ops.attention.mha_qkv``, ``ops.mha_qkv.mha_qkv_bwd``,
``ops.int8_matmul.kernel_product``). The device is drained on entry and
exit, so the calls recorded are the kernels traced. An attention call's
token count is the data's, not the pad's: the port pads the token axis
and masks the padded keys out, so after the slice the count of each
recorded mask's columns that some query attends to replaces the padded
length (``real_calls``). The Chrome trace goes
to a temporary file when ``summary`` is first read (after the window),
is read into a ``Summary`` and deleted.

``NoSlice`` stands in when the run is not traced: nothing is wrapped.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Recorder:
    """Stands in for a port entry point: records each call's arguments,
    then calls it. Other attributes (the entries' ``launches`` counters,
    which the port bumps through the module-level name) are the entry's
    own."""

    def __init__(self, fn, record):
        self.__dict__["_fn"], self.__dict__["_record"] = fn, record

    def __call__(self, *args, **kwargs):
        self._record(*args, **kwargs)
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def short_name(name: str, width: int = 100) -> str:
    """A device operation's name without its return type and argument
    list, cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<[{":
            depth += 1
        elif ch in ">]}":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and \
                not name[:i].endswith("anonymous namespace") and \
                name[i - 1] not in ":":
            name = name[:i]
            break
    return name if len(name) <= width else name[:width - 3] + "..."


class NoSlice:
    on = False
    done = True  # nothing to trace

    def prepare(self):
        pass

    def start(self):
        pass

    def stop(self):
        pass


class Slice:
    def __init__(self):
        self.on = False
        self.done = False
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self._masks: Dict[int, torch.Tensor] = {}
        self.t0 = self.t1 = None
        self._prof = None
        self._annotation = None
        self._restore = []
        self._summary: Optional["Summary"] = None

    # -- shape recorders ---------------------------------------------------
    def _wrap(self, module, name, record):
        fn = getattr(module, name)
        setattr(module, name, _Recorder(fn, record))
        self._restore.append((module, name, fn))

    def _install(self):
        from clip_calibration_tpu_torch.ops import attention, int8_matmul
        from clip_calibration_tpu_torch.ops import mha_qkv as mq

        def attention_call(kernel):
            def record(qkv, mask, *args):
                if qkv.device.type == "cuda":
                    # a reference keeps the mask's address unique; it is
                    # read after the slice, so nothing syncs inside it
                    self._masks.setdefault(id(mask), mask)
                    self.calls[kernel].append((*qkv.shape, args[-1],
                                               str(qkv.dtype)[6:],
                                               id(mask)))
            return record

        def k3(x, w, w_t=None, xs=None, w_scale=None, dtype=None):
            self.calls["k3"].append((x.shape[0], x.shape[1], w.shape[1],
                                     xs is not None))

        self._wrap(attention, "mha_qkv", attention_call("k1"))
        self._wrap(mq, "mha_qkv_bwd", attention_call("k2"))
        self._wrap(int8_matmul, "kernel_product", k3)

    def _uninstall(self):
        for module, name, fn in reversed(self._restore):
            setattr(module, name, fn)
        self._restore = []

    # -- the slice -----------------------------------------------------------
    @staticmethod
    def _activities():
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def prepare(self):
        """Start and stop the profiler once, so that the slice's own start
        does not pay its first-use set-up (seconds) inside the window."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            pass

    def start(self):
        if self.on or self.done:
            return
        from torch.profiler import profile
        _sync()
        self._prof = profile(activities=self._activities())
        self._prof.start()
        self._install()
        self._annotation = torch.profiler.record_function("bench.slice")
        self._annotation.__enter__()
        self.on = True
        self.t0 = time.perf_counter()

    def stop(self):
        """Ends the slice; the trace is read at the first use of
        ``summary``, so a stop inside the window costs only the drain."""
        if not self.on:
            return
        _sync()
        self.t1 = time.perf_counter()
        self._annotation.__exit__(None, None, None)
        self._uninstall()
        self._prof.stop()
        self.on, self.done = False, True

    def real_calls(self) -> Dict[str, List[tuple]]:
        """The recorded calls with each attention call's padded length
        replaced by its mask's real token count: (B, L, D3, heads, dtype)
        for K1 and K2, (M, K, N, rescaled) for K3."""
        real = {}
        for key, mask in self._masks.items():
            attended = mask.float().amax(dim=0) \
                > torch.finfo(torch.float32).min / 2
            real[key] = int(attended.sum())
        out = {k: list(v) for k, v in self.calls.items()}
        for kernel in ("k1", "k2"):
            out[kernel] = [(B, real[key], D3, heads, dtype)
                           for B, _, D3, heads, dtype, key
                           in self.calls.get(kernel, [])]
        return out

    @property
    def summary(self) -> "Summary":
        if self._summary is None and self._prof is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self._summary = Summary(json.load(f)["traceEvents"])
            finally:
                os.remove(path)
            self._prof = None
        return self._summary


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Summary:
    """What a traced slice read: device operations (name, start, duration
    in us), the slice's window, the device's busy time in it, and host
    events to name idle gaps by."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == "bench.slice"
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no bench.slice annotation")
        self.w0 = float(win[0]["ts"])
        self.w1 = self.w0 + float(win[0]["dur"])
        self.device_ops = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                self.device_ops.append((e["name"], s, d))
            elif e.get("cat") in ("cpu_op", "user_annotation",
                                  "cuda_runtime", "cuda_driver") \
                    and e["name"] != "bench.slice":
                self.host.append((e["name"], s, d))
        busy = _union((max(s, self.w0), min(s + d, self.w1))
                      for _, s, d in self.device_ops
                      if s + d > self.w0 and s < self.w1)
        self.busy_intervals = busy
        self.busy_us = sum(e - s for s, e in busy)
        self._host = None

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    def kernel_seconds(self, *names: str) -> float:
        """Device seconds of the operations whose name contains any of
        ``names``."""
        return 1e-6 * sum(d for n, _, d in self.device_ops
                          if any(k in n for k in names))

    def top_ops(self, n: int = 10):
        tot = defaultdict(float)
        for name, _, d in self.device_ops:
            tot[short_name(name)] += d * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def gaps(self):
        """Idle stretches of the window: [start, end) in us."""
        out, at = [], self.w0
        for s, e in self.busy_intervals:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < self.w1:
            out.append((at, self.w1))
        return out

    def host_label(self, t: float) -> str:
        """What the host was doing at trace time ``t``: the innermost
        ``bench.*`` annotation and the innermost other host event open
        then."""
        if self._host is None:
            names = [h[0] for h in self.host]
            arr = np.array([h[1:3] for h in self.host] or np.zeros((0, 2)),
                           np.float64)
            bench = np.array([n.startswith("bench.") for n in names], bool)
            self._host = (names, arr[:, 0], arr[:, 0] + arr[:, 1],
                          arr[:, 1], bench)
        names, s, e, d, bench = self._host
        parts = []
        for pick in (bench, ~bench):
            idx = np.nonzero(pick & (s <= t) & (t < e))[0]
            if len(idx):
                parts.append(names[idx[np.argmin(d[idx])]])
        return " > ".join(parts) if parts else "host idle"

    def idle_by_host(self, n: int = 10, labelled: int = 200):
        """Idle seconds by what the host was doing at each gap's middle,
        the largest first; the ``labelled`` longest gaps are named, the
        rest summed under one entry."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        tot = defaultdict(float)
        for s, e in gaps[:labelled]:
            tot[self.host_label((s + e) / 2)] += (e - s) * 1e-6
        rest = gaps[labelled:]
        if rest:
            longest = (rest[0][1] - rest[0][0])
            tot[f"{len(rest)} gaps of at most {longest:.1f} us"] = sum(
                (e - s) * 1e-6 for s, e in rest)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]
