"""Serving: single images from independent clients, an open loop.

Set-up builds the port's ``Predictor`` over ``n_classes`` seeded class
names and the zero-shot template, quantized as the traffic says (w8a8:
static activation scales calibrated on ``calibration_images`` seeded
images), puts it behind ``http_server.DynamicBatcher`` with the serve
CLI's defaults (``max_batch`` rows, ``max_wait_ms``), and warms every
batch bucket a coalesced batch can take (1, 2, 4, ... ``max_batch``).
The HTTP front and image decoding are left out: requests enter as the
front hands them on, uint8 [res, res, 3].

The window sends request i (image i modulo a pool of ``image_pool``
seeded images) at the i-th arrival of a Poisson process of
``rate_per_s``, from one generator thread that submits every request
that is due whenever it wakes. A request's latency runs from its due
time to its answer, so a late generator adds to it. After the last send
every request gets until a minute past the window to be answered; one
that fails or is not answered by then is ``failed``, with its latency
taken as the wait until then. ``serve_p95_ms`` is the 95th percentile of
the latencies of all requests due in the window.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from .. import flops as FL
from .. import traffic as T
from ..bounds import op_seconds
from . import common


class Driver:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic

    def setup(self):
        from clip_calibration_tpu_torch.http_server import DynamicBatcher
        from clip_calibration_tpu_torch.serving import Predictor
        run, tr = self.run, self.tr
        model, ccfg, self.weights = common.port_model(run)
        self.names = T.class_names(tr, run.seed, tr["n_classes"])
        res = run.config["image_resolution"]
        self.cal = T.images(run.seed, tr["calibration_images"], res,
                            run.device, "calibration")
        with common.backbone(model, ccfg):
            self.pred = Predictor(
                run.config["model"], self.names, template=tr["template"],
                precision=run.config["precision"],
                batch_size=tr["max_batch"], quantize=tr["quantize"],
                calibration_images=self.cal.cpu().numpy(),
                device=run.device)
        del model
        self.pool = T.images(run.seed, tr["image_pool"], res,
                             run.device).cpu().numpy()
        b = 1
        while b <= tr["max_batch"]:
            self.pred.predict(self.pool[:b])
            b *= 2
        self.calls = []  # (start, end, rows) of every predict call
        self._lock = threading.Lock()
        self.batcher = DynamicBatcher(self._predict, tr["max_batch"],
                                      max_wait_ms=tr["max_wait_ms"])
        vis = FL.vision_forward(run.config)
        products = "int8" if tr["quantize"] == "w8a8" else "bfloat16"
        self.image_bound_s = (op_seconds(vis["products"], products)
                              + op_seconds(vis["attention"], "bfloat16"))

    def _predict(self, images):
        a = time.perf_counter()
        with torch.profiler.record_function("bench.predict"):
            out = self.pred.predict(images)
        with self._lock:
            self.calls.append((a, time.perf_counter(), len(images)))
        return out

    def window(self, seconds: float, tracer) -> dict:
        tr = self.tr
        due = T.arrivals(self.run.seed, tr["rate_per_s"], seconds)
        n, P = len(due), len(self.pool)
        done = np.full(n, np.nan)
        late = np.zeros(n)
        # answers go straight into arrays: the harness keeps no future or
        # row object alive that a server would not
        self.probs = np.zeros((n, len(self.names)), np.float32)
        self.answered = np.zeros(n, bool)
        self.calls = []
        left = [n]
        all_done = threading.Event()
        gc_pauses = _GcPauses()
        t0 = time.perf_counter() + 0.01

        def answered(i):
            def cb(fut):
                done[i] = time.perf_counter() - t0
                if fut.exception() is None:
                    self.probs[i] = fut.result()["probs"]
                    self.answered[i] = True
                with self._lock:
                    left[0] -= 1
                    if left[0] == 0:
                        all_done.set()
            return cb

        # the slice is the window's last seconds and the answers still
        # due after them: the profiler stops (a drain and a flush) once
        # every request is answered, with no thread running an operation
        trace_from = seconds - tr["trace_last_seconds"]
        i = 0
        with gc_pauses:
            while i < n:
                now = time.perf_counter() - t0
                if now >= trace_from:
                    tracer.start()
                if due[i] > now:
                    time.sleep(due[i] - now)
                    continue
                while i < n and due[i] <= now:
                    late[i] = now - due[i]
                    self.batcher.submit(self.pool[i % P]).add_done_callback(
                        answered(i))
                    i += 1
            end = max(seconds, time.perf_counter() - t0) + 60.0
            all_done.wait(timeout=max(end - (time.perf_counter() - t0), 0.0))
            tracer.stop()
        stop = time.perf_counter() - t0
        missing = np.isnan(done) | ~self.answered
        lat = np.where(missing, stop, done) - due
        self.window_calls = list(self.calls)
        self.latency = (due, lat)
        return {"metrics": {"serve_p95_ms": float(
                    np.percentile(lat, 95) * 1e3)},
                "attempted": n, "failed": int(missing.sum()),
                "notes": {"requests": n,
                          "latency_p50_ms": float(np.median(lat) * 1e3),
                          "generator_late_p50_ms": float(
                              np.median(late) * 1e3),
                          "generator_late_max_ms": float(late.max() * 1e3),
                          "predict_calls": len(self.window_calls),
                          "gc_pauses": gc_pauses.count,
                          "gc_pause_max_ms": gc_pauses.longest * 1e3}}

    def reading(self, tracer):
        from types import SimpleNamespace
        a, b = tracer.t0, tracer.t1
        inside = [c for c in self.window_calls if c[0] >= a and c[1] <= b]
        outside = [c for c in self.window_calls if c[1] < a or c[0] > b]
        return SimpleNamespace(
            summary=tracer.summary, calls=tracer.real_calls(),
            work_bound_s=sum(c[2] for c in inside) * self.image_bound_s,
            spans={}, counters={"batch_rows": [c[2] for c in outside]})

    def release(self):
        self.batcher.close()
        # the requests of each predict call, in the batcher's FIFO order
        served = np.repeat([c[2] for c in self.window_calls],
                           [c[2] for c in self.window_calls])
        n = len(self.answered)
        self.served_rows = np.zeros(n, np.int64)
        self.served_rows[:len(served)] = served[:n]
        del self.pred, self.batcher
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        want = self._reference({"w8a8": "int8"}[self.tr["quantize"]])
        return compare(self.probs, self.answered, self.served_rows, want)

    def control(self, products: str = "int4") -> dict:
        """The numbers of the reference computed in ``products`` put in
        the program's place, for the same requests."""
        low = self._reference(products)
        idx = np.arange(len(self.answered)) % len(self.pool)
        probs = np.where((self.served_rows == 1)[:, None], low[True][idx],
                         low[False][idx])
        return compare(probs, self.answered, self.served_rows,
                       self._reference({"w8a8": "int8"}[
                           self.tr["quantize"]]))

    def _reference(self, products: str) -> dict:
        """Probabilities of every pool image by the reference in
        ``products``, with static (False) and per-row (True) scales."""
        from ..reference import coop_ref
        from ..reference.clip_ref import ReferenceCLIP, normalize
        run, tr = self.run, self.tr
        ref = ReferenceCLIP(run.config, self.weights, products)
        ref.calibrate(self.cal)
        txt = coop_ref.zeroshot_features(ref, self.names, tr["template"])
        pool = torch.as_tensor(self.pool, device=run.device)
        scale = ref.logit_scale()
        want = {}
        for dynamic in (False, True):
            img = normalize(ref.image_features(pool, dynamic=dynamic))
            want[dynamic] = torch.softmax(scale * img @ txt.T, dim=-1) \
                .double().cpu().numpy()
        return want


class _GcPauses:
    """Counts the interpreter's garbage collections inside the block and
    keeps the longest (every thread waits while one runs)."""

    def __init__(self):
        self.count, self.longest, self._t = 0, 0.0, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.longest = max(self.longest, time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def compare(probs, answered, served_rows, want) -> dict:
    """The largest gap, over every answered request, between its
    probabilities and the reference's for its image, under the scales the
    port uses for a batch of its size (a lone row: dynamic)."""
    idx = np.arange(len(probs)) % len(want[False])
    ref = np.where((served_rows == 1)[:, None], want[True][idx],
                   want[False][idx])
    gap = np.abs(probs - ref).max(axis=1)
    return {"prob_gap": float(gap[answered].max(initial=0.0))}
