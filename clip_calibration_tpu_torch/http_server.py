"""Long-running HTTP model server with dynamic micro-batching.

A copy of ``clip_calibration_tpu/http_server.py`` (the module imports no
JAX; ``tests/test_torch_http_server.py`` pins this copy's code to the
original). The batch CLI (``serve.py``) covers offline scoring; this
module is the resident process holding a built predictor and answering
concurrent prediction requests over HTTP.

``DynamicBatcher`` coalesces concurrent single-image requests into one
device batch (bounded by the predictor's ``batch_size`` and a
``max_wait_ms`` latency budget), so N concurrent clients cost about one
encode instead of N. It calls ``predict`` from its worker thread: the
port's predictors enter their own ``torch.inference_mode`` there.

Endpoints (stdlib ``http.server``):

- ``GET /healthz``   liveness + model identity
- ``GET /classes``   the classname list (index order = prob columns)
- ``GET /stats``     request/batch counters, batch-size mean,
                     latency p50/p95 (last 1024 requests)
- ``POST /predict``  one image (``image/*`` or octet-stream body), or
                     ``application/json`` ``{"images": [<base64>, ...]}``
                     -> calibrated predictions (same math as the CLI:
                     DAC confidences / temperature ride the Predictor)

Start via the CLI: ``python -m clip_calibration_tpu_torch.serve --http
HOST:PORT --backbone ... --classnames ...``.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Callable, Optional, Sequence

import numpy as np

from .tools import profiling


class DynamicBatcher:
    """Coalesce concurrent single-image requests into device batches.

    One worker thread drains a queue: it blocks for the first pending
    request, then gathers more until ``max_batch`` items are in hand or
    ``max_wait_ms`` has elapsed since the first, stacks them into one
    ``predict_fn`` call, and routes row ``i`` of every output array to
    request ``i``'s Future. A lone request therefore pays at most
    ``max_wait_ms`` of extra latency; a burst of ``max_batch`` requests
    pays one encode. Exceptions from ``predict_fn`` propagate to every
    Future in the failed batch; per-item results are plain dicts of
    numpy rows.

    The worker records the spans ``batcher.collect`` (from the wait for
    a batch's first request to the batch's close) and ``batcher.flush``,
    each request's ``batcher.queue_wait`` (submit to flush) and each
    batch's ``batcher.rows`` (``tools/profiling.py``).
    """

    _SENTINEL = object()

    def __init__(self, predict_fn: Callable[[np.ndarray], dict],
                 max_batch: int, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._predict = predict_fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._q: Queue = Queue()
        self._closed = False
        # appended by the worker thread, read by handler threads
        # (/stats) — deque appends are atomic but iteration during an
        # append is not, so snapshots go through the lock
        self._sizes_lock = threading.Lock()
        self._batch_sizes: deque = deque(maxlen=1024)
        self._worker = threading.Thread(
            target=self._loop, name="dynamic-batcher", daemon=True)
        self._worker.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one [H, W, 3] uint8 image; the Future resolves to a
        dict with this image's row of every predictor output. Raises
        after ``close()`` (a racing submit may instead resolve with the
        shutdown error below)."""
        if self._closed:
            raise RuntimeError("DynamicBatcher is closed")
        fut: Future = Future()
        fut.queued_ns = time.perf_counter_ns()
        self._q.put((np.asarray(image), fut))
        return fut

    def close(self) -> None:
        self._closed = True
        self._q.put(self._SENTINEL)
        self._worker.join(timeout=10)
        # fail fast for requests that raced the sentinel into the queue
        # — otherwise their Futures would hang until the caller timeout
        while True:
            try:
                item = self._q.get_nowait()
            except Empty:
                return
            if item is not self._SENTINEL:
                item[1].set_exception(
                    RuntimeError("server shut down before this request "
                                 "was scheduled"))

    def snapshot_sizes(self) -> list:
        with self._sizes_lock:
            return list(self._batch_sizes)

    def _loop(self) -> None:
        while True:
            with profiling.span("batcher.collect") as collect:
                item = self._q.get()
                if item is self._SENTINEL:
                    # the wait after the last batch is idle, not work
                    collect.cancel()
                    return
                items = [item]
                deadline = time.monotonic() + self._max_wait
                while len(items) < self._max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except Empty:
                        break
                    if nxt is self._SENTINEL:
                        collect.cancel()
                        self._flush(items)
                        return
                    items.append(nxt)
            self._flush(items)

    @profiling.span("batcher.flush")
    def _flush(self, items) -> None:
        for _, fut in items:
            profiling.observe("batcher.queue_wait",
                              (time.perf_counter_ns() - fut.queued_ns) * 1e-9)
        profiling.count("batcher.rows", len(items))
        with self._sizes_lock:
            self._batch_sizes.append(len(items))
        # EVERYTHING routes through the futures — an exception escaping
        # here would kill the worker and hang every later request
        try:
            batch = np.stack([img for img, _ in items])
            out = self._predict(batch)
            rows = [{k: v[i] for k, v in out.items()}
                    for i in range(len(items))]
        except Exception as e:  # noqa: BLE001 — route to the waiters
            for _, fut in items:
                fut.set_exception(e)
            return
        for row, (_, fut) in zip(rows, items):
            fut.set_result(row)


class PredictionServer(ThreadingHTTPServer):
    """HTTP front end over a built ``serving.Predictor`` (or any object
    with ``.predict(uint8 [N, H, W, 3]) -> {"probs", "preds",
    "confidences"}``).

    ``transform``: host-side eval-geometry callable (PIL image -> uint8
    [H, W, 3]), normally ``serve._host_transform``'s product so the
    server's geometry matches the batch CLI / training eval exactly.
    """

    daemon_threads = True
    # many clients connect in one burst when a fleet retries together;
    # the stdlib default backlog of 5 resets the overflow instead of
    # queueing it (measured under benchmarks/bench_http.py load)
    request_queue_size = 128

    def __init__(self, addr, predictor, classnames: Sequence[str],
                 transform: Callable, topk: int = 1,
                 max_wait_ms: float = 5.0,
                 max_batch: Optional[int] = None,
                 backbone: str = ""):
        super().__init__(addr, _Handler)
        self.predictor = predictor
        self.classnames = list(classnames)
        self.transform = transform
        self.topk = max(1, min(topk, len(self.classnames)))
        self.backbone = backbone
        self.started = time.time()
        # mutated by concurrent handler threads, read by /stats
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.latencies_ms: deque = deque(maxlen=1024)
        self.batcher = DynamicBatcher(
            predictor.predict,
            max_batch or getattr(predictor, "batch_size", 64),
            max_wait_ms=max_wait_ms)

    def server_close(self) -> None:  # noqa: D102 — stdlib override
        self.batcher.close()
        super().server_close()

    # ---- request-side helpers (called from handler threads) ----

    def decode_image(self, data: bytes) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        return np.asarray(self.transform(img))

    def format_row(self, row: dict) -> dict:
        probs = row["probs"]
        out = {
            "pred": self.classnames[int(row["preds"])],
            "confidence": round(float(row["confidences"]), 6),
        }
        if self.topk > 1:
            order = np.argsort(-probs)[:self.topk]
            out["topk"] = [{"class": self.classnames[int(j)],
                            "prob": round(float(probs[j]), 6)}
                           for j in order]
        return out

    def record_request(self, n_rows: int, latency_ms: float) -> None:
        with self._stats_lock:
            self.requests += n_rows
            self.latencies_ms.append(latency_ms)

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self.latencies_ms)
            requests = self.requests
        sizes = self.batcher.snapshot_sizes()
        return {
            "requests": requests,
            "batches": len(sizes),
            "mean_batch": round(float(np.mean(sizes)), 2) if sizes
            else None,
            "p50_latency_ms": round(lat[len(lat) // 2], 2) if lat
            else None,
            "p95_latency_ms": round(lat[int(len(lat) * 0.95)], 2)
            if lat else None,
            "uptime_s": round(time.time() - self.started, 1),
        }


class _Handler(BaseHTTPRequestHandler):
    server: PredictionServer  # typing aid

    # Nagle + delayed-ACK stalls cost ~40 ms per response on small
    # writes — an order of magnitude over the whole prediction path
    disable_nagle_algorithm = True
    # keep-alive: concurrent clients reuse connections instead of a
    # TCP handshake per prediction
    protocol_version = "HTTP/1.1"

    # quiet per-request stderr logging; /stats carries the counters
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — stdlib API
        s = self.server
        if self.path == "/healthz":
            self._json(200, {
                "status": "ok", "backbone": s.backbone,
                "classes": len(s.classnames),
                "max_batch": s.batcher._max_batch})
        elif self.path == "/classes":
            self._json(200, {"classnames": s.classnames})
        elif self.path == "/stats":
            self._json(200, s.stats())
        else:
            self._json(404, {"error": f"no such path: {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — stdlib API
        # ALWAYS drain the body first: on keep-alive connections
        # (protocol 1.1) an unread body would be parsed as the next
        # request line, desyncing every later request on the socket
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        if self.path != "/predict":
            self._json(404, {"error": f"no such path: {self.path}"})
            return
        s = self.server
        t0 = time.monotonic()
        try:
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype == "application/json":
                payload = json.loads(data)
                blobs = [base64.b64decode(b)
                         for b in payload.get("images", [])]
                if not blobs:
                    self._json(400, {"error": 'JSON body needs "images":'
                                              ' [<base64>, ...]'})
                    return
            else:
                if not data:
                    self._json(400, {"error": "empty request body"})
                    return
                blobs = [data]
            imgs = [s.decode_image(b) for b in blobs]
        except Exception as e:  # noqa: BLE001 — client error surface
            self._json(400, {"error": f"bad request: {e!r}"})
            return
        try:
            # submit all before waiting so a multi-image request
            # coalesces with itself (and any concurrent requests)
            futs = [s.batcher.submit(img) for img in imgs]
            rows = [s.format_row(f.result(timeout=120)) for f in futs]
        except Exception as e:  # noqa: BLE001 — model error surface
            self._json(500, {"error": f"prediction failed: {e!r}"})
            return
        s.record_request(len(rows), (time.monotonic() - t0) * 1e3)
        if ctype == "application/json":
            self._json(200, {"predictions": rows})
        else:
            self._json(200, rows[0])


def serve_http(addr: str, predictor, classnames, transform,
               topk: int = 1, max_wait_ms: float = 5.0,
               backbone: str = "") -> PredictionServer:
    """Bind ``HOST:PORT`` (``:0`` picks a free port) and return the
    server WITHOUT entering the serve loop — callers (CLI, tests) own
    ``serve_forever()`` / shutdown."""
    host, _, port = addr.rpartition(":")
    server = PredictionServer(
        (host or "127.0.0.1", int(port)), predictor, classnames,
        transform, topk=topk, max_wait_ms=max_wait_ms,
        backbone=backbone)
    return server
