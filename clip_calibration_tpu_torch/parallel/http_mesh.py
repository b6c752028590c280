"""HTTP serving over a process mesh: rank 0 serves, every other rank joins
each batch.

A predictor on a mesh (``serving.Predictor(mesh=...)``, or a
``TrainerPredictor`` over a trainer built on one) is SPMD: every rank
calls ``predict`` with the same images, and the collectives inside it
pair up. The HTTP server (``http_server.py``, a copy of the JAX module)
runs on rank 0 alone, where its ``DynamicBatcher`` coalesces requests into
batches. So rank 0 serves through ``MeshPredictor``: before each batch's
``predict`` it broadcasts a header (rows, H, W, C) and the uint8 batch
over the world group, and ``follow``, on every other rank, receives them
and runs the same ``predict``, dropping the result. ``stop`` broadcasts
the stop code, on which ``follow`` returns. While no batch comes, rank 0
broadcasts a no-op header every ``HEARTBEAT_S`` seconds, so a follower
waiting in its collective never reaches the process group's timeout.

The predictor's input checks (``check_images``) run on rank 0 before
anything is sent: a request it rejects raises there alone, and no rank
waits in a collective for it.

The JAX package needs none of this: one controller drives every device
and serves HTTP over any mesh (``clip_calibration_tpu/serve.py``).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: header row counts that carry no batch
STOP, BEAT = -1, 0
#: seconds without a broadcast after which rank 0 sends a no-op header;
#: far below the process groups' collective timeouts (10 min or more)
HEARTBEAT_S = 60.0


def _transport(device: torch.device) -> torch.device:
    """Where the broadcast tensors live: the card under NCCL, the CPU
    under gloo (``parallel/mesh.py::initialize_distributed``)."""
    if dist.get_backend() == "nccl":
        return device
    return torch.device("cpu")


def _use(device: torch.device) -> None:
    """The calling thread's current card (the CUDA current device is per
    thread: the batcher's worker and the heartbeat run on threads of
    their own)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class MeshPredictor:
    """Rank 0's front of a mesh predictor: ``predict`` sends each batch to
    the other ranks (``follow``), then runs the predictor's own
    ``predict``. Thread-safe; ``stop`` ends the followers."""

    def __init__(self, predictor, device):
        self.predictor = predictor
        self.batch_size = predictor.batch_size
        self.device = torch.device(device)
        self._transport = _transport(self.device)
        self._lock = threading.Lock()
        self._stopped = False
        self._last = time.monotonic()
        self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                      name="mesh-heartbeat")
        self._beat.start()

    def predict(self, images: np.ndarray) -> dict:
        images = self.predictor.check_images(images)
        if images.size == 0:  # no device work, no collective
            return self.predictor.predict(images)
        batch = torch.from_numpy(np.array(images, np.uint8, order="C"))
        with self._lock:
            if self._stopped:
                raise RuntimeError("the mesh has stopped serving")
            _use(self.device)
            self._send(images.shape)
            dist.broadcast(batch.to(self._transport), src=0)
            return self.predictor.predict(images)

    def stop(self) -> None:
        """Broadcast the stop code once; later ``predict`` calls raise."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            _use(self.device)
            self._send((STOP, 0, 0, 0))

    def _send(self, header) -> None:
        dist.broadcast(torch.tensor(header, dtype=torch.int64,
                                    device=self._transport), src=0)
        self._last = time.monotonic()

    def _heartbeat(self) -> None:
        while True:
            time.sleep(HEARTBEAT_S / 4)
            with self._lock:
                if self._stopped:
                    return
                if time.monotonic() - self._last >= HEARTBEAT_S:
                    _use(self.device)
                    self._send((BEAT, 0, 0, 0))


def follow(predictor, device) -> int:
    """Join every batch rank 0's ``MeshPredictor`` sends, until its stop
    code; returns the number of batches joined. A batch whose ``predict``
    raises here raised on rank 0 too (the same inputs, the same code), so
    the error is printed and the loop goes on, as rank 0's server does."""
    device = torch.device(device)
    transport = _transport(device)
    _use(device)
    joined = 0
    while True:
        header = torch.empty(4, dtype=torch.int64, device=transport)
        dist.broadcast(header, src=0)
        rows, h, w, c = header.tolist()
        if rows == STOP:
            return joined
        if rows == BEAT:
            continue
        batch = torch.empty((rows, h, w, c), dtype=torch.uint8,
                            device=transport)
        dist.broadcast(batch, src=0)
        try:
            predictor.predict(batch.cpu().numpy())
        except Exception:  # noqa: BLE001 — rank 0 answers it with a 500
            traceback.print_exc(file=sys.stderr)
        joined += 1
