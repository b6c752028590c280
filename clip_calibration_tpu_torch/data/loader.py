"""Data manager and batch loader.

Equivalent of Dassl's ``DataManager`` as the trainers consume it
(reference ``trainers/calibration/tempscaling.py:123-143`` overrides
``build_data_loader``; trainers read ``dm.dataset.classnames``,
``train_loader_x``, ``val_loader``, ``test_loader``).

The loader is host-side: PIL decode + geometric transform in a thread pool
(image decode releases the GIL), batches emitted as uint8 NHWC numpy plus
int labels. Normalization happens on device (ops/preprocess.py). Batch
shapes are static per loader (last partial batch is padded for the eval
path and the pad mask reported) so jit never retraces.

Batches are produced by a background prefetch thread (queue depth
``PREFETCH_DEPTH``) so host decode/transform of batch N+1 overlaps device
execution of batch N — the torch reference gets the same overlap from
DataLoader(num_workers=8). Epoch order is fixed before the thread starts,
so prefetching never changes which samples land in which batch. Each
train item's random crop and flip come from its own ``random.Random``,
seeded from (loader seed, epoch, the item's place in the epoch order), so
batches are the same bytes whatever the number of worker threads and
however they are scheduled.

On a process mesh (``parallel/mesh.py``) every rank walks the same global
batches and decodes only its data coordinate's slice of each (ranks
along the model axis get the same rows); the item draws follow the
global positions, so the slices together are the single-process batch.
A partial eval batch is padded to the full size before it is sliced.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

PREFETCH_DEPTH = 2
_DONE = object()

import numpy as np
from PIL import Image

from ..engine.registry import DATASET_REGISTRY
from .base import Datum
from .transforms import build_transform


def _load_image(impath: str, draft_size: int = 0) -> Image.Image:
    img = Image.open(impath)
    if draft_size:
        # JPEG decode-time downscaling: libjpeg decodes at 1/2, 1/4 or
        # 1/8 DCT scale, chosen so BOTH dims stay >= draft_size — the
        # shorter-side resize that follows still has full target
        # resolution to work from. 2-4x faster decode for typical
        # (~500px) sources at 224 targets; a no-op for non-JPEG files.
        # Pixel values differ slightly from a full decode (reduced-scale
        # IDCT), so this is OPT-IN (DATALOADER.JPEG_DRAFT) and off for
        # parity-exact runs.
        img.draft("RGB", (draft_size, draft_size))
    return img


class DataLoader:
    """Iterates a Datum list in batches of transformed uint8 images.

    Train mode: shuffles each epoch (seeded), drops the last partial batch.
    Eval mode: sequential, keeps the partial batch (padded + mask).
    """

    def __init__(self, data_source: Sequence[Datum], batch_size: int,
                 transform: Callable, is_train: bool,
                 num_workers: int = 4, seed: int = 0,
                 pad_partial: bool = True, draft_size: int = 0,
                 cache_mb: int = 0):
        self.data_source = list(data_source)
        self.batch_size = batch_size
        self.transform = transform
        self.is_train = is_train
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.pad_partial = pad_partial
        self.draft_size = draft_size
        self.epoch = 0
        # multi-rank: every rank iterates the SAME global epoch order and
        # batch boundaries (the seeded shuffle is rank-independent) but
        # decodes only its data coordinate's slice of each global batch;
        # ``n_real`` stays the GLOBAL real-row count so the gathered
        # outputs can be trimmed. Set by DataManager from the mesh: ranks
        # along the model axis share a data coordinate and get the same
        # rows.
        self.rank, self.world = 0, 1
        # decoded-image RAM cache (DATALOADER.DECODE_CACHE_MB): the
        # protocol is 200 epochs over a ~1.6k-image few-shot set, so
        # re-paying JPEG decode every epoch is pure waste. Post-decode
        # RGB uint8 arrays are cached across epochs; the RANDOM part of
        # the pipeline (RandomResizedCrop/flip) still runs per epoch, so
        # batches are bit-identical with the cache on or off
        # (transforms.py converts to RGB before any geometry, and
        # convert("RGB") is idempotent). Inserts stop at the size cap —
        # no eviction; a partially warm cache still amortizes that slice.
        self._cache = {} if cache_mb > 0 else None
        self._cache_left = cache_mb * (1 << 20)
        self._cache_lock = threading.Lock()

    def __len__(self):
        n = len(self.data_source)
        if self.is_train:
            # Dassl semantics: drop_last only when a full batch exists —
            # a dataset smaller than the batch size yields ONE partial
            # batch instead of silently training nothing
            return n // self.batch_size if n >= self.batch_size else 1
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> List[int]:
        idxs = list(range(len(self.data_source)))
        if self.is_train:
            rng = random.Random(self.seed * 100003 + self.epoch)
            rng.shuffle(idxs)
        return idxs

    def _decoded(self, impath: str) -> Image.Image:
        """Decoded source image, served from the RAM cache when on.

        ``Image.fromarray`` wraps the cached array without copying;
        every downstream PIL op allocates a new image, so the cached
        bytes are never mutated."""
        if self._cache is None:
            return _load_image(impath, self.draft_size)
        arr = self._cache.get(impath)
        if arr is None:
            img = _load_image(impath, self.draft_size).convert("RGB")
            arr = np.asarray(img, np.uint8)
            with self._cache_lock:
                if impath not in self._cache \
                        and arr.nbytes <= self._cache_left:
                    self._cache[impath] = arr
                    self._cache_left -= arr.nbytes
        return Image.fromarray(arr)

    def _item_rng(self, pos: int) -> random.Random:
        """The draws of the item at place ``pos`` of this epoch's order."""
        return random.Random(
            (self.seed * 100003 + self.epoch) * 1000003 + pos)

    def _make_batch(self, pool, idxs, b):
        bs = self.batch_size
        chunk = idxs[b * bs:(b + 1) * bs]
        items = [self.data_source[i] for i in chunk]
        n_real = len(items)
        # each item's draws follow its place in the GLOBAL batch, so a
        # rank's slice gets the draws a single process gives those rows
        pos = list(range(b * bs, b * bs + n_real))
        if self.world > 1:
            if n_real < bs:
                if self.is_train:
                    # padding a TRAIN batch would up-weight the duplicated
                    # rows against the single-process run (which trains
                    # on the real rows only)
                    raise ValueError(
                        f"multi-rank training needs full batches: got "
                        f"{n_real} samples for batch size {bs}; shrink "
                        f"the batch or grow the dataset")
                items = items + [items[-1]] * (bs - n_real)
            pb = bs // self.world
            items = items[self.rank * pb:(self.rank + 1) * pb]
            pos = pos[self.rank * pb:(self.rank + 1) * pb]
        if self.is_train:
            rngs = [self._item_rng(p) for p in pos]
            imgs = list(pool.map(
                lambda it, r: self.transform(self._decoded(it.impath), r),
                items, rngs))
        else:
            imgs = list(pool.map(
                lambda it: self.transform(self._decoded(it.impath)), items))
        labels = np.asarray([it.label for it in items], np.int32)
        if self.world == 1 and not self.is_train and self.pad_partial \
                and n_real < bs:
            pad = bs - n_real
            imgs = imgs + [imgs[-1]] * pad
            labels = np.concatenate(
                [labels, np.full(pad, labels[-1], np.int32)])
        return {
            "img": np.stack(imgs),
            "label": labels,
            "n_real": n_real,
            "impath": [it.impath for it in items],
        }

    def __iter__(self):
        idxs = self._order()
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        stop = threading.Event()

        def _put(item) -> bool:
            """Blocking put that aborts when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(
                        max_workers=self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        if not _put(self._make_batch(pool, idxs, b)):
                            return
                _put(_DONE)
            except BaseException as exc:  # surface in the consumer
                _put(exc)

        t = threading.Thread(target=producer, daemon=True,
                             name="loader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class DataManager:
    """Builds the dataset (registry lookup on cfg.DATASET.NAME) and the
    train/val/test loaders."""

    def __init__(self, cfg, custom_tfm_train=None, custom_tfm_test=None,
                 mesh=None):
        self.cfg = cfg
        dataset_cls = DATASET_REGISTRY.get(cfg.DATASET.NAME)
        self.dataset = dataset_cls(cfg)

        tfm_train = custom_tfm_train or build_transform(cfg, is_train=True)
        tfm_test = custom_tfm_test or build_transform(cfg, is_train=False)

        nw = cfg.DATALOADER.NUM_WORKERS
        seed = max(cfg.SEED, 0)
        # opt-in JPEG decode-time downscaling (see _load_image) — EVAL
        # loaders only: their geometry is a whole-image shorter-side
        # resize, so keeping both dims >= the target preserves full
        # output resolution. The train path's RandomResizedCrop can
        # crop a small region (scale down to 0.08) and upsample it, so
        # a draft-decoded source would feed visibly lower-detail crops,
        # not the "slightly different pixels" contract; construct a
        # DataLoader(draft_size=...) directly if that trade is wanted.
        draft = (max(cfg.INPUT.SIZE)
                 if getattr(cfg.DATALOADER, "JPEG_DRAFT", False) else 0)

        # decoded-image cache for the loaders that replay across epochs:
        # train (the 200-epoch few-shot protocol) and val (TempScaling
        # re-points train_loader_x at it and iterates it every scaling
        # epoch, plus best_val evals). The test loader runs once — no
        # cache, no memory spent on it.
        cache_mb = int(getattr(cfg.DATALOADER, "DECODE_CACHE_MB", 0))

        self.train_loader_x = DataLoader(
            self.dataset.train_x, cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
            tfm_train, is_train=True, num_workers=nw, seed=seed,
            cache_mb=cache_mb)
        self.val_loader = None
        if self.dataset.val:
            self.val_loader = DataLoader(
                self.dataset.val, cfg.DATALOADER.TEST.BATCH_SIZE,
                tfm_test, is_train=False, num_workers=nw, seed=seed,
                draft_size=draft, cache_mb=cache_mb)
        self.test_loader = DataLoader(
            self.dataset.test, cfg.DATALOADER.TEST.BATCH_SIZE,
            tfm_test, is_train=False, num_workers=nw, seed=seed,
            draft_size=draft)

        # multi-rank: each data coordinate decodes its slice of every
        # global batch (``mesh``: parallel/mesh.py)
        world = mesh.dims[0] if mesh is not None else 1
        if world > 1:
            for ld in (self.train_loader_x, self.val_loader,
                       self.test_loader):
                if ld is None:
                    continue
                if ld.batch_size % world:
                    raise ValueError(
                        f"batch size {ld.batch_size} not divisible by "
                        f"the mesh's data axis ({world} ranks)")
                ld.rank, ld.world = mesh.data_coord, world

    @property
    def num_classes(self):
        return self.dataset.num_classes

    @property
    def lab2cname(self):
        return self.dataset.lab2cname
