"""The one generator of the benchmark's traffic.

A traffic file (``traffic/<name>.json``) holds numbers only; everything a
run feeds the port is drawn here from ``--seed``, each stream from its
own sub-seed, so the same seed gives the same inputs:

- class names: 1-4 common English words each (the share of names of each
  word count is the file's ``class_words``), distinct, drawn from the
  whole-word tokens of CLIP's BPE vocabulary;
- images: uint8 [n, res, res, 3], uniform bytes, made on the device;
- labels: uniform class ids;
- arrivals: the send times of an open loop of Poisson arrivals at the
  file's rate.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .reference import tokenizer

#: sub-seed stream ids (one per kind of input)
STREAMS = {"weights": 1, "ctx": 2, "names": 3, "base_names": 4,
           "images": 5, "labels": 6, "arrivals": 7, "calibration": 8,
           "base_images": 9, "sample": 10}


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed of its own for one stream of one run seed."""
    ss = np.random.SeedSequence([int(seed), STREAMS[stream], int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream, index))


def class_names(traffic: dict, seed: int, n: int, stream: str = "names",
                exclude=()) -> List[str]:
    """``n`` distinct names of 1-4 words, none in ``exclude``."""
    words = tokenizer.default().whole_words(traffic["vocab_merges"])
    shares = traffic["class_words"]
    counts = np.array([int(k) for k in shares])
    p = np.array([shares[k] for k in shares], np.float64)
    g = rng(seed, stream)
    seen, out = set(exclude), []
    while len(out) < n:
        k = int(g.choice(counts, p=p / p.sum()))
        name = " ".join(words[i] for i in g.integers(0, len(words), k))
        if name not in seen:
            seen.add(name)
            out.append(name)
    return out


def images(seed: int, n: int, res: int, device, stream: str = "images",
           index: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, stream, index))
    return torch.randint(0, 256, (n, res, res, 3), generator=gen,
                         device=device, dtype=torch.uint8)


def labels(seed: int, n: int, n_cls: int, index: int = 0) -> np.ndarray:
    return rng(seed, "labels", index).integers(0, n_cls, n).astype(np.int64)


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Send times (s from the window's start) of a Poisson process."""
    g = rng(seed, "arrivals")
    n = int(rate * seconds * 1.2) + 64
    t = np.cumsum(g.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(g.exponential(1.0 / rate,
                                                               n))])
    return t[t < seconds]


def sample(seed: int, n: int, k: int) -> np.ndarray:
    """``k`` sorted distinct indices of ``n`` (all when k >= n)."""
    if k >= n:
        return np.arange(n)
    return np.sort(rng(seed, "sample").choice(n, k, replace=False))
