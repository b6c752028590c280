"""CLIP's byte-level BPE tokenizer, frozen for the benchmark's reference.

Follows OpenAI CLIP's ``clip/simple_tokenizer.py`` and ``clip.tokenize``
(https://github.com/openai/CLIP): lower-cased text, the GPT-2 pattern
split into letter runs, single digits and punctuation runs, each piece
merged by the 48,894 ranked merges of ``bpe_simple_vocab_16e6.txt.gz``
(beside this file, the file OpenAI ships), ``<|startoftext|>`` and
``<|endoftext|>`` around the ids, zero padding to 77.

ASCII input only: the benchmark's class names and templates are ASCII,
where the reference's ``ftfy`` repair is the identity and the pattern's
Unicode classes reduce to ``[a-z]``, ``[0-9]`` and the rest.
"""

from __future__ import annotations

import functools
import gzip
import html
import os.path as osp
import re

import numpy as np

BPE_PATH = osp.join(osp.dirname(osp.abspath(__file__)),
                    "bpe_simple_vocab_16e6.txt.gz")
SOT, EOT = "<|startoftext|>", "<|endoftext|>"
CONTEXT_LENGTH = 77
N_MERGES = 49152 - 256 - 2

_PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll"
                  r"|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def _byte_table() -> dict:
    """Byte -> printable stand-in character (GPT-2's table, in its order:
    printable bytes first, the rest shifted past 255)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class Tokenizer:
    def __init__(self, path: str = BPE_PATH):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")[1:N_MERGES + 1]
        self.merges = [tuple(ln.split()) for ln in lines]
        self.byte_table = _byte_table()
        base = list(self.byte_table.values())
        vocab = base + [c + "</w>" for c in base]
        vocab += ["".join(m) for m in self.merges] + [SOT, EOT]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.rank = {m: i for i, m in enumerate(self.merges)}

    def bpe(self, piece: str) -> list:
        word = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(self.rank.get(p), i)
                     for i, p in enumerate(zip(word, word[1:]))
                     if p in self.rank]
            if not pairs:
                break
            _, i = min(pairs)
            first, second = word[i], word[i + 1]
            out, j = [], 0
            while j < len(word):
                if (j + 1 < len(word) and word[j] == first
                        and word[j + 1] == second):
                    out.append(first + second)
                    j += 2
                else:
                    out.append(word[j])
                    j += 1
            word = out
        return word

    def encode(self, text: str) -> list:
        if not text.isascii():
            raise ValueError(f"the reference tokenizer takes ASCII text, "
                             f"not {text!r}")
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)))
        ids = []
        for piece in _PAT.findall(text.strip().lower()):
            mapped = "".join(self.byte_table[b] for b in piece.encode())
            ids += [self.encoder[t] for t in self.bpe(mapped)]
        return ids

    def tokenize(self, texts) -> np.ndarray:
        """[N, 77] int64 ids: SOT, the text's ids, EOT, zeros."""
        out = np.zeros((len(texts), CONTEXT_LENGTH), np.int64)
        for n, text in enumerate(texts):
            ids = [self.encoder[SOT]] + self.encode(text) + [self.encoder[EOT]]
            if len(ids) > CONTEXT_LENGTH:
                raise ValueError(f"{text!r} is longer than "
                                 f"{CONTEXT_LENGTH} tokens")
            out[n, :len(ids)] = ids
        return out

    def whole_words(self, first_merges: int, lengths=(3, 10)) -> list:
        """The merged tokens among the first ``first_merges`` merges that
        are a whole lower-case word (``[a-z]+</w>``) of the given lengths:
        common English words, as class names are made of."""
        lo, hi = lengths
        out = []
        for a, b in self.merges[:first_merges]:
            w = a + b
            if w.endswith("</w>") and lo <= len(w) - 4 <= hi \
                    and re.fullmatch(r"[a-z]+", w[:-4]):
                out.append(w[:-4])
        return out


@functools.lru_cache(maxsize=1)
def default() -> Tokenizer:
    return Tokenizer()
