"""Byte-level BPE tokenizer for CLIP text inputs.

Clean-room implementation of the byte-pair-encoding scheme used by OpenAI
CLIP (behavioral parity target: reference ``clip/simple_tokenizer.py``
and ``clip/clip.py:188-224``; verified against golden fixtures in
``tests/fixtures/tokenizer_golden.json``). Vocab size 49408 = 256 byte
symbols + 256 end-of-word variants + 48894 merges + 2 specials; context
length 77 with <|startoftext|> / <|endoftext|> framing.

Tokenization is setup-time work (class names and templates, not the hot
path), so this is plain Python; the resulting ids feed a jit'd embedding
lookup on device.

Note: the reference pipes text through ftfy.fix_text (mojibake repair,
``clip/simple_tokenizer.py:50-55``). Dataset class names and prompt
templates are ASCII, where fix_text is the identity; for non-ASCII input
``_fix_text`` below repairs the dominant mojibake class (UTF-8 bytes
mis-decoded as cp1252/latin-1) and NFC-normalizes, then html-unescape +
whitespace normalization + lowercasing as in the reference.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Dict, List, Tuple

import numpy as np
import regex as re

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BPE_PATH = os.path.join(
    _HERE, "..", "assets", "bpe_simple_vocab_16e6.txt.gz")

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77

# GPT-2-style pre-tokenization pattern (public): contractions, letter runs,
# single digits, punctuation runs; case-insensitive.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """Invertible byte -> printable-unicode-char map (GPT-2 scheme).

    Printable latin bytes map to themselves; the rest are shifted into the
    256+ private range so every byte has a visible single-char stand-in.
    """
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    # Insertion order matters: the BPE vocab enumerates this table in order
    # (printable keeps first, then shifted extras), so ids depend on it.
    table: Dict[int, str] = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


# Mojibake detector: UTF-8 lead byte followed by a continuation byte,
# both as mis-decoded single-byte-codepage characters. Valid lead bytes
# 0xC2-0xF4 render as latin-1 letters (Â-ï for 2/3-byte sequences,
# ð-ô for the 4-byte emoji/astral range); continuation bytes 0x80-0xBF
# render as latin-1 U+0080-U+00BF or, under cp1252, as its printable
# remappings of 0x80-0x9F. Counting PAIRS (not lone accented letters)
# keeps legitimate accents out: an isolated accent has a plain-ASCII
# neighbor and never forms a pair.
_CONT_CHARS = "".join(chr(c) for c in range(0x80, 0xC0)) + "".join(
    bytes([b]).decode("cp1252", "ignore") for b in range(0x80, 0xA0))
_MOJIBAKE_MARKS = re.compile(
    "[\xc2-\xf4][" + re.escape(_CONT_CHARS) + "]")


def _c1_passthrough(err):
    """codecs error handler: encode C1 controls (undefined in cp1252:
    0x81 0x8D 0x8F 0x90 0x9D) as their raw byte values — ftfy's "sloppy
    cp1252" behavior for round-tripping mojibake."""
    chunk = err.object[err.start:err.end]
    if any(ord(c) > 0xFF for c in chunk):
        raise err
    return bytes(ord(c) for c in chunk), err.end


import codecs  # noqa: E402  (handler registration belongs next to it)

codecs.register_error("clipcal_c1", _c1_passthrough)


def _fix_text(text: str) -> str:
    """Minimal ftfy.fix_text stand-in (reference
    ``clip/simple_tokenizer.py:50-55``): undo UTF-8-as-cp1252/latin-1
    mojibake when the round-trip decodes cleanly and removes marker
    characters, then NFC-normalize. Identity on ASCII."""
    if text.isascii():
        return text
    score = len(_MOJIBAKE_MARKS.findall(text))
    if score:
        for enc in ("cp1252", "latin-1"):
            try:
                candidate = text.encode(enc, "clipcal_c1").decode("utf-8")
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
            if len(_MOJIBAKE_MARKS.findall(candidate)) < score:
                text = candidate
                break
    return unicodedata.normalize("NFC", text)


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class CLIPTokenizer:
    """Encoder/decoder over the 49408-entry CLIP BPE vocabulary."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self._b2u = _byte_unicode_table()
        self._u2b = {c: b for b, c in self._b2u.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a header; the vocab uses the first 48894 merge rules
        n_merges = 49152 - 256 - 2 + 1 - 1
        merges: List[Tuple[str, str]] = []
        for ln in lines[1:1 + n_merges]:
            a, b = ln.split()
            merges.append((a, b))

        base = list(self._b2u.values())  # insertion order, not byte order
        vocab: List[str] = list(base)
        vocab.extend(c + "</w>" for c in base)
        vocab.extend(a + b for a, b in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in
                                        self.encoder.items()}
        self._rank: Dict[Tuple[str, str], int] = {
            pair: i for i, pair in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {
            SOT_TOKEN: [SOT_TOKEN], EOT_TOKEN: [EOT_TOKEN]}

    # -- properties ----------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TOKEN]

    # -- BPE core ------------------------------------------------------------
    def _bpe(self, piece: str) -> List[str]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached

        if len(piece) == 1:
            out = [piece + "</w>"]
            self._cache[piece] = out
            return out

        word: List[str] = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            # find the adjacent pair with the best (lowest) merge rank
            best_rank = None
            best_i = -1
            for i in range(len(word) - 1):
                r = self._rank.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            # merge every occurrence of that pair, left to right
            a, b = word[best_i], word[best_i + 1]
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged

        self._cache[piece] = word
        return word

    # -- public API ------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _PAT.findall(_clean(text)):
            mapped = "".join(self._b2u[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytes(self._u2b[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Tokenize text(s) into an [N, context_length] int32 array.

    Matches ``clip.tokenize`` (reference ``clip/clip.py:188-224``):
    <sot> ids <eot>, zero padding, error on overflow unless ``truncate``
    (which clips and forces the last token to <eot>).
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for n, text in enumerate(texts):
        ids = [tok.sot_id] + tok.encode(text) + [tok.eot_id]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = tok.eot_id
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}")
        out[n, :len(ids)] = ids
    return out
