"""Host-side text tokenization (own copy of the JAX package's
``data/tokenizer.py``).

The reference re-tokenizes every batch with the HF CLIPTokenizer inside the
forward pass (models/clip_backbone.py:288-303) — a CPU stall in the hot loop.
Here tokenization is a host-pipeline step producing fixed [77] int32 rows.

Two implementations:

- ``ClipBPETokenizer``: the standard CLIP byte-pair tokenizer, loading
  ``vocab.json`` + ``merges.txt`` from a local directory (the files shipped in
  every HF CLIP snapshot).  Matches HF CLIPTokenizer output for clean ASCII
  text (no ftfy normalization pass — ftfy is not in this image).
- ``HashTokenizer``: a deterministic fallback when no vocab files exist
  (tests, smoke runs): hashes whitespace words into the vocab range.  NOT for
  real training.

Both emit BOS ... EOT then zero padding; EOT carries the highest vocab id so
argmax pooling (models/text.py) finds it.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
from typing import List, Optional, Sequence

import numpy as np


@functools.lru_cache(maxsize=None)
def _bytes_to_unicode():
    """Reversible byte <-> unicode map (the GPT-2/CLIP construction)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class ClipBPETokenizer:
    """CLIP BPE tokenizer from local vocab.json/merges.txt (or bpe vocab gz)."""

    def __init__(self, vocab_dir: str, context_length: int = 77):
        import regex

        self.context_length = context_length
        vocab_path = os.path.join(vocab_dir, "vocab.json")
        merges_path = os.path.join(vocab_dir, "merges.txt")
        if os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
            with open(merges_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
            if merges and merges[0].startswith("#"):
                merges = merges[1:]
            merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        else:
            # openai-style bpe_simple_vocab_16e6.txt.gz
            gz = os.path.join(vocab_dir, "bpe_simple_vocab_16e6.txt.gz")
            raw = gzip.open(gz).read().decode("utf-8").split("\n")[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in raw]
            vocab = list(_bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )
        self.bos = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos] + self.encode_ids(text)[: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic word-hash tokenizer for offline tests/smoke runs."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.bos = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        import hashlib

        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            words = _whitespace_clean(_basic_clean(str(text))).lower().split()
            ids = [self.bos]
            for w in words[: self.context_length - 2]:
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids.append(1 + h % (self.vocab_size - 3))
            ids.append(self.eot)
            out[i, : len(ids)] = ids
        return out


class CachedTokenizer:
    """Memoizing wrapper — captions repeat every epoch, so tokenize each
    distinct string once (the reference's ``text_cache``,
    models/clip_backbone.py:174, moved out of the forward pass)."""

    def __init__(self, inner, max_entries: int = 200_000):
        self.inner = inner
        self.context_length = inner.context_length
        self.max_entries = max_entries
        self._cache: dict = {}

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        misses = [t for t in dict.fromkeys(texts) if t not in self._cache]
        miss_rows: dict = {}
        if misses:
            miss_rows = dict(zip(misses, self.inner(misses)))
            for t, row in miss_rows.items():
                if len(self._cache) >= self.max_entries:
                    break  # cache full: this batch's rows still serve below
                self._cache[t] = row
        for i, t in enumerate(texts):
            row = self._cache.get(t)
            out[i] = miss_rows[t] if row is None else row
        return out


def build_tokenizer(
    vocab_path: Optional[str],
    vocab_size: int = 49408,
    context_length: int = 77,
    cache: bool = True,
    prefer_native: bool = True,
):
    """Preference order: native C++ BPE -> Python BPE -> hashed fallback.

    A configured-but-missing vocab path raises: silently hashing captions a
    trained model has never seen would corrupt every text-involving metric.
    """
    tok = None
    if vocab_path:
        if os.path.isfile(vocab_path):  # accept .../vocab.json directly
            vocab_path = os.path.dirname(vocab_path)
        if not os.path.isdir(vocab_path):
            raise FileNotFoundError(
                f"tokenizer_vocab_path={vocab_path!r} does not exist — refusing "
                "to silently fall back to the hash tokenizer (set it to None "
                "explicitly for smoke runs)"
            )
        if prefer_native:
            try:
                from prcv2025reid_tpu_torch.data.native_tokenizer import (
                    NativeClipBPETokenizer,
                )

                tok = NativeClipBPETokenizer(vocab_path, context_length)
            except Exception as e:
                import logging

                logging.getLogger(__name__).warning(
                    "native BPE unavailable (%s: %s) — using Python BPE",
                    type(e).__name__,
                    e,
                )
                tok = None
        if tok is None:
            tok = ClipBPETokenizer(vocab_path, context_length)
    else:
        tok = HashTokenizer(vocab_size, context_length)
    return CachedTokenizer(tok) if cache else tok
