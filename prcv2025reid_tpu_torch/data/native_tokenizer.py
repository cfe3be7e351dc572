"""ctypes binding for the native C++ CLIP BPE tokenizer (own copy of the
JAX package's ``data/native_tokenizer.py``).

Builds ``native/clip_bpe.cpp`` on demand with g++ into the package's ``_build/``
and exposes the same interface as the Python ``ClipBPETokenizer``.  Falls
back transparently (callers use ``build_tokenizer`` which degrades to the
Python BPE, then to the hash tokenizer).
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Optional, Sequence

import numpy as np

from prcv2025reid_tpu_torch.data.native_build import build_shared_library, cache_dir

_SRC = os.path.join(os.path.dirname(__file__), "native", "clip_bpe.cpp")

_cache_dir = cache_dir  # the vocab TSVs live next to the built libraries


def build_library(force: bool = False) -> Optional[str]:
    """Compile the shared library once (atomic, see native_build.py)."""
    return build_shared_library(_SRC, "libclip_bpe.so", force=force)


def _prepare_vocab_tsv(vocab_dir: str) -> Optional[str]:
    """vocab.json -> token\tid TSV (keeps JSON parsing out of C++)."""
    vocab_json = os.path.join(vocab_dir, "vocab.json")
    merges = os.path.join(vocab_dir, "merges.txt")
    if not (os.path.exists(vocab_json) and os.path.exists(merges)):
        return None
    import hashlib

    path_key = hashlib.md5(os.path.abspath(vocab_json).encode()).hexdigest()[:12]
    tsv = os.path.join(_cache_dir(), f"vocab_{path_key}.tsv")
    if not os.path.exists(tsv) or os.path.getmtime(tsv) < os.path.getmtime(vocab_json):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        tmp = tsv + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for tok, idx in vocab.items():
                if "\t" in tok or "\n" in tok:
                    continue
                f.write(f"{tok}\t{idx}\n")
        os.replace(tmp, tsv)
    return tsv


class NativeClipBPETokenizer:
    """Drop-in for ClipBPETokenizer backed by the C++ library."""

    def __init__(self, vocab_dir: str, context_length: int = 77):
        so_path = build_library()
        if so_path is None:
            raise RuntimeError("g++ build of clip_bpe.so failed")
        tsv = _prepare_vocab_tsv(vocab_dir)
        if tsv is None:
            raise FileNotFoundError(f"no vocab.json/merges.txt under {vocab_dir}")

        self._lib = ctypes.CDLL(so_path)
        self._lib.bpe_create.restype = ctypes.c_void_p
        self._lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        self._lib.bpe_encode.restype = ctypes.c_int
        self._lib.bpe_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        self._lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        merges = os.path.join(vocab_dir, "merges.txt")
        self._handle = self._lib.bpe_create(tsv.encode(), merges.encode())
        if not self._handle:
            raise RuntimeError("bpe_create failed")

        with open(os.path.join(vocab_dir, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        self.bos = vocab["<|startoftext|>"]
        self.eot = vocab["<|endoftext|>"]
        self.context_length = context_length

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.bpe_destroy(self._handle)
        except Exception:
            pass

    def encode_ids(self, text: str):
        from prcv2025reid_tpu_torch.data.tokenizer import _basic_clean, _whitespace_clean

        buf = (ctypes.c_int * 512)()
        # normalize exactly like the Python path (double html.unescape + ws)
        text = _whitespace_clean(_basic_clean(str(text)))
        n = self._lib.bpe_encode(self._handle, text.encode("utf-8"), buf, 512)
        return list(buf[: max(0, n)])

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos] + self.encode_ids(text)[: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out
