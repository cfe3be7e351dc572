"""ctypes binding for the native C++ image decode+crop+resize worker (own
copy of the JAX package's ``data/native_image.py``).

Builds ``native/image_decode.cpp`` on demand (g++ -O2, linked against the
system libjpeg — the same codec PIL uses) into the package's ``_build/``.
The geometry and all randomness stay in Python (data/augment.py computes the
RandomResizedCrop box with the checkpointable RNG); the native side executes
decode+crop+resize in one pass with a PIL-matching antialiased bilinear.

Callers use :func:`decode_crop_resize`, which returns ``None`` whenever the
library is unavailable or the payload is not a decodable JPEG — the caller
then falls back to PIL (data/dataset.py::_load_image).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from prcv2025reid_tpu_torch.data.native_build import build_shared_library

_SRC = os.path.join(os.path.dirname(__file__), "native", "image_decode.cpp")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def build_library(force: bool = False) -> Optional[str]:
    """Compile the shared library once (atomic, see native_build.py)."""
    return build_shared_library(
        _SRC, "libimage_decode.so", extra_flags=("-ljpeg",), force=force
    )


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = build_library()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.decode_info.restype = ctypes.c_int
            lib.decode_info.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.decode_crop_resize.restype = ctypes.c_int
            lib.decode_crop_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def decode_info(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) of a JPEG payload, or None."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    if lib.decode_info(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_crop_resize(
    data: bytes,
    out_size: Tuple[int, int],  # (H, W)
    box: Optional[Tuple[int, int, int, int]] = None,  # (left, top, w, h)
) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W, 3], cropped to ``box`` then resized.
    None on any failure (caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    H, W = out_size
    left, top, cw, ch = box if box is not None else (0, 0, -1, -1)
    out = np.empty((H, W, 3), np.uint8)
    rc = lib.decode_crop_resize(
        data, len(data), left, top, cw, ch, W, H,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out if rc == 0 else None
