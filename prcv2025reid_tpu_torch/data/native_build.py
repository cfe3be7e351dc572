"""Shared build helper for the port's native C++ data-path libraries (own
copy of the JAX package's ``data/native_build.py``).

Both ctypes bindings (``data/native_image.py``, ``data/native_tokenizer.py``)
compile their .cpp from ``data/native/`` on demand into the package's own
``_build/`` directory (git-ignored), never into a directory shared with
another package: the library names are the same as the JAX package's, and
the freshness check below compares modification times only, so a shared
directory could load the other package's build.  This module owns the two
behaviors both bindings must share exactly:

- **Atomic builds**: g++ writes to a per-pid temp file which is os.replace'd
  into place, so concurrent pipeline workers racing on a cold build
  directory can never observe (or persist) a partially written .so — an
  interrupted/timed-out build leaves no artifact behind.
- **Guarded freshness check**: a built .so next to a missing or unreadable
  source file is used as-is instead of raising out of the data path.
- **One rebuild of a library that does not load**: the freshness check
  compares modification times only, so a ``_build/`` copied from another
  host (another glibc or libjpeg) passes it and then fails ``ctypes.CDLL``;
  :func:`load_shared_library` rebuilds such a library once and loads it
  again.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Optional, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# so_name -> why its last build failed (g++'s stderr), for callers that must
# report it (chip_smoke.py tells a missing jpeglib.h from a broken build)
build_errors: Dict[str, str] = {}


def cache_dir() -> str:
    """The directory the native libraries (and the tokenizer's vocab TSVs)
    are built into: ``prcv2025reid_tpu_torch/_build/``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def build_shared_library(
    src: str,
    so_name: str,
    extra_flags: Sequence[str] = (),
    force: bool = False,
) -> Optional[str]:
    """Compile ``src`` into ``<_build>/<so_name>`` once; path or None."""
    so_path = os.path.join(cache_dir(), so_name)
    if os.path.exists(so_path) and not force:
        try:
            fresh = os.path.getmtime(so_path) >= os.path.getmtime(src)
        except OSError:
            # Source missing/unreadable: the built library is all we have.
            return so_path
        if fresh:
            return so_path
    if not os.path.exists(src):
        return None
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
             *extra_flags, "-o", tmp_path],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp_path, so_path)
        build_errors.pop(so_name, None)
        return so_path
    except Exception as e:
        err = getattr(e, "stderr", None) or str(e)
        build_errors[so_name] = err.decode(errors="replace") if isinstance(err, bytes) else err
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None


def load_shared_library(
    src: str, so_name: str, extra_flags: Sequence[str] = ()
) -> Optional[ctypes.CDLL]:
    """The built library, loaded; None where it cannot be built.  A library
    that is built but does not load is rebuilt once (``force=True``) and
    loaded again; if that rebuild fails, or its load fails too, the load's
    OSError propagates."""
    path = build_shared_library(src, so_name, extra_flags)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        path = build_shared_library(src, so_name, extra_flags, force=True)
        if path is None:
            raise
        return ctypes.CDLL(path)
