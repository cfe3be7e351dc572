"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` into a shared library with a
plain C interface and bound with ``ctypes``; all sources build in parallel,
one ``nvcc`` process each.  Libraries go to ``<package>/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources and flags, so
an edited source never loads a stale build.  Nothing here runs at import
time (the CPU tests import every module): ``nvcc`` runs only when a CUDA
tensor first reaches a kernel wrapper, or when ``build_all`` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("attention", "fused_block", "fused_block_int8", "fused_mlp", "fused_resln", "matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # ptxas register / shared-memory report per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's "
        "CUDA kernels build on first use and need the CUDA toolkit"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (where not built yet) and load every kernel library, running
    one nvcc per source at the same time.  Raises on any compile failure."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        if not todo:
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {n: BUILD_DIR / f"lib{n}_{_digest(n)}.so" for n in todo}
        procs = {}
        nvcc = _nvcc() if any(not t.exists() for t in targets.values()) else None
        for n, target in targets.items():
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ), tmp)
        errors = []
        for n, (proc, tmp) in procs.items():
            out, err = proc.communicate()
            build_logs[n] = out + err
            if proc.returncode != 0:
                errors.append(f"nvcc failed for csrc/{n}.cu (rc {proc.returncode}):\n{err}")
            else:
                os.replace(tmp, targets[n])
        if errors:
            raise RuntimeError("\n".join(errors))
        for n, target in targets.items():
            _libs[n] = ctypes.CDLL(str(target))
        return dict(_libs)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    return build_all()[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def no_autograd(fn: str, why: str, *tensors) -> None:
    """Raise NotImplementedError under autograd if any tensor requires grad:
    for the ops that have no backward, so none returns a result without one."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{fn}: {why}")


def bf16_operand(fn: str, name: str, t: torch.Tensor, shape) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA bf16 tensor
    of ``shape`` (what the kernels' 16-byte loads take)."""
    require(t.is_cuda, f"{fn}: {name} is on {t.device}, x is on CUDA")
    require(t.dtype == torch.bfloat16, f"{fn}: {name} must be bfloat16, got {t.dtype}")
    require(tuple(t.shape) == tuple(shape), f"{fn}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    require(t.is_contiguous() and t.data_ptr() % 16 == 0,
            f"{fn}: {name} must be contiguous and 16-byte aligned")


def f32_vector(fn: str, name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte aligned f32 tensor on ``device`` (the
    kernels read these vectors 8 or 16 bytes at a time; a view at an odd
    offset is copied); raises on another device or shape."""
    require(t.device == device, f"{fn}: {name} is on {t.device}, x is on {device}")
    require(tuple(t.shape) == tuple(shape), f"{fn}: {name} shape {tuple(t.shape)} != {tuple(shape)}")
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
