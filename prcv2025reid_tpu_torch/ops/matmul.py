"""The tiled matmul of the roofline microbenchmark: the counterpart of the
JAX tool's ``tools/perf_microbench.py::_pallas_matmul``.

    tiled_matmul(x [M, K], w [K, N])   bf16 x bf16 -> bf16 (f32 accumulators)
                                       int8 x int8 -> int32 (exact)

For CUDA tensors the wrapper launches the hand-written Hopper kernel
(csrc/matmul.cu); for CPU tensors it runs :func:`matmul_plain`.  A CUDA tensor
the kernel does not take raises; it never falls back.  ``block_rows`` (64, 128
or 256) is the kernel's row tile, the counterpart of the TPU probe's row-block
sweep: it never changes the result.  Unlike the TPU kernel, whose grid of
``M // block_rows`` steps leaves a ragged tail of rows unwritten, every row is
computed.  The int8 weight must be stored K-major (an [K, N] view of [N, K]
storage, as ``fused_block.quantize_weight`` writes it): 8-bit ``wgmma``
reads both operands K-major only.  Like the JAX tool's kernel it has no
backward: it raises under autograd rather than return a result without one.
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels

BLOCK_ROWS = (64, 128, 256)
COL_TILE = 128
K_TILE = {"bf16": 32, "int8": 64}


def _mode(x: torch.Tensor, w: torch.Tensor) -> str:
    if x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return "bf16"
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        return "int8"
    raise ValueError(f"tiled_matmul: takes bfloat16 x bfloat16 or int8 x int8, got "
                     f"{x.dtype} x {w.dtype}")


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What the kernel computes.  bf16: the f32 product of the bf16 operands,
    rounded to bf16.  int8: the product in float64, exact (|acc| <= 127^2 K <
    2^53) on every device (CUDA has no int32 matmul), as int32."""
    if _mode(x, w) == "bf16":
        return torch.matmul(x.float(), w.float()).to(torch.bfloat16)
    return torch.matmul(x.double(), w.double()).to(torch.int32)


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, block_rows: int = 128) -> torch.Tensor:
    """x [M, K] @ w [K, N]: bf16 -> bf16 or int8 -> int32 (see the module
    docstring).  On the card K must be a multiple of the k-tile (32 bf16, 64
    int8 values) and N of 128."""
    fn = "tiled_matmul"
    _kernels.no_autograd(fn, "the microbenchmark's matmul has no backward (nor has the JAX "
                         "tool's Pallas kernel)", x, w)
    mode = _mode(x, w)
    _kernels.require(block_rows in BLOCK_ROWS,
                     f"{fn}: block_rows={block_rows}; valid: {list(BLOCK_ROWS)}")
    _kernels.require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
                     f"{fn}: x [M, K] @ w [K, N], got {tuple(x.shape)} @ {tuple(w.shape)}")
    if not x.is_cuda:
        return matmul_plain(x, w)
    (M, K), N = x.shape, w.shape[1]
    _kernels.require(M > 0 and K % K_TILE[mode] == 0 and N % COL_TILE == 0,
                     f"{fn}: M={M} must be > 0, K={K} a multiple of {K_TILE[mode]} and "
                     f"N={N} of {COL_TILE}")
    if mode == "bf16":
        _kernels.bf16_operand(fn, "x", x, (M, K))
        _kernels.bf16_operand(fn, "w", w, (K, N))
        out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    else:
        _kernels.require(w.device == x.device, f"{fn}: w is on {w.device}, x is on {x.device}")
        _kernels.require(x.is_contiguous() and x.data_ptr() % 16 == 0,
                         f"{fn}: x must be contiguous and 16-byte aligned")
        _kernels.require(w.t().is_contiguous() and w.data_ptr() % 16 == 0,
                         f"{fn}: int8 w must be stored K-major ([N, K] contiguous behind the "
                         "[K, N] view: w.t().contiguous().t()) and 16-byte aligned")
        out = torch.empty(M, N, dtype=torch.int32, device=x.device)
    c = getattr(_kernels.lib("matmul"), f"matmul_{mode}")
    c.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, block_rows,
           _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
