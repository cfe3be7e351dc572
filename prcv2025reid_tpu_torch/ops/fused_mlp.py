"""Fused transformer MLP: the counterpart of the JAX package's
``ops/fused_mlp.py::fused_mlp``.

    out[g] = GELU(x[g] @ W1[g] + b1[g]) @ W2[g] + b2[g]

with the Abramowitz-Stegun erf GELU, f32 accumulation and bias adds, and the
hidden activation rounded to x.dtype before the second product.  The weights
are per-group effective kernels (LoRA already folded, see models/mer.py).
For CUDA tensors the wrapper launches the hand-written Hopper kernel
(csrc/fused_mlp.cu), which keeps the hidden activation on chip; for CPU
tensors it runs :func:`mlp_plain`.  A CUDA tensor the kernel does not take
raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels
from prcv2025reid_tpu_torch.ops.kernel_math import gelu_exact

MAX_WIDTH = 768  # the kernel keeps a [64, D] row tile in shared memory
WIDTH_STEP = 128  # its fc1 k-tile depth


def mlp_plain(x, w1, b1, w2, b2):
    """x [G,N,D]; w1 [G,D,F]; b1 [G,F]; w2 [G,F,D]; b2 [G,D] -> [G,N,D] in x.dtype."""
    h = torch.matmul(x.float(), w1.float()) + b1.float()[:, None, :]
    h = gelu_exact(h).to(x.dtype).float()
    o = torch.matmul(h, w2.float()) + b2.float()[:, None, :]
    return o.to(x.dtype)


def fused_mlp(x, w1, b1, w2, b2):
    """GELU(x @ w1 + b1) @ w2 + b2 per group.  x [G,N,D] bf16; w1 [G,D,F],
    w2 [G,F,D] bf16; b1 [G,F], b2 [G,D] -> [G,N,D] bf16."""
    if not x.is_cuda:
        return mlp_plain(x, w1, b1, w2, b2)
    fn = "fused_mlp"
    _kernels.require(x.dim() == 3 and w1.dim() == 3,
                     f"{fn}: x must be [G, N, D] and w1 [G, D, F]")
    G, N, D = x.shape
    F = w1.shape[-1]
    _kernels.require(
        N > 0 and D % WIDTH_STEP == 0 and D <= MAX_WIDTH and F > 0 and F % 8 == 0,
        f"{fn}: N={N} must be > 0, D={D} a multiple of {WIDTH_STEP} and <= {MAX_WIDTH}, "
        f"F={F} a positive multiple of 8")
    _kernels.bf16_operand(fn, "x", x, (G, N, D))
    _kernels.bf16_operand(fn, "w1", w1, (G, D, F))
    _kernels.bf16_operand(fn, "w2", w2, (G, F, D))
    b1f = _kernels.f32_vector(fn, "b1", b1, (G, F), x.device)
    b2f = _kernels.f32_vector(fn, "b2", b2, (G, D), x.device)
    out = torch.empty_like(x)
    c = _kernels.lib("fused_mlp").mlp
    c.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(x.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
           out.data_ptr(), G, N, D, F, _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
