"""Fused transformer MLP: the counterpart of the JAX package's
``ops/fused_mlp.py::fused_mlp``.

    out[g] = GELU(x[g] @ W1[g] + b1[g]) @ W2[g] + b2[g]

with the Abramowitz-Stegun erf GELU, f32 accumulation and bias adds, and the
hidden activation rounded to x.dtype before the second product.  The weights
are per-group effective kernels (LoRA already folded, see models/mer.py).
For CUDA tensors the wrapper launches the hand-written Hopper kernels
(csrc/fused_mlp.cu: fc1 with the bias and GELU in its epilogue, then fc2,
both on the wgmma + TMA GEMM core, h passed between them through a bf16
buffer the wrapper allocates; one launch of the fused kernel); for CPU
tensors it runs :func:`mlp_plain`.  A CUDA tensor the kernels do not take
raises; it never falls back.  Both run inside one ``torch.autograd.Function``
whose backward, :func:`mlp_backward`, is the JAX op's f32 recompute on every
device.
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels
from prcv2025reid_tpu_torch.ops.kernel_math import INV_SQRT_2PI, SQRT_HALF, gelu_exact

def mlp_plain(x, w1, b1, w2, b2):
    """x [G,N,D]; w1 [G,D,F]; b1 [G,F]; w2 [G,F,D]; b2 [G,D] -> [G,N,D] in x.dtype."""
    h = torch.matmul(x.float(), w1.float()) + b1.float()[:, None, :]
    h = gelu_exact(h).to(x.dtype).float()
    o = torch.matmul(h, w2.float()) + b2.float()[:, None, :]
    return o.to(x.dtype)


def mlp_backward(x, w1, b1, w2, b2, g):
    """The JAX backward (``fused_mlp.py::_bwd``): an f32 recompute with the
    exact erf and h kept in f32 (no bf16 rounding).  Returns (dx, dw1, db1,
    dw2, db2) in the primal dtypes."""
    xf, w1f, w2f, gf = x.float(), w1.float(), w2.float(), g.float()
    h_pre = torch.matmul(xf, w1f) + b1.float()[:, None, :]
    cdf = 0.5 * (1.0 + torch.erf(h_pre * SQRT_HALF))
    h = h_pre * cdf
    dw2 = torch.matmul(h.transpose(1, 2), gf)
    db2 = gf.sum(dim=1)
    dh = torch.matmul(gf, w2f.transpose(1, 2))
    dh_pre = dh * (cdf + h_pre * torch.exp(-0.5 * h_pre * h_pre) * INV_SQRT_2PI)
    dw1 = torch.matmul(xf.transpose(1, 2), dh_pre)
    db1 = dh_pre.sum(dim=1)
    dx = torch.matmul(dh_pre, w1f.transpose(1, 2))
    return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _mlp_forward(x, w1, b1, w2, b2):
    op = _kernels.export_op("fused_mlp")
    if op is not None:
        return op(x, w1, b1, w2, b2)
    if not x.is_cuda:
        return mlp_plain(x, w1, b1, w2, b2)
    return mlp_launch(x, w1, b1, w2, b2)


def mlp_launch(x, w1, b1, w2, b2):
    """The kernels' launch on CUDA tensors (``ops/library.py``'s op runs it)."""
    fn = "fused_mlp"
    _kernels.require(x.dim() == 3 and w1.dim() == 3,
                     f"{fn}: x must be [G, N, D] and w1 [G, D, F]")
    G, N, D = x.shape
    F = w1.shape[-1]
    _kernels.require(N > 0 and D > 0 and D % 8 == 0 and F > 0 and F % 8 == 0,
                     f"{fn}: N={N} must be > 0, D={D} and F={F} positive multiples of 8 "
                     "(16-byte rows for the TMA tensor maps)")
    _kernels.bf16_operand(fn, "x", x, (G, N, D))
    _kernels.bf16_operand(fn, "w1", w1, (G, D, F))
    _kernels.bf16_operand(fn, "w2", w2, (G, F, D))
    b1f = _kernels.f32_vector(fn, "b1", b1, (G, F), x.device)
    b2f = _kernels.f32_vector(fn, "b2", b2, (G, D), x.device)
    h = torch.empty(G, N, F, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    c = _kernels.lib("fused_mlp").mlp
    c.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(x.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
           h.data_ptr(), out.data_ptr(), G, N, D, F, _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_mlp.launches += 1
    return out


class FusedMlpFn(torch.autograd.Function):
    """The kernel (CUDA) or :func:`mlp_plain` (CPU) forward, the JAX backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _mlp_forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return mlp_backward(*ctx.saved_tensors, g)


def fused_mlp(x, w1, b1, w2, b2):
    """GELU(x @ w1 + b1) @ w2 + b2 per group.  x [G,N,D] bf16; w1 [G,D,F],
    w2 [G,F,D] bf16; b1 [G,F], b2 [G,D] -> [G,N,D] bf16.  Differentiable
    through :class:`FusedMlpFn`."""
    return FusedMlpFn.apply(x, w1, b1, w2, b2)


fused_mlp.launches = 0
