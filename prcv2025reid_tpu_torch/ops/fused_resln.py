"""Fused residual add + LayerNorm: the counterpart of the JAX package's
``ops/fused_resln.py::fused_residual_ln``.

    xn = x + branch                    (rounded to x.dtype)
    y  = LN(xn) * scale + bias         (f32 statistics of the rounded xn)

in one memory pass: read x and branch, write xn and y.  For CUDA tensors the
wrapper launches the hand-written Hopper kernel (csrc/fused_resln.cu); for
CPU tensors it runs :func:`resln_plain`, the same arithmetic in plain
PyTorch.  A CUDA tensor the kernel does not take raises; it never falls back.
Both run inside one ``torch.autograd.Function`` whose backward,
:func:`resln_backward`, is the JAX op's f32 recompute on every device.
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels
from prcv2025reid_tpu_torch.ops.kernel_math import LN_EPS, ln_f32

# a warp holds a row in registers to 2,048 columns, a block past that, to
# csrc/common.cuh ROW_MAX
MAX_WIDTH = 32768


def resln_plain(x, branch, scale, bias, eps: float = LN_EPS):
    """x, branch [N, D]; scale, bias [D] -> (xn, y), both in x.dtype."""
    xn = (x.float() + branch.float()).to(x.dtype)
    return xn, ln_f32(xn, scale, bias, eps).to(x.dtype)


def resln_backward(xn, scale, g_xn, g_y, eps: float = LN_EPS):
    """The JAX backward (``fused_resln.py::_bwd``) from the saved xn: the
    LayerNorm backward in f32 plus g_xn.  Returns (dx, d_scale, d_bias); dx
    is the gradient of both x and branch."""
    xf = xn.float()
    mu = xf.mean(dim=1, keepdim=True)
    xc = xf - mu
    inv = torch.rsqrt(xc.square().mean(dim=1, keepdim=True) + eps)
    norm = xc * inv
    gy = g_y.float()
    d_scale = (gy * norm).sum(dim=0)
    d_bias = gy.sum(dim=0)
    gh = gy * scale.float()
    dx_ln = inv * (gh - gh.mean(dim=1, keepdim=True)
                   - norm * (gh * norm).mean(dim=1, keepdim=True))
    return g_xn.float() + dx_ln, d_scale, d_bias


def _resln_forward(x, branch, scale, bias, eps):
    op = _kernels.export_op("fused_residual_ln")
    if op is not None:
        return op(x, branch, scale, bias, eps)
    if not x.is_cuda:
        return resln_plain(x, branch, scale, bias, eps)
    return resln_launch(x, branch, scale, bias, eps)


def resln_launch(x, branch, scale, bias, eps):
    """The kernel's launch on CUDA tensors (``ops/library.py``'s op runs it)."""
    fn = "fused_residual_ln"
    _kernels.require(x.dim() == 2, f"{fn}: x must be [N, D], got {tuple(x.shape)}")
    N, D = x.shape
    _kernels.require(N > 0 and D % 8 == 0 and D <= MAX_WIDTH,
                     f"{fn}: N={N} must be > 0, D={D} a multiple of 8 and <= {MAX_WIDTH}")
    _kernels.bf16_operand(fn, "x", x, (N, D))
    _kernels.bf16_operand(fn, "branch", branch, (N, D))
    s = _kernels.f32_vector(fn, "scale", scale, (D,), x.device)
    b = _kernels.f32_vector(fn, "bias", bias, (D,), x.device)
    xn = torch.empty_like(x)
    y = torch.empty_like(x)
    c = _kernels.lib("fused_resln").resln
    c.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(x.data_ptr(), branch.data_ptr(), s.data_ptr(), b.data_ptr(), xn.data_ptr(),
           y.data_ptr(), N, D, eps, _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_residual_ln.launches += 1
    return xn, y


class FusedResLnFn(torch.autograd.Function):
    """The kernel (CUDA) or :func:`resln_plain` (CPU) forward, the JAX backward."""

    @staticmethod
    def forward(ctx, x, branch, scale, bias, eps):
        xn, y = _resln_forward(x, branch, scale, bias, eps)
        ctx.eps, ctx.dtypes = eps, (x.dtype, branch.dtype, bias.dtype)
        ctx.save_for_backward(xn, scale)
        return xn, y

    @staticmethod
    def backward(ctx, g_xn, g_y):
        xn, scale = ctx.saved_tensors
        dx, d_scale, d_bias = resln_backward(xn, scale, g_xn, g_y, ctx.eps)
        x_dt, branch_dt, bias_dt = ctx.dtypes
        return dx.to(x_dt), dx.to(branch_dt), d_scale.to(scale.dtype), d_bias.to(bias_dt), None


def fused_residual_ln(x, branch, scale, bias, eps: float = LN_EPS):
    """(x + branch, LN(x + branch) * scale + bias).  x, branch [N, D] bf16;
    scale, bias [D] -> (xn, y) [N, D] bf16.  Differentiable through
    :class:`FusedResLnFn`."""
    return FusedResLnFn.apply(x, branch, scale, bias, eps)


fused_residual_ln.launches = 0
