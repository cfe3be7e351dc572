"""Shared math of the fused kernels' plain versions (counterpart of the JAX
package's ``ops/kernel_math.py``): the Abramowitz-Stegun erf that the MLP
kernels evaluate in their GELU epilogues (csrc/fused_block.cu,
csrc/fused_mlp.cu), the two-pass f32 LayerNorm of the LN kernels, the
bf16-accuracy polynomial GELU of the serving path (``gelu_impl="poly"``) and
the exact GELU whose backward reuses the forward's erf (``gelu_stored``)."""
from __future__ import annotations

import torch

SQRT_HALF = 0.7071067811865476
INV_SQRT_2PI = 0.3989422804014327
LN_EPS = 1e-5

# Minimax odd polynomial for erf on [0, 2.5] (|err| <= 1.7e-3, inside the bf16
# rounding of the activations that follow); erf is clamped to +/-1 outside.
# Horner on u^2: the JAX package's constants, bit for bit.
_ERF_POLY_BOUND = 2.5
_ERF_POLY_C = (
    1.12030787,  # u^1
    -0.345460773,  # u^3
    0.0788524875,  # u^5
    -0.00982586526,  # u^7
    0.000496800079,  # u^9
)


def erf_approx(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (|err| <= 1.5e-7)."""
    a1, a2, a3, a4, a5 = (
        0.254829592,
        -0.284496736,
        1.421413741,
        -1.453152027,
        1.061405429,
    )
    p = 0.3275911
    sign = torch.sign(x)
    xa = torch.abs(x)
    t = 1.0 / (1.0 + p * xa)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return sign * (1.0 - poly * torch.exp(-xa * xa))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """0.5 * x * (1 + erf(x / sqrt(2))) via :func:`erf_approx`."""
    return 0.5 * x * (1.0 + erf_approx(x * SQRT_HALF))


def ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = LN_EPS) -> torch.Tensor:
    """f32 LayerNorm over the last axis: the mean, then the mean squared
    deviation (two passes), as the kernels compute them."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def gelu_poly_bf16(x: torch.Tensor) -> torch.Tensor:
    """GELU with the bf16-accuracy polynomial erf (``gelu_impl="poly"``):
    x / sqrt(2) is rounded to x.dtype, then clamped to the fit's range in f32;
    the result is cast back to x.dtype.  A serving formulation, not
    reference-exact math."""
    u = torch.clamp((x * SQRT_HALF).float(), -_ERF_POLY_BOUND, _ERF_POLY_BOUND)
    u2 = u * u
    c1, c3, c5, c7, c9 = _ERF_POLY_C
    p = torch.clamp(u * (c1 + u2 * (c3 + u2 * (c5 + u2 * (c7 + u2 * c9)))), -1.0, 1.0)
    return (0.5 * x.float() * (1.0 + p)).to(x.dtype)


class _GeluStored(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        c = torch.erf(xf * SQRT_HALF)  # erf once; saved in x.dtype for the backward
        ctx.save_for_backward(x, c.to(x.dtype))
        return (0.5 * xf * (1.0 + c)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, c = ctx.saved_tensors
        xf = x.float()
        # d gelu / dx = Phi(x) + x phi(x), Phi from the stored erf: one exp, no erf
        phi = INV_SQRT_2PI * torch.exp(-0.5 * xf * xf)
        grad = 0.5 * (1.0 + c.float()) + xf * phi
        return (g.float() * grad).to(x.dtype)


def gelu_stored(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU whose backward reuses the forward's erf, saved beside
    x in x.dtype, instead of recomputing it (JAX ``gelu_stored``).  Equal to
    ``F.gelu(x)`` up to the residual's rounding: exact in f32, one bf16 ulp
    of the gradient in bf16."""
    return _GeluStored.apply(x)
