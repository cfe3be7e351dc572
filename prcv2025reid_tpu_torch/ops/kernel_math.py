"""Shared math of the fused kernels' plain versions (counterpart of the JAX
package's ``ops/kernel_math.py``): the Abramowitz-Stegun erf that the MLP
kernels evaluate in their GELU epilogues (csrc/fused_block.cu,
csrc/fused_mlp.cu) and the two-pass f32 LayerNorm of the LN kernels."""
from __future__ import annotations

import torch

SQRT_HALF = 0.7071067811865476
LN_EPS = 1e-5


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
