"""Multi-head attention cores (counterpart of the JAX package's
``ops/attention.py``): the plain einsum cores, the splash core and the
backend dispatch.

``xla_attention`` takes q/k/v [B, H, S, Dh]; ``xla_attention_bshd`` takes the
natural post-projection layout [B, S, H, Dh].  Both compute the logits in the
input dtype and only then cast them to f32, like the JAX cores, so the bf16
rounding points agree.  ``xla_attention_bshd_onesaug``
(``attn_backend="onesaug"``) is the serving formulation with no reduction
pass over the scores.  ``splash_attention_bshd`` (``attn_backend="splash"``)
replaces the JAX package's upstream Mosaic splash kernel with the port's
Hopper attention kernel (``fused_mha``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha


def _causal_fill(logits: torch.Tensor, S: int) -> torch.Tensor:
    keep = torch.ones(S, S, dtype=torch.bool, device=logits.device).tril()
    return torch.where(keep, logits, torch.full_like(logits, -1e9))


def xla_attention(q, k, v, *, causal: bool = False,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q/k/v [B, H, S, Dh] -> [B, H, S, Dh]; ``mask`` is additive [B, 1|H, S, S]."""
    S, Dh = q.shape[-2], q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * Dh**-0.5
    logits = logits.float()
    if causal:
        logits = _causal_fill(logits, S)
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def xla_attention_bshd(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """q/k/v [B, S, H, Dh] -> [B, S, H, Dh] without explicit head transposes."""
    S, Dh = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh**-0.5
    logits = logits.float()
    if causal:
        logits = _causal_fill(logits, S)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def xla_attention_bshd_onesaug(q, k, v) -> torch.Tensor:
    """q/k/v [B, S, H, Dh] -> [B, S, H, Dh] with no reduction pass over the
    [S, S] scores: they stay in the input dtype, exp runs without the max
    subtraction (safe while |logits| * Dh**-0.5 < 88 in f32), and the softmax
    denominator rides the PV product as a ones column of V.  The division
    floors the denominator at 1e-9 for an f32 output, 1e-8 otherwise.  Not
    bit-identical to :func:`xla_attention_bshd`; a serving formulation."""
    Dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    p = torch.exp(s.float() * Dh**-0.5).to(q.dtype)
    v_aug = torch.cat([v, torch.ones(*v.shape[:-1], 1, dtype=v.dtype, device=v.device)], dim=-1)
    o = torch.einsum("bhqk,bkhe->bqhe", p, v_aug)
    denom = torch.clamp(o[..., Dh:], min=1e-9 if o.dtype == torch.float32 else 1e-8)
    return o[..., :Dh] / denom


def splash_plain(q, k, v) -> torch.Tensor:
    """What the splash kernel computes: q scaled by Dh**-0.5 first and
    rounded to its dtype (JAX ``attention.py:148``), f32 logits, the exact
    softmax, the weights cast to v's dtype, f32-accumulated PV.  q/k/v
    [B, S, H, Dh] -> [B, S, H, Dh] in q.dtype."""
    Dh = q.shape[-1]
    qs = (q * Dh**-0.5).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(q.dtype)


def splash_attention_bshd(q, k, v) -> torch.Tensor:
    """The splash core on the [B, S, H, Dh] layout.  For CUDA tensors it
    launches the Hopper attention kernel (``fused_mha``), which masks keys
    >= S by index, so S needs no padding to a multiple of 128 (JAX pads
    197 -> 256 under a key mask).  Where Dh**-0.5 is a power of two (Dh a
    power of 4: 16, 64, 256) the kernel's scaling after the product equals
    splash's pre-scaled q exactly; at any other width (ViT-H's 80) q is
    pre-scaled and rounded to its dtype as splash does, and the kernel runs
    at scale 1.  CPU tensors run :func:`splash_plain`."""
    if not q.is_cuda:
        return splash_plain(q, k, v)
    scale = q.shape[-1] ** -0.5
    if math.log2(scale).is_integer():
        out = fused_mha(*(t.permute(0, 2, 1, 3) for t in (q, k, v)))
    else:
        qs = (q * scale).to(q.dtype)
        out = fused_mha(*(t.permute(0, 2, 1, 3) for t in (qs, k, v)), scale=1.0)
    if not torch.compiler.is_exporting():  # an exported graph holds fused_mha's op
        splash_attention_bshd.launches += 1
    return out.permute(0, 2, 1, 3)


splash_attention_bshd.launches = 0

BSHD_CORES = {"xla": xla_attention_bshd, "onesaug": xla_attention_bshd_onesaug,
              "splash": splash_attention_bshd}


def bshd_core(impl: str):
    """Resolve an attention-core name to its [B, S, H, Dh] function."""
    if impl not in BSHD_CORES:
        raise ValueError(f"attention core {impl!r}; valid: {sorted(BSHD_CORES)}")
    return BSHD_CORES[impl]


def kernel_available(t: torch.Tensor) -> bool:
    """The counterpart of JAX's ``_pallas_available()``: the hand-written
    kernels run for CUDA tensors; CPU tensors take the plain versions."""
    return t.is_cuda


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Dispatch to an attention backend; q/k/v [B, H, S, Dh].

    impl: 'auto' | 'xla' | 'pallas'.  'auto' takes the fused kernel for CUDA
    tensors on unmasked non-causal attention and the einsum core otherwise.
    'pallas' names the fused kernel (the JAX package's Pallas kernel)."""
    if impl == "auto":
        impl = "pallas" if (kernel_available(q) and mask is None and not causal) else "xla"
    if impl == "pallas":
        return fused_mha(q, k, v, causal=causal)
    if impl != "xla":
        raise ValueError(f"impl={impl!r}; valid: ['auto', 'pallas', 'xla']")
    return xla_attention(q, k, v, causal=causal, mask=mask)
