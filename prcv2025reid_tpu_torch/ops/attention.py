"""Multi-head attention cores (counterpart of the JAX package's
``ops/attention.py``): the plain einsum cores and the backend dispatch.

``xla_attention`` takes q/k/v [B, H, S, Dh]; ``xla_attention_bshd`` takes the
natural post-projection layout [B, S, H, Dh].  Both compute the logits in the
input dtype and only then cast them to f32, like the JAX cores, so the bf16
rounding points agree.
"""
from __future__ import annotations

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


BSHD_CORES = {"xla": xla_attention_bshd}


def bshd_core(impl: str):
    """Resolve an attention-core name to its [B, S, H, Dh] function."""
    if impl not in BSHD_CORES:
        raise NotImplementedError(
            f"attention core {impl!r} is not ported yet: ROADMAP.md §1 item 2 "
            "('onesaug') and §2 item 10 ('splash')"
        )
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
