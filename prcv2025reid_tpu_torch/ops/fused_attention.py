"""Fused attention forward: the counterpart of the JAX package's
``ops/pallas_attention.py::pallas_mha`` (kernels v1 and v2).

``fused_mha`` launches the hand-written Hopper kernel (csrc/attention.cu) for
CUDA tensors and runs :func:`mha_plain`, the same arithmetic in plain
PyTorch, for CPU tensors.  The kernel takes 0 < S <= ``MAX_SEQ`` in three
ranges, each holding the TPU kernel's rounding point (P normalised in f32,
then cast): up to 256 tokens a 16-row strip's scores for all keys stay in
one warp's registers; up to ``REG_MAX_SEQ`` a 64-row tile's scores stay in
two warpgroups' registers, split by key range, with one QK^T and one
exponential a score; longer sequences stream the keys twice (each row's
max and sum, then P against V).  A CUDA tensor the kernel does not take
raises; it never falls back.  Both run inside one ``torch.autograd.Function`` whose
backward, :func:`mha_backward`, is the JAX op's f32 recompute in plain
PyTorch on every device (the JAX backward is XLA, not a Pallas kernel).
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels

HEAD_DIM = 64
REG_MAX_SEQ = 656  # csrc/attention.cu REG_MAX_S: the register-held kernel's longest
MAX_SEQ = 4096


def _causal_fill(logits: torch.Tensor) -> torch.Tensor:
    S = logits.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=logits.device).tril()
    return torch.where(keep, logits, torch.full_like(logits, -1e9))


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """The TPU kernel's arithmetic: f32 logits from the input-dtype q/k,
    scale, -1e9 mask, f32 max-subtracted softmax, P cast to the input dtype,
    f32-accumulated PV.  q/k/v [B, H, S, Dh] -> [B, H, S, Dh]."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1]**-0.5
    if causal:
        logits = _causal_fill(logits)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check_operand(name: str, t: torch.Tensor, shape) -> None:
    _kernels.require(t.is_cuda, f"fused_mha: {name} is on {t.device}, q is on CUDA")
    _kernels.require(t.dtype == torch.bfloat16, f"fused_mha: {name} must be bfloat16, got {t.dtype}")
    _kernels.require(tuple(t.shape) == shape, f"fused_mha: {name} shape {tuple(t.shape)} != {shape}")
    _kernels.require(t.stride(-1) == 1, f"fused_mha: {name} head dim must be contiguous")
    _kernels.require(
        all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0,
        f"fused_mha: {name} rows must be 16-byte aligned (strides {t.stride()})",
    )


def mha_backward(q, k, v, g, causal: bool = False):
    """The JAX backward (``pallas_attention.py::_bwd``): a flash-style f32
    recompute.  dV = P^T g; dP = g V^T; dS = P (dP - rowsum(P dP));
    dQ = dS K scale; dK = dS^T Q scale.  Returns (dq, dk, dv) in the primal
    dtypes."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        logits = _causal_fill(logits)
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mha_forward(q, k, v, causal):
    op = _kernels.export_op("fused_mha")
    if op is not None:
        return op(q, k, v, causal)
    if not q.is_cuda:
        return mha_plain(q, k, v, causal)
    return mha_launch(q, k, v, causal)


def mha_launch(q, k, v, causal):
    """The kernel's launch on CUDA tensors (``ops/library.py``'s op runs it)."""
    B, H, S, Dh = q.shape
    _kernels.require(Dh == HEAD_DIM, f"fused_mha: the kernel takes Dh={HEAD_DIM}, got {Dh}")
    _kernels.require(0 < S <= MAX_SEQ, f"fused_mha: the kernel takes 0 < S <= {MAX_SEQ}, got {S}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, (B, H, S, Dh))
    out = torch.empty(B, S, H, Dh, dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    fn = _kernels.lib("attention").attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S,
            *strides, int(causal), _kernels.stream_ptr(q))
    _kernels.check(rc, "fused_mha")
    fused_mha.launches += 1
    return out


class FusedMhaFn(torch.autograd.Function):
    """The kernel (CUDA) or :func:`mha_plain` (CPU) forward, the JAX backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _mha_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        return (*mha_backward(*ctx.saved_tensors, g, ctx.causal), None)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, kernel_version: int = 2) -> torch.Tensor:
    """softmax(mask(Q K^T / sqrt(Dh))) V;  q/k/v [B, H, S, Dh] -> [B, H, S, Dh].

    ``kernel_version`` (1 or 2) names the TPU kernel's grid split; both map
    to the one Hopper kernel.  q/k/v may be strided views (e.g. of a fused
    QKV projection) as long as the head dim is contiguous.  On the card the
    result is a [B, H, S, Dh] view of a [B, S, H, Dh] buffer.
    Differentiable through :class:`FusedMhaFn`."""
    if kernel_version not in (1, 2):
        raise ValueError(f"kernel_version={kernel_version}; valid: [1, 2]")
    return FusedMhaFn.apply(q, k, v, causal)


fused_mha.launches = 0
