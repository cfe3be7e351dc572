"""Fused attention forward: the counterpart of the JAX package's
``ops/pallas_attention.py::pallas_mha`` (kernels v1 and v2).

``fused_mha`` launches the hand-written Hopper kernel (csrc/attention.cu) for
CUDA tensors and runs :func:`mha_plain`, the same arithmetic in plain
PyTorch, for CPU tensors.  The kernel takes every head width 1 <= Dh <=
``MAX_HEAD_DIM`` and every 0 < S <= ``SEQ_LIMIT`` (where its int32 tile
coordinates end), causal or not; each of its three kernels holds the TPU
kernel's rounding point (P normalised in f32, then cast).  It runs at the
head width rounded up to 64-column atoms (``DHP``: TMA fills the columns
past Dh with zeros, which change neither QK^T nor the stored columns of PV)
and scales the logits by the true Dh's 1/sqrt(Dh).  The route
(:func:`attention_route`, csrc/attention.cu ``route()``):

  ===================  =========  ==================  ====
  Dh                   S          kernel              DHP
  ===================  =========  ==================  ====
  <= 64                <= 256     attn_fwd_kernel     64
  <= 64                <= 656     attn_reg_kernel     64
  <= 64                > 656      attn_long_kernel    64
  65 .. 128            <= 256     attn_fwd_kernel     128
  65 .. 128            > 256      attn_long_kernel    128
  129 .. 256           any        attn_long_kernel    192 / 256
  ===================  =========  ==================  ====

attn_fwd_kernel keeps a 16-row strip's scores for all keys in one warp's
registers; attn_reg_kernel a 64-row tile's in two warpgroups' registers,
split by key range, with one QK^T and one exponential a score (its shared
memory holds K and V whole, which fits at 64 columns only);
attn_long_kernel streams the keys twice (each row's max and sum, then P
against V).  A head width that is not a multiple of 8 is copied into
zero-padded operands first (:func:`kernel_operands`: the tensor maps'
strides are multiples of 16 bytes).  A CUDA tensor the kernel does not take
(Dh > 256) raises; it never falls back.  Both run inside one
``torch.autograd.Function`` whose backward, :func:`mha_backward`, is the JAX
op's f32 recompute in plain PyTorch on every device (the JAX backward is
XLA, not a Pallas kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from prcv2025reid_tpu_torch.ops import _kernels

MAX_HEAD_DIM = 256  # csrc/attention.cu MAX_DH
ATOM = 64  # the head-dim columns of one 128-byte swizzled row: DHP is a multiple
REG_MAX_SEQ = 656  # csrc/attention.cu REG_MAX_S: the register-held kernel's longest
SEQ_LIMIT = 2**31 - 64  # csrc/attention.cu MAX_S: the tiles' int32 coordinates end there


def _causal_fill(logits: torch.Tensor) -> torch.Tensor:
    S = logits.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=logits.device).tril()
    return torch.where(keep, logits, torch.full_like(logits, -1e9))


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """The TPU kernel's arithmetic: f32 logits from the input-dtype q/k,
    scale (default 1/sqrt(Dh)), -1e9 mask, f32 max-subtracted softmax, P
    cast to the input dtype, f32-accumulated PV.  q/k/v [B, H, S, Dh] ->
    [B, H, S, Dh]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = _causal_fill(logits)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_route(dh: int, S: int) -> Tuple[str, int]:
    """(kernel, DHP): which kernel of csrc/attention.cu serves head width
    ``dh`` and ``S`` tokens, and at which padded head width (the C side's
    ``route()``, exported as ``attn_route``; the module docstring's table).
    Raises where no kernel serves them."""
    _kernels.require(1 <= dh <= MAX_HEAD_DIM,
                     f"fused_mha: the kernel takes 1 <= Dh <= {MAX_HEAD_DIM}, got {dh}")
    _kernels.require(0 < S <= SEQ_LIMIT, f"fused_mha: the kernel takes 0 < S <= {SEQ_LIMIT} "
                     f"(int32 tile coordinates), got {S}")
    dhp = -(-dh // ATOM) * ATOM
    if dhp == ATOM:
        kernel = ("attn_fwd_kernel" if S <= 256 else
                  "attn_reg_kernel" if S <= REG_MAX_SEQ else "attn_long_kernel")
    else:
        kernel = "attn_fwd_kernel" if dhp == 2 * ATOM and S <= 256 else "attn_long_kernel"
    return kernel, dhp


def kernel_operands(q, k, v, scale: Optional[float] = None):
    """What the kernel is handed for q/k/v [B, H, S, Dh]: the operands (a
    head width that is not a multiple of 8 copied into zero-padded [B, H, S,
    8 ceil(Dh / 8)] buffers, for the tensor maps' 16-byte strides; any other
    width as given) and the logits' scale, 1/sqrt(Dh) of the TRUE width unless
    ``scale`` names another.  The zero columns leave QK^T unchanged and give
    output columns the caller drops."""
    Dh = q.shape[-1]
    width = -(-Dh // 8) * 8
    if width != Dh:
        q, k, v = (torch.nn.functional.pad(t, (0, width - Dh)) for t in (q, k, v))
    return q, k, v, Dh ** -0.5 if scale is None else scale


def _check_operand(name: str, t: torch.Tensor, shape) -> None:
    _kernels.require(t.is_cuda, f"fused_mha: {name} is on {t.device}, q is on CUDA")
    _kernels.require(t.dtype == torch.bfloat16, f"fused_mha: {name} must be bfloat16, got {t.dtype}")
    _kernels.require(tuple(t.shape) == shape, f"fused_mha: {name} shape {tuple(t.shape)} != {shape}")
    _kernels.require(t.stride(-1) == 1, f"fused_mha: {name} head dim must be contiguous")


def _check_aligned(name: str, t: torch.Tensor) -> None:
    _kernels.require(
        all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0,
        f"fused_mha: {name} rows must be 16-byte aligned (strides {t.stride()})",
    )


def mha_backward(q, k, v, g, causal: bool = False, scale: Optional[float] = None):
    """The JAX backward (``pallas_attention.py::_bwd``): a flash-style f32
    recompute.  dV = P^T g; dP = g V^T; dS = P (dP - rowsum(P dP));
    dQ = dS K scale; dK = dS^T Q scale.  Returns (dq, dk, dv) in the primal
    dtypes."""
    if scale is None:
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


def _mha_forward(q, k, v, causal, scale):
    op = _kernels.export_op("fused_mha")
    if op is not None:
        return op(q, k, v, causal, scale)
    if not q.is_cuda:
        return mha_plain(q, k, v, causal, scale)
    return mha_launch(q, k, v, causal, scale)


def mha_launch(q, k, v, causal, scale=None):
    """The kernel's launch on CUDA tensors (``ops/library.py``'s op runs it)."""
    B, H, S, Dh = q.shape
    attention_route(Dh, S)  # raises where no kernel serves (Dh, S)
    _kernels.require(B * H * -(-S // ATOM) <= 2**31 - 1,
                     f"fused_mha: B*H*ceil(S/64) = {B * H * -(-S // ATOM)} query tiles pass the "
                     "int32 grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, (B, H, S, Dh))
    q, k, v, scale = kernel_operands(q, k, v, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned(name, t)
    width = q.shape[-1]
    out = torch.empty(B, S, H, width, dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    fn = _kernels.lib("attention").attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, width,
            *strides, scale, int(causal), _kernels.stream_ptr(q))
    _kernels.check(rc, "fused_mha")
    fused_mha.launches += 1
    return out if width == Dh else out.narrow(-1, 0, Dh)


class FusedMhaFn(torch.autograd.Function):
    """The kernel (CUDA) or :func:`mha_plain` (CPU) forward, the JAX backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v)
        return _mha_forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        return (*mha_backward(*ctx.saved_tensors, g, ctx.causal, ctx.scale), None, None)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, kernel_version: int = 2,
              scale: Optional[float] = None) -> torch.Tensor:
    """softmax(mask(Q K^T * scale)) V;  q/k/v [B, H, S, Dh] -> [B, H, S, Dh];
    ``scale`` defaults to 1/sqrt(Dh).

    ``kernel_version`` (1 or 2) names the TPU kernel's grid split; both map
    to the one Hopper kernel.  q/k/v may be strided views (e.g. of a fused
    QKV projection) as long as the head dim is contiguous.  On the card the
    result is a [B, H, S, Dh] view of a [B, S, H, Dh'] buffer (Dh' = Dh
    rounded up to a multiple of 8).  Differentiable through
    :class:`FusedMhaFn`."""
    if kernel_version not in (1, 2):
        raise ValueError(f"kernel_version={kernel_version}; valid: [1, 2]")
    return FusedMhaFn.apply(q, k, v, causal, scale)


fused_mha.launches = 0
