"""Fused transformer-block kernels for the folded (eval/serving) path, bf16:
the counterparts of the JAX package's ``ops/fused_block.py::fused_ln_qkv``
and ``::fused_out_mlp`` (``quant="bf16"``).

  fused_ln_qkv:   qkv = LN1(x) @ W_qkv + b
  fused_out_mlp:  x2  = x + attn @ W_out + b_out        (f32)
                  out = x2 + GELU(LN2(x2) @ W1 + b1) @ W2 + b2

For CUDA tensors the wrappers launch the hand-written Hopper kernels
(csrc/fused_block.cu); for CPU tensors they run the plain versions below,
which compute in f32 with the kernels' bf16 casts.  A CUDA tensor the kernel
does not take raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels
from prcv2025reid_tpu_torch.ops.kernel_math import LN_EPS, gelu_exact, ln_f32

MAX_LN_WIDTH = 1024  # the row-statistics kernel holds a row in registers


def ln_qkv_plain(x, ln_scale, ln_bias, w, b):
    """x [G,T,D]; w [G,D,O]; b [G,O] -> [G,T,O] in x.dtype."""
    y = ln_f32(x, ln_scale, ln_bias).to(x.dtype).float()
    o = torch.matmul(y, w.float()) + b.float()[:, None, :]
    return o.to(x.dtype)


def out_mlp_plain(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2):
    """attn, x [G,T,D]; wo [G,D,D]; w1 [G,D,F]; w2 [G,F,D]; biases [G,*]."""
    dt = x.dtype
    proj = torch.matmul(attn.float(), wo.float()) + bo.float()[:, None, :]
    x2 = x.float() + proj
    y = ln_f32(x2, ln_scale, ln_bias)
    h = torch.matmul(y.to(dt).float(), w1.float()) + b1.float()[:, None, :]
    h = gelu_exact(h)
    o = torch.matmul(h.to(dt).float(), w2.float()) + b2.float()[:, None, :]
    return (x2 + o).to(dt)


def fused_ln_qkv(x, ln_scale, ln_bias, w, b):
    """LN(x) @ w + b.  x [G,T,D] bf16; ln_* [D]; w [G,D,O] bf16; b [G,O]
    -> [G,T,O] bf16.  LN statistics, the GEMM accumulation and the bias add
    are f32; the normalised rows are cast to bf16 before the GEMM."""
    if not x.is_cuda:
        return ln_qkv_plain(x, ln_scale, ln_bias, w, b)
    fn = "fused_ln_qkv"
    G, T, D = x.shape
    O = w.shape[-1]
    _kernels.require(D % 8 == 0 and O % 8 == 0 and D <= MAX_LN_WIDTH,
                     f"{fn}: D={D} and O={O} must be multiples of 8, D <= {MAX_LN_WIDTH}")
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    _kernels.bf16_operand(fn, "w", w, (G, D, O))
    lns = _kernels.f32_vector(fn, "ln_scale", ln_scale, (D,), x.device)
    lnb = _kernels.f32_vector(fn, "ln_bias", ln_bias, (D,), x.device)
    bf = _kernels.f32_vector(fn, "b", b, (G, O), x.device)
    stats = torch.empty(G * T, 2, dtype=torch.float32, device=x.device)
    out = torch.empty(G, T, O, dtype=x.dtype, device=x.device)
    c = _kernels.lib("fused_block").ln_qkv
    c.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(), bf.data_ptr(),
           stats.data_ptr(), out.data_ptr(), G, T, D, O, LN_EPS, _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_ln_qkv.launches += 1
    return out


def fused_out_mlp(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2):
    """x + attn@wo + bo, then + MLP(LN2(.)) with exact (A-S erf) GELU.
    attn, x [G,T,D] bf16; wo [G,D,D], w1 [G,D,F], w2 [G,F,D] bf16; biases
    [G,*]; ln_* [D] -> [G,T,D] bf16.  On the card this is four launches
    (out-proj GEMM, LN2 row statistics, LN2+fc1+GELU GEMM, fc2+residual
    GEMM); it counts as one launch of the fused kernel."""
    if not x.is_cuda:
        return out_mlp_plain(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)
    fn = "fused_out_mlp"
    G, T, D = x.shape
    F = w1.shape[-1]
    _kernels.require(D % 8 == 0 and F % 8 == 0 and D <= MAX_LN_WIDTH,
                     f"{fn}: D={D} and F={F} must be multiples of 8, D <= {MAX_LN_WIDTH}")
    _kernels.bf16_operand(fn, "attn", attn, (G, T, D))
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    _kernels.bf16_operand(fn, "wo", wo, (G, D, D))
    _kernels.bf16_operand(fn, "w1", w1, (G, D, F))
    _kernels.bf16_operand(fn, "w2", w2, (G, F, D))
    bof = _kernels.f32_vector(fn, "bo", bo, (G, D), x.device)
    b1f = _kernels.f32_vector(fn, "b1", b1, (G, F), x.device)
    b2f = _kernels.f32_vector(fn, "b2", b2, (G, D), x.device)
    lns = _kernels.f32_vector(fn, "ln_scale", ln_scale, (D,), x.device)
    lnb = _kernels.f32_vector(fn, "ln_bias", ln_bias, (D,), x.device)
    x2 = torch.empty(G, T, D, dtype=torch.float32, device=x.device)
    stats = torch.empty(G * T, 2, dtype=torch.float32, device=x.device)
    h = torch.empty(G, T, F, dtype=x.dtype, device=x.device)
    out = torch.empty(G, T, D, dtype=x.dtype, device=x.device)
    c = _kernels.lib("fused_block").out_mlp
    c.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(attn.data_ptr(), x.data_ptr(), wo.data_ptr(), bof.data_ptr(), lns.data_ptr(),
           lnb.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
           x2.data_ptr(), stats.data_ptr(), h.data_ptr(), out.data_ptr(), G, T, D, F, LN_EPS,
           _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_out_mlp.launches += 1
    return out


fused_ln_qkv.launches = 0
fused_out_mlp.launches = 0
