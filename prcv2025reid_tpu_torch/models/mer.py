"""MER (Modality-Expert Router) layers, eval (folded) forward — the
counterpart of the JAX package's ``models/mer.py``.

Each linear is a shared trunk plus a per-modality LoRA.  Routing is a static
grouping: activations are ``[G, ...]`` with one modality (expert id) per
group, and each linear folds its LoRA into per-group effective kernels per
call, in the compute dtype and in the JAX package's order:

    W_eff[g] = W.astype(dt) + (A[id_g].astype(dt) @ B[id_g].astype(dt)) * (alpha / r)

Parameters keep the JAX tree's names and layouts (kernels ``[in, out]``,
``lora_A [M, in, r]``, ``lora_B [M, r, out]``), so a module's state-dict key
is its flax path with ``/`` replaced by ``.`` (see ``params.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prcv2025reid_tpu_torch.ops.attention import (
    bshd_core,
    dot_product_attention,
    kernel_available,
)
from prcv2025reid_tpu_torch.ops.fused_block import fused_ln_qkv, fused_out_mlp, quantize_weight
from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp
from prcv2025reid_tpu_torch.ops.kernel_math import LN_EPS, gelu_poly_bf16, ln_f32


BLOCK_IMPLS = ("xla", "fused", "fused_int8", "fused_int8_mlp", "fused_qkv")
GELU_IMPLS = ("erf", "tanh", "poly")


def _param(*shape, device=None) -> nn.Parameter:
    """An uninitialised, frozen parameter; values come from ``params.py``."""
    return nn.Parameter(torch.empty(*shape, device=device), requires_grad=False)


def effective_weights(kernel, lora_a, lora_b, expert_ids: Sequence[int],
                      scale: float, dtype) -> torch.Tensor:
    """[G, in, out] effective kernels for the (static) group expert ids."""
    ids = list(expert_ids)
    a = lora_a[ids].to(dtype)  # [G, in, r]
    b = lora_b[ids].to(dtype)  # [G, r, out]
    delta = torch.matmul(a, b) * scale
    return kernel.to(dtype)[None] + delta


def ln_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float = LN_EPS) -> torch.Tensor:
    """Plain layer norm over the last axis, f32 statistics, output in x.dtype."""
    return ln_f32(x, scale, bias, eps).to(x.dtype)


def gelu_erf(h: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — ``apply_gelu(h, "erf")`` of the JAX package."""
    return F.gelu(h, approximate="none")


def apply_gelu(h: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """GELU by formulation name (``TrainingConfig.gelu_impl``): "erf" is
    reference-exact; "tanh" (the tanh approximation) and "poly"
    (:func:`gelu_poly_bf16`) are bf16-accuracy serving formulations."""
    if impl == "tanh":
        return F.gelu(h, approximate="tanh")
    if impl == "poly":
        return gelu_poly_bf16(h)
    return gelu_erf(h)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [G, ..., in] @ w [G, in, out] -> [G, ..., out]."""
    G = x.shape[0]
    y = torch.matmul(x.reshape(G, -1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def folded_block_tail(attn, x_res, w_out, b_out, ln2_s, ln2_b, w1, b1, w2, b2,
                      gelu_impl: str = "erf"):
    """The folded post-attention half of a pre-LN block, plain form:
    out-proj + residual + LN2 + MLP + residual; grouped leading dim."""
    proj = grouped_matmul(attn, w_out) + b_out
    x2 = x_res.to(proj.dtype) + proj
    y = ln_apply(x2, ln2_s, ln2_b)
    h = apply_gelu(grouped_matmul(y, w1) + b1, gelu_impl)
    return x2 + (grouped_matmul(h, w2) + b2)


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: inputs, kernel and bias are
    cast to ``dtype`` and multiplied there.  Also the shared trunk of a MER
    projection (the ``shared/{kernel,bias}`` path)."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True, device=None):
        super().__init__()
        self.kernel = _param(in_dim, features, device=device)
        self.bias = _param(features, device=device) if use_bias else None

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = torch.matmul(x.to(dtype), self.kernel.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics with the fast variance
    E[x^2] - E[x]^2 (clamped at 0), output in the compute dtype."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(features, device=device)
        self.bias = _param(features, device=device)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(dtype)


class LNParams(nn.Module):
    """LayerNorm ``scale``/``bias`` applied by the caller (or fused into a kernel)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = _param(features, device=device)
        self.bias = _param(features, device=device)

    def params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.scale, self.bias


class MERDense(nn.Module):
    """Grouped MER linear: x [G, ..., in] + static expert ids -> [G, ..., out].
    ``enable=False`` (config.enable_mer) computes the shared trunk only; the
    adapter parameters stay so checkpoints are interchangeable."""

    def __init__(self, in_dim: int, features: int, num_experts: int, rank: int = 4,
                 alpha: float = 1.0, dtype=torch.float32, enable: bool = True,
                 device=None):
        super().__init__()
        self.rank, self.alpha = rank, alpha
        self.dtype, self.enable = dtype, enable
        self.shared = Dense(in_dim, features, device=device)
        self.lora_A = _param(num_experts, in_dim, rank, device=device)
        self.lora_B = _param(num_experts, rank, features, device=device)

    def folded(self, expert_ids: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_eff [G, in, out], bias) in the compute dtype."""
        dt = self.dtype
        kernel = self.shared.kernel
        if self.enable:
            w = effective_weights(kernel, self.lora_A, self.lora_B, expert_ids,
                                  self.alpha / self.rank, dt)
        else:
            w = kernel.to(dt)[None].expand(len(expert_ids), *kernel.shape)
        return w, self.shared.bias.to(dt)

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        assert len(expert_ids) == x.shape[0], "one expert id per group"
        if not self.enable:
            return self.shared(x, self.dtype)
        y = grouped_matmul(x.to(self.dtype), self.folded(expert_ids)[0])
        return y + self.shared.bias.to(self.dtype)


class MERAttention(nn.Module):
    """MHA with MER-routed Q/K/V/out projections.  Q/K/V effective kernels
    concatenate into one [G, D, 3D] grouped matmul.  ``attn_impl``: 'xla'
    (einsum core), 'onesaug' (the ones-augmented core,
    ``attn_backend="onesaug"``), 'splash' (the splash core,
    ``attn_backend="splash"``) or 'auto' (the fused kernel for CUDA tensors,
    the einsum core for CPU tensors — JAX's ``use_pallas_attention=True``)."""

    def __init__(self, dim: int, num_heads: int, num_experts: int, rank: int = 4,
                 alpha: float = 1.0, dtype=torch.float32, attn_impl: str = "xla",
                 enable: bool = True, device=None):
        super().__init__()
        if attn_impl not in ("xla", "onesaug", "splash", "auto"):
            raise ValueError(
                f"attn_impl={attn_impl!r}; valid: ['auto', 'onesaug', 'splash', 'xla']")
        self.num_heads, self.dtype, self.attn_impl = num_heads, dtype, attn_impl
        mer = dict(num_experts=num_experts, rank=rank, alpha=alpha, dtype=dtype,
                   enable=enable, device=device)
        self.q_proj = MERDense(dim, dim, **mer)
        self.k_proj = MERDense(dim, dim, **mer)
        self.v_proj = MERDense(dim, dim, **mer)
        self.out_proj = MERDense(dim, dim, **mer)

    def folded(self, expert_ids: Sequence[int]):
        """(w_qkv [G, D, 3D], b_qkv [3D], w_out [G, D, D], b_out [D])."""
        parts = [p.folded(expert_ids) for p in (self.q_proj, self.k_proj, self.v_proj)]
        w_qkv = torch.cat([w for w, _ in parts], dim=2)
        b_qkv = torch.cat([b for _, b in parts], dim=0)
        return (w_qkv, b_qkv, *self.out_proj.folded(expert_ids))

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        G, B, S, D = x.shape
        H = self.num_heads
        Dh = D // H
        w_qkv, b_qkv, _, _ = self.folded(expert_ids)
        qkv = grouped_matmul(x.to(self.dtype), w_qkv) + b_qkv
        # free-reshape unstack: q/k/v are strided views of the projection
        qkv5 = qkv.reshape(G, B, S, 3, H, Dh)
        q, k, v = qkv5[..., 0, :, :], qkv5[..., 1, :, :], qkv5[..., 2, :, :]

        impl = self.attn_impl
        if impl == "auto":
            impl = "pallas" if kernel_available(x) else "xla"
        if impl in ("xla", "onesaug", "splash"):  # the [B, S, H, Dh] cores
            def merge2(t):
                return t.reshape(G * B, S, H, Dh)

            out = bshd_core(impl)(merge2(q), merge2(k), merge2(v)).reshape(G, B, S, D)
        else:
            def split_heads(t):
                return t.reshape(G * B, S, H, Dh).permute(0, 2, 1, 3)

            out = dot_product_attention(split_heads(q), split_heads(k), split_heads(v),
                                        impl=impl)
            out = out.permute(0, 2, 1, 3).reshape(G, B, S, D)
        return self.out_proj(out, expert_ids)


class MERMlp(nn.Module):
    """fc1 -> GELU -> fc2, both MER-routed.  ``impl``: 'xla' (two grouped
    matmuls around the ``gelu_impl`` formulation, see :func:`apply_gelu`) or
    'auto' (JAX's ``impl="auto"``: the folded weights through ``fused_mlp``,
    which launches the fused kernel for CUDA tensors and runs its plain
    version for CPU tensors; both keep the kernel's own exact erf, as the JAX
    Pallas route does).  ``enable=False`` keeps the plain MLP: the kernel
    takes folded, routed weights."""

    def __init__(self, dim: int, mlp_dim: int, num_experts: int, rank: int = 4,
                 alpha: float = 1.0, dtype=torch.float32, impl: str = "xla",
                 enable: bool = True, gelu_impl: str = "erf", device=None):
        super().__init__()
        if impl not in ("xla", "auto"):
            raise ValueError(f"impl={impl!r}; valid: ['auto', 'xla']")
        if gelu_impl not in GELU_IMPLS:
            raise ValueError(f"gelu_impl={gelu_impl!r}; valid: {list(GELU_IMPLS)}")
        self.dtype, self.impl, self.enable, self.gelu_impl = dtype, impl, enable, gelu_impl
        mer = dict(num_experts=num_experts, rank=rank, alpha=alpha, dtype=dtype,
                   enable=enable, device=device)
        self.fc1 = MERDense(dim, mlp_dim, **mer)
        self.fc2 = MERDense(mlp_dim, dim, **mer)

    def folded(self, expert_ids: Sequence[int]):
        """(w1 [G, D, F], b1 [F], w2 [G, F, D], b2 [D])."""
        return (*self.fc1.folded(expert_ids), *self.fc2.folded(expert_ids))

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        if self.impl == "xla" or not self.enable:
            return self.fc2(apply_gelu(self.fc1(x, expert_ids), self.gelu_impl), expert_ids)
        G, B, S, D = x.shape
        w1, b1, w2, b2 = self.folded(expert_ids)
        out = fused_mlp(x.to(self.dtype).reshape(G, B * S, D), w1.contiguous(),
                        b1[None].expand(G, -1), w2.contiguous(), b2[None].expand(G, -1))
        return out.reshape(G, B, S, D)


class MERBlock(nn.Module):
    """Pre-LN transformer block with MER routing, eval forward.  Grouped
    activations [G, B, S, D] with static per-group expert ids.

    ``block_impl``: 'xla' (plain modules); 'fused' (the two bf16 block
    kernels with the einsum attention core between them); 'fused_int8' (both
    int8 kernels); 'fused_int8_mlp' (the bf16 LN+QKV kernel, then the mixed
    kernel: bf16 out-projection, int8 fc1 and fc2); 'fused_qkv' (the bf16
    LN+QKV kernel, then the plain ``folded_block_tail``).  Every fused plan
    takes the einsum core between its kernels (the ones-augmented one under
    ``attn_impl="onesaug"``), bypassing ``mlp_impl`` and any other
    ``attn_impl`` as in the JAX package.  ``gelu_impl`` reaches every plain
    GELU of the block; the kernels keep their own exact erf."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, num_experts: int,
                 rank: int = 4, alpha: float = 1.0, dtype=torch.float32,
                 attn_impl: str = "xla", mlp_impl: str = "xla", enable_mer: bool = True,
                 block_impl: str = "xla", gelu_impl: str = "erf", device=None):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl={block_impl!r}; valid: {list(BLOCK_IMPLS)}")
        self.num_heads, self.dtype = num_heads, dtype
        self.attn_impl, self.block_impl = attn_impl, block_impl
        mer = dict(num_experts=num_experts, rank=rank, alpha=alpha, dtype=dtype,
                   device=device)
        self.ln1 = LNParams(dim, device=device)
        self.ln2 = LNParams(dim, device=device)
        self.attn = MERAttention(dim, num_heads, attn_impl=attn_impl, enable=enable_mer, **mer)
        self.mlp = MERMlp(dim, mlp_dim, impl=mlp_impl, enable=enable_mer,
                          gelu_impl=gelu_impl, **mer)

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        if self.block_impl != "xla":
            return self._fused_call(x, expert_ids)
        x = x + self.attn(ln_apply(x, *self.ln1.params()), expert_ids)
        return x + self.mlp(ln_apply(x, *self.ln2.params()), expert_ids)

    def cls_only_call(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        """Exact CLS-row output of the forward: [G,B,S,D] -> [G,B,D].  q, the
        out-projection and the MLP run for the CLS token only; k/v span all
        tokens.  The core is the ones-augmented one under 'onesaug' and the
        einsum core under every other attn_impl, as in the JAX package."""
        G, B, S, D = x.shape
        H = self.num_heads
        Dh = D // H
        w_qkv, b_qkv, w_out, b_out = self.attn.folded(expert_ids)
        w1, b1, w2, b2 = self.mlp.folded(expert_ids)
        h = ln_apply(x, *self.ln1.params())
        kv = grouped_matmul(h, w_qkv[:, :, D:]) + b_qkv[D:]
        q = grouped_matmul(h[:, :, 0], w_qkv[:, :, :D]) + b_qkv[:D]
        k, v = kv[..., :D], kv[..., D:]
        attn = bshd_core(self._core())(
            q.reshape(G * B, 1, H, Dh),
            k.reshape(G * B, S, H, Dh),
            v.reshape(G * B, S, H, Dh),
        ).reshape(G, B, D)
        return folded_block_tail(attn, x[:, :, 0], w_out, b_out, *self.ln2.params(),
                                 w1, b1, w2, b2, self.mlp.gelu_impl)

    def _core(self) -> str:
        """The [B, S, H, Dh] core of ``cls_only_call`` and ``_fused_call``:
        'onesaug' where asked for, else the einsum core (JAX mer.py:668-672,
        :757-759)."""
        return "onesaug" if self.attn_impl == "onesaug" else "xla"

    def _fused_call(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        """LN1+QKV kernel -> einsum attention core -> out-proj+residual+LN2+
        MLP+residual kernel, in the block plan's ``quant``.  The int8 plans
        quantize the folded compute-dtype weights on every call, as JAX does:
        'fused_int8' all four projections, 'fused_int8_mlp' fc1 and fc2."""
        G, B, S, D = x.shape
        H = self.num_heads
        quant = {"fused_int8": "int8", "fused_int8_mlp": "int8_mlp"}.get(self.block_impl, "bf16")
        w_qkv, b_qkv, w_out, b_out = self.attn.folded(expert_ids)
        w1, b1, w2, b2 = self.mlp.folded(expert_ids)
        w_qkv, w_out, w1, w2 = (w.contiguous() for w in (w_qkv, w_out, w1, w2))

        def per_group(b):
            return b[None].expand(G, *b.shape)

        xf = x.reshape(G, B * S, D)
        if quant == "int8":
            qkv = fused_ln_qkv(xf, *self.ln1.params(), quantize_weight(w_qkv),
                               per_group(b_qkv), quant="int8")
        else:
            qkv = fused_ln_qkv(xf, *self.ln1.params(), w_qkv, per_group(b_qkv))
        qkv5 = qkv.reshape(G * B, S, 3, H, D // H)
        q, k, v = qkv5[:, :, 0], qkv5[:, :, 1], qkv5[:, :, 2]
        attn = bshd_core(self._core())(q, k, v).reshape(G, B * S, D).contiguous()
        if self.block_impl == "fused_qkv":  # the LN+QKV kernel only; the tail stays plain
            y = folded_block_tail(attn, xf, w_out, b_out, *self.ln2.params(), w1, b1, w2, b2,
                                  self.mlp.gelu_impl)
            return y.reshape(G, B, S, D)
        if quant == "int8":
            w_out = quantize_weight(w_out)
        if quant != "bf16":
            w1, w2 = quantize_weight(w1), quantize_weight(w2)
        y = fused_out_mlp(attn, xf, w_out, per_group(b_out), *self.ln2.params(),
                          w1, per_group(b1), w2, per_group(b2), quant=quant)
        return y.reshape(G, B, S, D)
