"""MER (Modality-Expert Router) layers — the counterpart of the JAX
package's ``models/mer.py``.

Each linear is a shared trunk plus a per-modality LoRA.  Routing is a static
grouping: activations are ``[G, ...]`` with one modality (expert id) per
group.  The eval forward (``fold=True``) folds each LoRA into per-group
effective kernels per call, in the compute dtype and in the JAX package's
order:

    W_eff[g] = W.astype(dt) + (A[id_g].astype(dt) @ B[id_g].astype(dt)) * (alpha / r)

The training forward (``fold=False``) keeps the thin side path,
``x @ W + ((x @ A[id_g]) @ B[id_g]) * (alpha / r)``, so the backward makes
thin dA / dB products instead of a dense [G, in, out] dW_eff per linear;
the last block's CLS-only call stays folded in training too, as in JAX.

Parameters keep the JAX tree's names and layouts (kernels ``[in, out]``,
``lora_A [M, in, r]``, ``lora_B [M, r, out]``), so a module's state-dict key
is its flax path with ``/`` replaced by ``.`` (see ``params.py``).

Tensor parallelism (``parallel/tp.py::shard_variables``): a sharded
attention or MLP holds this process's Megatron shard of each projection
and its mesh in ``tp``; it starts with ``copy_to_model``, runs its
column products and its core on the local outputs (``H/m`` heads), and its
row projection (``tp_row``) sums the partial products over the model group
before adding the bias.  The folded weights of a shard are the shard of the
folded weights, so the eval forward folds locally; the ``block_impl``
kernel plans fuse across the row boundary, so they gather the folded
weights whole and run as one process does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from prcv2025reid_tpu_torch.ops.attention import (
    bshd_core,
    dot_product_attention,
    kernel_available,
)
from prcv2025reid_tpu_torch.ops.fused_block import fused_ln_qkv, fused_out_mlp, quantize_weight
from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp
from prcv2025reid_tpu_torch.ops.kernel_math import LN_EPS, gelu_poly_bf16, gelu_stored, ln_f32
from prcv2025reid_tpu_torch.parallel.collectives import (
    copy_to_model,
    model_all_gather,
    reduce_from_model,
    uniform_rows,
)


BLOCK_IMPLS = ("xla", "fused", "fused_int8", "fused_int8_mlp", "fused_qkv")
GELU_IMPLS = ("erf", "tanh", "poly")


# set while a training forward makes a product that no backward reads (the
# MLP's fc2: its output only feeds the residual add); see unread_by_backward
_UNREAD = contextvars.ContextVar("unread_by_backward", default=False)


@contextlib.contextmanager
def unread_by_backward():
    """Marks the products made inside as ones the backward never reads:
    ``remat_policy="dots"`` saves no such product, as JAX's partial
    evaluation keeps no residual that its backward does not read
    (``models/vit.py::dots_policy``)."""
    token = _UNREAD.set(True)
    try:
        yield
    finally:
        _UNREAD.reset(token)


def backward_unread() -> bool:
    """Whether the caller runs inside :func:`unread_by_backward`."""
    return _UNREAD.get()


def _param(*shape, device=None) -> nn.Parameter:
    """An uninitialised, frozen parameter; values come from ``params.py``."""
    return nn.Parameter(torch.empty(*shape, device=device), requires_grad=False)


def select_experts(t: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
    """t[expert_ids] for static ids without an index tensor: indexing a
    CUDA tensor with a Python list copies the list to the card, which waits
    for it; a run of consecutive ids is a slice, any other set a stack."""
    ids = list(expert_ids)
    if ids == list(range(ids[0], ids[0] + len(ids))):
        return t[ids[0]:ids[0] + len(ids)]
    return torch.stack([t[i] for i in ids])


def effective_weights(kernel, lora_a, lora_b, expert_ids: Sequence[int],
                      scale: float, dtype) -> torch.Tensor:
    """[G, in, out] effective kernels for the (static) group expert ids."""
    a = select_experts(lora_a, expert_ids).to(dtype)  # [G, in, r]
    b = select_experts(lora_b, expert_ids).to(dtype)  # [G, r, out]
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
                      gelu_impl: str = "erf", dp1=None, dp2=None, attn_tp=None, mlp_tp=None):
    """The folded post-attention half of a pre-LN block, plain form:
    out-proj + residual + LN2 + MLP + residual; grouped leading dim.
    ``dp1`` / ``dp2``: optional per-sample drop-path keep masks, already
    scaled by 1/keep, on the attention and MLP branches.  ``attn_tp`` /
    ``mlp_tp``: the meshes of a sharded attention / MLP, whose row products
    are partial sums (``w_out``, ``w2`` hold this process's input rows)."""
    proj = reduce_from_model(grouped_matmul(attn, w_out), attn_tp) + b_out
    if dp1 is not None:
        proj = proj * dp1
    x2 = x_res.to(proj.dtype) + proj
    y = copy_to_model(ln_apply(x2, ln2_s, ln2_b), mlp_tp)
    h = apply_gelu(grouped_matmul(y, w1) + b1, gelu_impl)
    mlp_out = reduce_from_model(grouped_matmul(h, w2), mlp_tp) + b2
    if dp2 is not None:
        mlp_out = mlp_out * dp2
    return x2 + mlp_out


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth on a residual branch, per sample over the leading
    [G, B] dims: x * mask / keep with mask ~ Bernoulli(1 - rate), drawn
    from ``generator`` on x's device, or ``mask`` when the caller drew it
    (a checkpointed block draws its masks outside the checkpoint)."""
    if deterministic or rate <= 0.0:
        return x
    if mask is None:
        mask = keep_mask(x.shape[:2] + (1,) * (x.ndim - 2), 1.0 - rate, generator,
                         x.dtype, x.device, batch_dim=1)
    return x * mask / (1.0 - rate)


def keep_mask(shape, keep: float, generator: Optional[torch.Generator], dtype,
              device, batch_dim: int = 0) -> torch.Tensor:
    """0/1 mask of ``shape`` in ``dtype``, each entry 1 with probability keep.
    ``shape[batch_dim]`` counts samples: under a data-parallel step this
    process keeps its rows of the global batch's draw."""
    u = uniform_rows(shape, generator, device, batch_dim)
    return (u < keep).to(dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: inputs, kernel and bias are
    cast to ``dtype`` and multiplied there.  Also the shared trunk of a MER
    projection (the ``shared/{kernel,bias}`` path).  ``tp_row``: the mesh
    of a row-parallel shard, whose product is summed over the model group
    before the bias."""

    tp_row = None

    def __init__(self, in_dim: int, features: int, use_bias: bool = True, device=None):
        super().__init__()
        self.kernel = _param(in_dim, features, device=device)
        self.bias = _param(features, device=device) if use_bias else None

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = reduce_from_model(torch.matmul(x.to(dtype), self.kernel.to(dtype)), self.tp_row)
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
    adapter parameters stay so checkpoints are interchangeable.  Under
    tensor parallelism ``tp_col`` / ``tp_row`` hold the mesh of a column /
    row shard: a row shard's product is summed over the model group before
    the bias."""

    tp_col = None
    tp_row = None

    def __init__(self, in_dim: int, features: int, num_experts: int, rank: int = 4,
                 alpha: float = 1.0, dtype=torch.float32, enable: bool = True,
                 device=None):
        super().__init__()
        self.rank, self.alpha = rank, alpha
        self.dtype, self.enable = dtype, enable
        self.shared = Dense(in_dim, features, device=device)
        self.lora_A = _param(num_experts, in_dim, rank, device=device)
        self.lora_B = _param(num_experts, rank, features, device=device)

    def folded(self, expert_ids: Sequence[int],
               whole: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_eff [G, in, out], bias) in the compute dtype; of a shard, the
        shard's (``whole=True``: gathered whole over the model group)."""
        dt = self.dtype
        kernel = self.shared.kernel
        if self.enable:
            w = effective_weights(kernel, self.lora_A, self.lora_B, expert_ids,
                                  self.alpha / self.rank, dt)
        else:
            w = kernel.to(dt)[None].expand(len(expert_ids), *kernel.shape)
        b = self.shared.bias.to(dt)
        if whole and self.tp_col is not None:
            w, b = model_all_gather(w, 2, self.tp_col), model_all_gather(b, 0, self.tp_col)
        elif whole and self.tp_row is not None:
            w = model_all_gather(w, 1, self.tp_row)
        return w, b

    def thin(self, expert_ids: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A [G, in, r], B [G, r, out]) of the group experts in the compute dtype."""
        return (select_experts(self.lora_A, expert_ids).to(self.dtype),
                select_experts(self.lora_B, expert_ids).to(self.dtype))

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int],
                fold: bool = True) -> torch.Tensor:
        assert len(expert_ids) == x.shape[0], "one expert id per group"
        if not self.enable:
            return self.shared(x, self.dtype)
        dt = self.dtype
        if fold:
            y = grouped_matmul(x.to(dt), self.folded(expert_ids)[0])
        else:  # training: the thin side path
            xa = x.to(dt)
            a, b = self.thin(expert_ids)
            y = torch.matmul(xa, self.shared.kernel.to(dt))
            y = y + grouped_matmul(grouped_matmul(xa, a), b) * (self.alpha / self.rank)
        return reduce_from_model(y, self.tp_row) + self.shared.bias.to(dt)


class MERAttention(nn.Module):
    """MHA with MER-routed Q/K/V/out projections.  Q/K/V effective kernels
    concatenate into one [G, D, 3D] grouped matmul.  ``attn_impl``: 'xla'
    (einsum core), 'onesaug' (the ones-augmented core,
    ``attn_backend="onesaug"``), 'splash' (the splash core,
    ``attn_backend="splash"``) or 'auto' (JAX's ``use_pallas_attention=True``:
    in eval the fused kernel for CUDA tensors and the einsum core for CPU
    tensors; in training ``fused_mha`` on every device, which launches the
    kernel for CUDA tensors and runs its plain version for CPU ones).

    Training (``fold=False``) packs the three shared kernels into one
    [D, 3D] product and the three LoRA A's into one [G, D, 3r] thin product,
    and takes the f32-softmax einsum core under every ``attn_impl`` but
    'auto' (the serving cores are eval-only, as in JAX);
    ``attn_bwd="remat"`` recomputes that core in the backward
    (``torch.utils.checkpoint``) instead of storing its [N, H, S, S]
    probabilities.  ``tp``: the mesh of a tensor-parallel shard (H/m heads
    here; see the module docstring)."""

    tp = None

    def __init__(self, dim: int, num_heads: int, num_experts: int, rank: int = 4,
                 alpha: float = 1.0, dtype=torch.float32, attn_impl: str = "xla",
                 enable: bool = True, attn_bwd: str = "stored", device=None):
        super().__init__()
        if attn_impl not in ("xla", "onesaug", "splash", "auto"):
            raise ValueError(
                f"attn_impl={attn_impl!r}; valid: ['auto', 'onesaug', 'splash', 'xla']")
        if attn_bwd not in ("remat", "stored"):
            raise ValueError(f"attn_bwd={attn_bwd!r}; valid: ['remat', 'stored']")
        self.num_heads, self.dtype, self.attn_impl = num_heads, dtype, attn_impl
        self.attn_bwd, self.enable = attn_bwd, enable
        mer = dict(num_experts=num_experts, rank=rank, alpha=alpha, dtype=dtype,
                   enable=enable, device=device)
        self.q_proj = MERDense(dim, dim, **mer)
        self.k_proj = MERDense(dim, dim, **mer)
        self.v_proj = MERDense(dim, dim, **mer)
        self.out_proj = MERDense(dim, dim, **mer)

    def local_heads(self) -> int:
        """The heads this process runs: H, or H / m of a shard."""
        return self.num_heads // (1 if self.tp is None else self.tp.model_size)

    def folded(self, expert_ids: Sequence[int], whole: bool = False):
        """(w_qkv [G, D, 3D], b_qkv [3D], w_out [G, D, D], b_out [D]); of a
        shard [G, D, 3D/m], [3D/m], [G, D/m, D], [D] (``whole=True``:
        gathered whole)."""
        parts = [p.folded(expert_ids, whole) for p in (self.q_proj, self.k_proj, self.v_proj)]
        w_qkv = torch.cat([w for w, _ in parts], dim=2)
        b_qkv = torch.cat([b for _, b in parts], dim=0)
        return (w_qkv, b_qkv, *self.out_proj.folded(expert_ids, whole))

    def _thin_qkv(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        """The training QKV projection [G, B, S, 3D]: x @ W_pack + b, plus
        (x @ A_pack) split in three, each @ its B, times alpha / r."""
        projs = (self.q_proj, self.k_proj, self.v_proj)
        dt = self.dtype
        xa = copy_to_model(x, self.tp).to(dt)
        w_pack = torch.cat([p.shared.kernel.to(dt) for p in projs], dim=1)
        b_qkv = torch.cat([p.shared.bias.to(dt) for p in projs], dim=0)
        qkv = torch.matmul(xa, w_pack) + b_qkv
        if not self.enable:
            return qkv
        thin = [p.thin(expert_ids) for p in projs]
        z = grouped_matmul(xa, torch.cat([a for a, _ in thin], dim=2))  # [G, B, S, 3r]
        r = self.q_proj.rank
        deltas = [grouped_matmul(z[..., j * r:(j + 1) * r], b) for j, (_, b) in enumerate(thin)]
        return qkv + torch.cat(deltas, dim=-1) * (self.q_proj.alpha / r)

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int],
                fold: bool = True) -> torch.Tensor:
        G, B, S, D = x.shape
        Dh = D // self.num_heads
        H = self.local_heads()
        D = H * Dh  # this process's outputs
        if fold:
            w_qkv, b_qkv, _, _ = self.folded(expert_ids)
            qkv = grouped_matmul(copy_to_model(x, self.tp).to(self.dtype), w_qkv) + b_qkv
            # free-reshape unstack: q/k/v are strided views of the projection
            qkv5 = qkv.reshape(G, B, S, 3, H, Dh)
            q, k, v = qkv5[..., 0, :, :], qkv5[..., 1, :, :], qkv5[..., 2, :, :]
        else:
            # JAX's jnp.split: three [G, B, S, D] views, the same gradient
            q, k, v = self._thin_qkv(x, expert_ids).split(D, dim=-1)

        impl = self.attn_impl
        if impl == "auto":
            impl = "pallas" if (kernel_available(x) or not fold) else "xla"
        if impl in ("xla", "onesaug", "splash"):  # the [B, S, H, Dh] cores
            def merge2(t):
                return t.reshape(G * B, S, H, Dh)

            core = bshd_core(impl if fold else "xla")
            args = (merge2(q), merge2(k), merge2(v))
            if not fold and self.attn_bwd == "remat":
                out = checkpoint(core, *args, use_reentrant=False)
            else:
                out = core(*args)
            out = out.reshape(G, B, S, D)
        else:
            def split_heads(t):
                return t.reshape(G * B, S, H, Dh).permute(0, 2, 1, 3)

            out = dot_product_attention(split_heads(q), split_heads(k), split_heads(v),
                                        impl=impl)
            out = out.permute(0, 2, 1, 3).reshape(G, B, S, D)
        return self.out_proj(out, expert_ids, fold=fold)


class MERMlp(nn.Module):
    """fc1 -> GELU -> fc2, both MER-routed.  ``impl``: 'xla' (two grouped
    matmuls around the ``gelu_impl`` formulation, see :func:`apply_gelu`) or
    'auto' (JAX's ``impl="auto"``: the folded weights through ``fused_mlp``,
    which launches the fused kernel for CUDA tensors and runs its plain
    version for CPU tensors; both keep the kernel's own exact erf, as the JAX
    Pallas route does).  ``enable=False`` keeps the plain MLP: the kernel
    takes folded, routed weights.

    Training (``fold=False``) takes the two thin-LoRA products around the
    exact erf GELU whatever ``impl`` and ``gelu_impl`` say;
    ``gelu_bwd="stored"`` saves the forward's erf for the backward
    (:func:`gelu_stored`), "remat" recomputes it.  ``tp``: the mesh of a
    tensor-parallel shard (fc1's F/m outputs, fc2's F/m inputs)."""

    tp = None

    def __init__(self, dim: int, mlp_dim: int, num_experts: int, rank: int = 4,
                 alpha: float = 1.0, dtype=torch.float32, impl: str = "xla",
                 enable: bool = True, gelu_impl: str = "erf", gelu_bwd: str = "stored",
                 device=None):
        super().__init__()
        if impl not in ("xla", "auto"):
            raise ValueError(f"impl={impl!r}; valid: ['auto', 'xla']")
        if gelu_impl not in GELU_IMPLS:
            raise ValueError(f"gelu_impl={gelu_impl!r}; valid: {list(GELU_IMPLS)}")
        if gelu_bwd not in ("remat", "stored"):
            raise ValueError(f"gelu_bwd={gelu_bwd!r}; valid: ['remat', 'stored']")
        self.dtype, self.impl, self.enable, self.gelu_impl = dtype, impl, enable, gelu_impl
        self.gelu_bwd = gelu_bwd
        mer = dict(num_experts=num_experts, rank=rank, alpha=alpha, dtype=dtype,
                   enable=enable, device=device)
        self.fc1 = MERDense(dim, mlp_dim, **mer)
        self.fc2 = MERDense(mlp_dim, dim, **mer)

    def folded(self, expert_ids: Sequence[int], whole: bool = False):
        """(w1 [G, D, F], b1 [F], w2 [G, F, D], b2 [D]); of a shard F/m
        (``whole=True``: gathered whole)."""
        return (*self.fc1.folded(expert_ids, whole), *self.fc2.folded(expert_ids, whole))

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int],
                fold: bool = True) -> torch.Tensor:
        x = copy_to_model(x, self.tp)
        if not fold:
            h = self.fc1(x, expert_ids, fold=False)
            h = gelu_stored(h) if self.gelu_bwd == "stored" else gelu_erf(h)
            with unread_by_backward():
                return self.fc2(h, expert_ids, fold=False)
        if self.impl == "xla" or not self.enable:
            return self.fc2(apply_gelu(self.fc1(x, expert_ids), self.gelu_impl), expert_ids)
        G, B, S, D = x.shape
        w1, b1, w2, b2 = self.folded(expert_ids)
        # a shard's fc2 makes a partial sum: the kernel adds no bias, which
        # comes once after the sum
        b2k = b2 if self.tp is None else torch.zeros_like(b2)
        out = fused_mlp(x.to(self.dtype).reshape(G, B * S, D), w1.contiguous(),
                        b1[None].expand(G, -1), w2.contiguous(), b2k[None].expand(G, -1))
        if self.tp is not None:
            out = reduce_from_model(out, self.tp) + b2
        return out.reshape(G, B, S, D)


class MERBlock(nn.Module):
    """Pre-LN transformer block with MER routing and drop-path.  Grouped
    activations [G, B, S, D] with static per-group expert ids.  The eval
    forward (``deterministic=True``) folds the LoRAs; the training forward
    takes the thin side paths, exact erf, and per-sample drop-path at
    ``drop_path_rate`` on both residual branches (masks drawn from the
    caller's ``torch.Generator``).

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
                 block_impl: str = "xla", gelu_impl: str = "erf", drop_path_rate: float = 0.0,
                 gelu_bwd: str = "stored", attn_bwd: str = "stored", device=None):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl={block_impl!r}; valid: {list(BLOCK_IMPLS)}")
        self.num_heads, self.dtype = num_heads, dtype
        self.attn_impl, self.block_impl = attn_impl, block_impl
        self.drop_path_rate = drop_path_rate
        mer = dict(num_experts=num_experts, rank=rank, alpha=alpha, dtype=dtype,
                   device=device)
        self.ln1 = LNParams(dim, device=device)
        self.ln2 = LNParams(dim, device=device)
        self.attn = MERAttention(dim, num_heads, attn_impl=attn_impl, enable=enable_mer,
                                 attn_bwd=attn_bwd, **mer)
        self.mlp = MERMlp(dim, mlp_dim, impl=mlp_impl, enable=enable_mer,
                          gelu_impl=gelu_impl, gelu_bwd=gelu_bwd, **mer)

    def forward(self, x: torch.Tensor, expert_ids: Sequence[int], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not deterministic:
            return self.train_forward(x, expert_ids, *self.drop_path_masks(x, generator))
        if self.block_impl != "xla":
            return self._fused_call(x, expert_ids)
        x = x + self.attn(ln_apply(x, *self.ln1.params()), expert_ids)
        return x + self.mlp(ln_apply(x, *self.ln2.params()), expert_ids)

    def drop_path_masks(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        """The two residual branches' 0/1 keep masks [G, B, 1, 1] (None, None
        at rate 0).  Drawn outside :meth:`train_forward` so that a
        checkpointed block recomputes with the same masks."""
        if self.drop_path_rate <= 0.0:
            return None, None
        keep = 1.0 - self.drop_path_rate
        shape = x.shape[:2] + (1,) * (x.ndim - 2)
        return tuple(keep_mask(shape, keep, generator, x.dtype, x.device, batch_dim=1)
                     for _ in range(2))

    def train_forward(self, x: torch.Tensor, expert_ids: Sequence[int],
                      mask1: Optional[torch.Tensor] = None,
                      mask2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training forward (thin LoRA, exact erf) with the drop-path
        keep masks of :meth:`drop_path_masks`: x + attn * mask1 / keep, then
        x + mlp * mask2 / keep; every block_impl takes this path, as JAX's."""
        rate = self.drop_path_rate
        attn_out = self.attn(ln_apply(x, *self.ln1.params()), expert_ids, fold=False)
        x = x + drop_path(attn_out, rate, False, mask=mask1)
        mlp_out = self.mlp(ln_apply(x, *self.ln2.params()), expert_ids, fold=False)
        return x + drop_path(mlp_out, rate, False, mask=mask2)

    def cls_only_call(self, x: torch.Tensor, expert_ids: Sequence[int], deterministic: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Exact CLS-row output of the forward: [G,B,S,D] -> [G,B,D].  q, the
        out-projection and the MLP run for the CLS token only; k/v span all
        tokens; the weights are folded in training too.  The core is the
        ones-augmented one under 'onesaug' in eval and the einsum core
        otherwise, as in the JAX package.  In training the exact erf GELU,
        and per-sample drop-path masks [G, B, 1] on the CLS row's two
        residual branches."""
        G, B, S, D = x.shape
        Dh = D // self.num_heads
        H = self.attn.local_heads()
        D = H * Dh  # this process's outputs
        w_qkv, b_qkv, w_out, b_out = self.attn.folded(expert_ids)
        w1, b1, w2, b2 = self.mlp.folded(expert_ids)
        h = copy_to_model(ln_apply(x, *self.ln1.params()), self.attn.tp)
        kv = grouped_matmul(h, w_qkv[:, :, D:]) + b_qkv[D:]
        q = grouped_matmul(h[:, :, 0], w_qkv[:, :, :D]) + b_qkv[:D]
        k, v = kv[..., :D], kv[..., D:]
        attn = bshd_core(self._core() if deterministic else "xla")(
            q.reshape(G * B, 1, H, Dh),
            k.reshape(G * B, S, H, Dh),
            v.reshape(G * B, S, H, Dh),
        ).reshape(G, B, D)
        dp1 = dp2 = None
        if not deterministic and self.drop_path_rate > 0:
            keep = 1.0 - self.drop_path_rate
            dp1, dp2 = (keep_mask((G, B, 1), keep, generator, x.dtype, x.device,
                                  batch_dim=1) / keep for _ in range(2))
        return folded_block_tail(attn, x[:, :, 0], w_out, b_out, *self.ln2.params(),
                                 w1, b1, w2, b2, self.mlp.gelu_impl if deterministic else "erf",
                                 dp1, dp2, attn_tp=self.attn.tp, mlp_tp=self.mlp.tp)

    def _core(self) -> str:
        """The [B, S, H, Dh] core of ``cls_only_call`` and ``_fused_call``:
        'onesaug' where asked for, else the einsum core (JAX mer.py:668-672,
        :757-759)."""
        return "onesaug" if self.attn_impl == "onesaug" else "xla"

    def _fused_call(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        """LN1+QKV kernel -> einsum attention core -> out-proj+residual+LN2+
        MLP+residual kernel, in the block plan's ``quant``.  The int8 plans
        quantize the folded compute-dtype weights on every call, as JAX does:
        'fused_int8' all four projections, 'fused_int8_mlp' fc1 and fc2.  The
        kernels fuse across the row boundary, so a shard's folded weights are
        gathered whole and every process of the model group runs the block
        as one process does."""
        G, B, S, D = x.shape
        H = self.num_heads
        quant = {"fused_int8": "int8", "fused_int8_mlp": "int8_mlp"}.get(self.block_impl, "bf16")
        w_qkv, b_qkv, w_out, b_out = self.attn.folded(expert_ids, whole=True)
        w1, b1, w2, b2 = self.mlp.folded(expert_ids, whole=True)
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
