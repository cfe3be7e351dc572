"""Vision trunk: per-modality patch embedding + MER transformer stack
(counterpart of the JAX package's ``models/vit.py``).

patchify -> +CLS -> +pos-embed -> blocks 0..L-2 -> CLS-only last block ->
final LN -> projection; in eval with ``resln_impl="auto"`` the fused-stream
trunk (``_trunk_fused``) instead, and in training under ``remat_blocks``
all L blocks in full, each recomputed in the backward (``remat_policy``
"full": from its input alone; "dots": the unbatched products saved, see
``dots_policy``).  With ``token_keep``
the tokens are reduced after block ``token_reduce_layer - 1``
(``_reduce_tokens``).  Patchify is a reshape + matmul: the 16x16/stride-16
"conv" is a linear map on non-overlapping patches, so the patch kernel keeps
its ``[P, P, C, D]`` layout flattened in (i, j, c) order (no ``conv2d``,
whose weight layout differs and which cuDNN runs in TF32 for f32).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from prcv2025reid_tpu_torch.data.device_feed import normalize_images_device
from prcv2025reid_tpu_torch.models.mer import (
    Dense,
    LNParams,
    MERBlock,
    _param,
    backward_unread,
    ln_apply,
)
from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln
from prcv2025reid_tpu_torch.utils.modalities import SINGLE_CHANNEL, VISION_MODALITIES


REMAT_POLICIES = ("full", "dots")
# the products without batch dimensions: x [.., in] @ W [in, out] folds to
# one of these; the grouped LoRA products and the attention core's QK^T and
# PV are aten.bmm, whose leading dimension is a batch dimension
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``, the counterpart of JAX's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    unbatched products (``DOTS_SAVED``) are saved, every other op (the
    LayerNorms, the batched LoRA and attention products, the softmax, the
    GELU, the attention kernel's launch) is recomputed in the backward.  A
    product made under ``mer.unread_by_backward`` (the MLP's fc2, whose
    output only feeds the residual add) is not saved either: JAX's partial
    evaluation keeps no residual that its backward does not read."""
    if op in DOTS_SAVED and not backward_unread():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, num_patches, P*P*C], (i, j, c) order in a patch."""
    N, H, W, C = images.shape
    P = patch_size
    h, w = H // P, W // P
    x = images.reshape(N, h, P, w, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(N, h * w, P * P * C)


class PatchEmbed(nn.Module):
    """Single-modality patch embedding.  1-channel modalities (nir/sk) reduce
    an RGB input to grayscale by channel mean first."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.in_chans, self.dtype = patch_size, in_chans, dtype
        self.kernel = _param(patch_size, patch_size, in_chans, embed_dim, device=device)
        self.bias = _param(embed_dim, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        P = self.patch_size
        images = normalize_images_device(images)
        if self.in_chans == 1 and images.shape[-1] == 3:
            images = images.mean(dim=-1, keepdim=True)
        dt = self.dtype
        patches = patchify(images.to(dt), P)
        w = self.kernel.reshape(P * P * self.in_chans, -1).to(dt)
        return torch.matmul(patches, w) + self.bias.to(dt)


class MERVisionTransformer(nn.Module):
    """The MER-routed ViT trunk.  ``mlp_impl`` and ``gelu_impl`` go to every
    block's MLP (see ``MERMlp``); ``resln_impl`` 'auto' selects the
    fused-stream eval trunk on every device (its residual+LN wrapper runs
    the plain version for CPU tensors), 'xla' the plain one.  Training:
    drop-path rises linearly with depth to ``drop_path`` at the last block;
    ``remat_blocks`` wraps every block in ``torch.utils.checkpoint``
    under ``remat_policy`` ("full" or "dots", :func:`dots_policy`);
    ``gelu_bwd`` and ``attn_bwd`` go to every block (see ``MERBlock``).
    ``token_keep`` > 0 keeps that many patch tokens after block
    ``token_reduce_layer - 1`` in eval, and in training too with
    ``token_reduce_train`` (``_reduce_tokens``; ``token_reduce_mode`` 'merge'
    or 'prune'); the fused-stream trunk runs every token, so it refuses
    token reduction."""

    def __init__(self, embed_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, patch_size: int = 16, image_size: int = 224,
                 fusion_dim: int = 512, lora_rank: int = 4, lora_alpha: float = 1.0,
                 enable_mer: bool = True,
                 modalities: Tuple[str, ...] = VISION_MODALITIES, dtype=torch.float32,
                 attn_impl: str = "xla", mlp_impl: str = "xla", resln_impl: str = "xla",
                 block_impl: str = "xla", gelu_impl: str = "erf", drop_path: float = 0.0,
                 gelu_bwd: str = "stored", attn_bwd: str = "stored", remat_blocks: bool = False,
                 remat_policy: str = "full", token_keep: int = 0, token_reduce_layer: int = 6,
                 token_reduce_mode: str = "merge", token_reduce_train: bool = False,
                 device=None):
        super().__init__()
        if resln_impl not in ("xla", "auto"):
            raise ValueError(f"resln_impl={resln_impl!r}; valid: ['auto', 'xla']")
        if token_reduce_mode not in ("merge", "prune"):
            raise ValueError(f"token_reduce_mode={token_reduce_mode!r}; valid: ['merge', 'prune']")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={remat_policy!r}; valid: {list(REMAT_POLICIES)}")
        if resln_impl == "auto" and token_keep > 0:
            raise ValueError(f"resln_impl='auto' runs every token: token_keep={token_keep} "
                             "needs resln_impl='xla'")
        self.embed_dim, self.num_layers, self.dtype = embed_dim, num_layers, dtype
        self.resln_impl, self.remat_blocks = resln_impl, remat_blocks
        self.remat_policy = remat_policy
        self.token_keep, self.token_reduce_layer = token_keep, token_reduce_layer
        self.token_reduce_mode, self.token_reduce_train = token_reduce_mode, token_reduce_train
        self.modalities = tuple(modalities)
        num_patches = (image_size // patch_size) ** 2
        for mod in self.modalities:
            self.add_module(f"patch_embed_{mod}", PatchEmbed(
                embed_dim, patch_size, 1 if mod in SINGLE_CHANNEL else 3, dtype, device))
        self.cls_token = _param(1, 1, embed_dim, device=device)
        self.pos_embed = _param(num_patches + 1, embed_dim, device=device)
        last = max(1, num_layers - 1)
        for i in range(num_layers):
            self.add_module(f"block_{i}", MERBlock(
                embed_dim, num_heads, mlp_dim, len(self.modalities), rank=lora_rank,
                alpha=lora_alpha, dtype=dtype, attn_impl=attn_impl, mlp_impl=mlp_impl,
                enable_mer=enable_mer, block_impl=block_impl, gelu_impl=gelu_impl,
                drop_path_rate=drop_path * (i / last), gelu_bwd=gelu_bwd, attn_bwd=attn_bwd,
                device=device))
        self.ln_final = LNParams(embed_dim, device=device)
        self.proj = Dense(embed_dim, fusion_dim, use_bias=False, device=device)

    def patch_embed(self, mod: str) -> PatchEmbed:
        return getattr(self, f"patch_embed_{mod}")

    @property
    def blocks(self) -> Tuple[MERBlock, ...]:
        return tuple(getattr(self, f"block_{i}") for i in range(self.num_layers))

    def trunk(self, patch_tokens: torch.Tensor, expert_ids: Sequence[int],
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[G, B, num_patches, D] + one expert id per group -> [G, B, fusion_dim].
        ``deterministic=False`` is the training forward; ``generator`` feeds
        its drop-path masks."""
        G, B = patch_tokens.shape[:2]
        dt = self.dtype
        cls = self.cls_token.to(dt).expand(G, B, 1, self.embed_dim)
        x = torch.cat([cls, patch_tokens.to(dt)], dim=2)
        x = x + self.pos_embed.to(dt)[None, None]
        if deterministic and self.resln_impl == "auto":
            return self._trunk_fused(x, expert_ids)
        blocks = self.blocks
        reduce_after = (
            self.token_reduce_layer - 1
            if (deterministic or self.token_reduce_train)
            and 0 < self.token_keep < x.shape[2] - 1
            and 0 < self.token_reduce_layer < self.num_layers
            else None
        )
        if deterministic or not self.remat_blocks:
            for i, block in enumerate(blocks[:-1]):
                x = block(x, expert_ids, deterministic, generator)
                if i == reduce_after:
                    x = self._reduce_tokens(x)
            cls = blocks[-1].cls_only_call(x, expert_ids, deterministic, generator)
        else:
            # training under remat: every block in full, its masks drawn
            # outside the checkpoint so that the recompute sees the same ones;
            # the reduction sits between the checkpointed blocks, so it is
            # stored, not recomputed
            policy = {} if self.remat_policy == "full" else dict(context_fn=functools.partial(
                create_selective_checkpoint_contexts, dots_policy))
            for i, block in enumerate(blocks):
                masks = block.drop_path_masks(x, generator)
                x = checkpoint(block.train_forward, x, expert_ids, *masks,
                               use_reentrant=False, **policy)
                if i == reduce_after:
                    x = self._reduce_tokens(x)
            cls = x[:, :, 0]
        cls = ln_apply(cls, *self.ln_final.params())
        return self.proj(cls, dt)

    def keep_indices(self, x: torch.Tensor) -> torch.Tensor:
        """The patch positions that ``_reduce_tokens`` keeps: [G, B, S, D] ->
        [G, B, K], ordered by cosine(token, CLS) on the hidden states (f32),
        highest first, ties to the lower position as ``jax.lax.top_k``
        orders them (a stable sort; ``torch.topk`` defines no order among
        ties on CUDA).  No gradient flows through the choice."""
        with torch.no_grad():
            xf = x.float()
            n = xf / torch.clamp(torch.linalg.vector_norm(xf, dim=-1, keepdim=True), min=1e-6)
            scores = (n[:, :, 1:] * n[:, :, :1]).sum(-1)  # [G, B, S-1]
            return torch.argsort(-scores, dim=-1, stable=True)[..., :self.token_keep]

    def _reduce_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """EViT-style token reduction: [G, B, S, D] -> [G, B, K+2, D] (CLS,
        the K kept patch tokens in ``keep_indices`` order, and one token
        holding the mean of the dropped ones), or [G, B, K+1, D] in 'prune'
        mode (the dropped tokens discarded).  The merged token is formed in
        f32 (total minus the kept sum, so the subtraction does not cancel
        in bf16), then cast back to x's dtype.  Gradients flow through the
        gather and the merge."""
        G, B, S, D = x.shape
        K = self.token_keep
        idx = self.keep_indices(x)[..., None].expand(G, B, K, D)
        kept = torch.gather(x[:, :, 1:], 2, idx)
        if self.token_reduce_mode == "prune":
            return torch.cat([x[:, :, :1], kept], dim=2)
        patches = x[:, :, 1:].float()
        kept_sum = torch.gather(patches, 2, idx).sum(dim=2)
        merged = (patches.sum(dim=2) - kept_sum) / max(S - 1 - K, 1)
        return torch.cat([x[:, :, :1], kept, merged[:, :, None].to(x.dtype)], dim=2)

    def _trunk_fused(self, x: torch.Tensor, expert_ids: Sequence[int]) -> torch.Tensor:
        """Eval trunk with the residual add fused into every LayerNorm
        (``fused_residual_ln``).  The pairs cross block boundaries: block i's
        MLP residual fuses with block i+1's ln1 (or ln_final), so the stream
        carries (residual x, normalised h).  Every block runs in full (no
        CLS-only last block)."""
        shape = x.shape
        D = shape[-1]

        def fused(x_res, branch, ln):
            xn, h = fused_residual_ln(x_res.reshape(-1, D), branch.reshape(-1, D), *ln.params())
            return xn.reshape(shape), h.reshape(shape)

        blocks = self.blocks
        h = ln_apply(x, *blocks[0].ln1.params())
        for i, block in enumerate(blocks):
            x, h = fused(x, block.attn(h, expert_ids), block.ln2)
            next_ln = blocks[i + 1].ln1 if i + 1 < len(blocks) else self.ln_final
            x, h = fused(x, block.mlp(h, expert_ids), next_ln)
        return self.proj(h[:, :, 0], self.dtype)

    def encode_single(self, images: torch.Tensor, modality_id: int) -> torch.Tensor:
        """Encode one modality: images [B, H, W, 3] -> [B, fusion_dim]."""
        mod = self.modalities[modality_id]
        tokens = self.patch_embed(mod)(images)[None]
        return self.trunk(tokens, (modality_id,))[0]

    def encode_stacked(self, images: torch.Tensor, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Every modality in one trunk call, G = Mv groups:
        [B, Mv, H, W, 3] -> [B, Mv, fusion_dim]."""
        if images.shape[1] != len(self.modalities):
            raise ValueError(f"images carry {images.shape[1]} modality slots, the trunk "
                             f"{len(self.modalities)}")
        tokens = torch.stack([self.patch_embed(mod)(images[:, i])
                              for i, mod in enumerate(self.modalities)], dim=0)
        feats = self.trunk(tokens, tuple(range(len(self.modalities))), deterministic, generator)
        return feats.transpose(0, 1)
