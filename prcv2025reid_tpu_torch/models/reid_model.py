"""Top-level multi-modal Re-ID model, eval embedding only (counterpart of
the JAX package's ``models/reid_model.py``).

Missing modalities are handled by masked blending with learnable null
tokens: feat = mask * enc + (1 - mask) * null.  ``encode_subset`` computes
only the active vision towers (one trunk call over all of them), fuses the
modality tokens and returns BNNeck features (L2 x 8).  The SDM module is
not ported yet (ROADMAP.md §1, the item 'The training trunk').
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.encoder import DTYPES, UnifiedEncoder
from prcv2025reid_tpu_torch.models.mer import Dense, LayerNorm, _param, gelu_erf


class FeatureFusion(nn.Module):
    """Mask-aware multi-head fusion over modality tokens, with the
    all-masked-sample rescue (unmask slot 0 and substitute the global mean
    feature) and the masked mean pool."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 2.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(dim, dim, device=device))
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, device=device)
        self.mlp_ln = LayerNorm(dim, device=device)
        self.mlp_fc1 = Dense(dim, hidden, device=device)
        self.mlp_fc2 = Dense(hidden, dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)

    def forward(self, feats: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        B, M, D = feats.shape
        H, dt = self.num_heads, self.dtype
        hd = D // H
        masks = masks.to(feats.dtype)

        # all-masked rescue
        all_masked = masks.sum(dim=1) == 0
        any_valid = (~all_masked).to(feats.dtype)
        denom = torch.clamp(any_valid.sum() * M, min=1.0)
        global_mean = (feats * any_valid[:, None, None]).sum(dim=(0, 1)) / denom
        slot0 = torch.arange(M, device=feats.device) == 0
        feats = torch.where((all_masked[:, None] & slot0[None, :])[..., None],
                            global_mean[None, None, :], feats)
        attn_masks = torch.where(all_masked[:, None], slot0[None, :].to(masks.dtype), masks)

        def split(t):
            return t.reshape(B, M, H, hd).permute(0, 2, 1, 3)

        q, k, v = (split(getattr(self, n)(feats, dt)) for n in ("q_proj", "k_proj", "v_proj"))
        logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) * hd**-0.5).float()
        key_bias = (1.0 - attn_masks[:, None, None, :].float()) * -1e9
        weights = torch.softmax(logits + key_bias, dim=-1).to(feats.dtype)
        attn = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        attn = self.out_proj(attn.permute(0, 2, 1, 3).reshape(B, M, D), dt)

        x = self.norm1(feats + attn, dt)
        h = self.mlp_fc1(self.mlp_ln(x, dt), dt)
        h = self.mlp_fc2(gelu_erf(h), dt)
        x = self.norm2(x + h, dt)
        x = torch.nan_to_num(x, nan=0.0, posinf=1e4, neginf=-1e4)

        valid = masks[..., None]
        counts = torch.clamp(masks.sum(dim=1, keepdim=True), min=1.0)
        return (x * valid).sum(dim=1) / counts


class _TorchBatchNorm(nn.Module):
    """BatchNorm with running statistics (eval mode): ``scale`` parameter,
    ``mean``/``var`` buffers, no bias."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(features, device=device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * (torch.rsqrt(self.var + self.eps) * self.scale)


class BNNeck(nn.Module):
    """BatchNorm -> L2-normalize x 8 (eval).  The bias-free classifier is
    loaded with the checkpoint; the embedding path does not use it."""

    def __init__(self, dim: int, num_classes: int, device=None):
        super().__init__()
        self.bn = _TorchBatchNorm(dim, device=device)
        self.classifier = Dense(dim, num_classes, use_bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn(x.float())
        norm = torch.clamp(torch.linalg.vector_norm(bn, dim=1, keepdim=True), min=1e-12)
        return bn / norm * 8.0


class MultiModalReIDModel(nn.Module):
    """Vision and text encoders + fusion + BNNeck + null tokens (eval
    embedding)."""

    def __init__(self, config: TrainingConfig, num_classes: int, device=None):
        super().__init__()
        self.config = config
        self.dtype = DTYPES[config.compute_dtype]
        self.encoder = UnifiedEncoder.from_config(config, device=device)
        self.fusion = FeatureFusion(config.fusion_dim, config.fusion_num_heads,
                                    config.fusion_mlp_ratio, self.dtype, device=device)
        self.bn_neck = BNNeck(config.fusion_dim, num_classes, device=device)
        # one row per vision slot + the text slot (last row)
        self.null_tokens = _param(len(config.vision_modalities) + 1, config.fusion_dim,
                                  device=device)

    def encode_subset(self, images: torch.Tensor, image_mask: torch.Tensor,
                      text_tokens: Optional[torch.Tensor], text_mask: Optional[torch.Tensor],
                      active: Sequence[str]) -> torch.Tensor:
        """Eval embedding computing only the active modality towers.

        images uint8 (or normalized float) [B, Mv, H, W, 3]; image_mask
        [B, Mv]; text_tokens [B, S] (int) and text_mask [B], read only when
        "text" is active (the last slot).  Inactive slots carry null tokens
        with zero masks.  Returns bn_features [B, fusion_dim] (L2 x 8, f32)."""
        vis_mods = self.config.vision_modalities
        unknown = [m for m in active if m not in vis_mods + ("text",)]
        if unknown:
            raise ValueError(f"active modalities {unknown} not in {vis_mods + ('text',)}")
        if "text" in active and (text_tokens is None or text_mask is None):
            raise ValueError("'text' in the active set needs text_tokens and text_mask")
        B, Mv = images.shape[:2]
        M = Mv + 1
        dt = self.dtype
        null = self.null_tokens.to(dt)
        feats = null[None].expand(B, M, null.shape[-1]).clone()
        masks = torch.zeros(B, M, dtype=torch.float32, device=images.device)

        active_vis = [(mi, mod) for mi, mod in enumerate(vis_mods) if mod in active]
        if active_vis:
            vit = self.encoder.vision
            tokens = torch.stack(
                [vit.patch_embed(mod)(images[:, mi]) for mi, mod in active_vis], dim=0)
            all_feats = vit.trunk(tokens, tuple(mi for mi, _ in active_vis))
            for j, (mi, _) in enumerate(active_vis):
                m = image_mask[:, mi].float()[:, None]
                feats[:, mi] = m.to(dt) * all_feats[j] + (1 - m).to(dt) * null[mi]
                masks[:, mi] = m[:, 0]
        if "text" in active:
            f = self.encoder.encode_text(text_tokens)
            m = text_mask.float()[:, None]
            feats[:, M - 1] = m.to(dt) * f + (1 - m).to(dt) * null[M - 1]
            masks[:, M - 1] = m[:, 0]

        return self.bn_neck(self.fusion(feats, masks))
