"""Unified encoder, vision half (counterpart of the JAX package's
``models/encoder.py::UnifiedEncoder``).  The text tower and ``text_proj``
are not ported yet (ROADMAP.md §1, the item 'Text tower and encoder')."""
from __future__ import annotations

import torch
from torch import nn

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.vit import MERVisionTransformer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class UnifiedEncoder(nn.Module):
    """encode_vision(images, modality_id) -> [B, fusion_dim]."""

    def __init__(self, vision: MERVisionTransformer):
        super().__init__()
        self.vision = vision

    @classmethod
    def from_config(cls, config: TrainingConfig, device=None) -> "UnifiedEncoder":
        return cls(MERVisionTransformer(
            embed_dim=config.vision_hidden_dim,
            num_layers=config.vision_layers,
            num_heads=config.vision_heads,
            mlp_dim=config.vision_mlp_dim,
            patch_size=config.patch_size,
            image_size=config.image_size,
            fusion_dim=config.fusion_dim,
            lora_rank=config.mer_lora_rank,
            lora_alpha=config.mer_lora_alpha,
            enable_mer=config.enable_mer,
            modalities=config.vision_modalities,
            dtype=DTYPES[config.compute_dtype],
            attn_impl="auto" if config.use_pallas_attention else config.attn_backend,
            mlp_impl="auto" if config.use_fused_mlp else "xla",
            resln_impl="auto" if config.use_fused_resln else "xla",
            block_impl=config.block_impl,
            gelu_impl=config.gelu_impl,
            device=device,
        ))

    def encode_vision(self, images: torch.Tensor, modality_id: int) -> torch.Tensor:
        return self.vision.encode_single(images, modality_id)
