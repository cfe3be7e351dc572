"""Unified encoder: the MER vision trunk, the text tower and ``text_proj``
(counterpart of the JAX package's ``models/encoder.py::UnifiedEncoder``).
The text tower has no training-only behaviour (no dropout, no drop-path)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.mer import Dense
from prcv2025reid_tpu_torch.models.text import TextTower
from prcv2025reid_tpu_torch.models.vit import MERVisionTransformer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class UnifiedEncoder(nn.Module):
    """encode_vision(images, modality_id) -> [B, fusion_dim];
    encode_text(tokens) -> [B, fusion_dim].  ``text`` and ``text_proj`` may
    be left out (a vision-only encoder; its checkpoint's text keys are then
    skipped)."""

    def __init__(self, vision: MERVisionTransformer, text: Optional[TextTower] = None,
                 text_proj: Optional[Dense] = None):
        super().__init__()
        self.vision = vision
        if text is not None:
            self.text, self.text_proj = text, text_proj

    @classmethod
    def from_config(cls, config: TrainingConfig, device=None) -> "UnifiedEncoder":
        dtype = DTYPES[config.compute_dtype]
        text = TextTower(
            vocab_size=config.text_vocab_size,
            width=config.text_hidden_dim,
            num_layers=config.text_layers,
            num_heads=config.text_heads,
            mlp_dim=config.text_mlp_dim,
            context_length=config.text_context_length,
            dtype=dtype,
            device=device,
        )
        # the pooled text feature -> fusion_dim, no bias
        text_proj = Dense(config.text_hidden_dim, config.fusion_dim, use_bias=False,
                          device=device)
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
            dtype=dtype,
            attn_impl="auto" if config.use_pallas_attention else config.attn_backend,
            mlp_impl="auto" if config.use_fused_mlp else "xla",
            resln_impl="auto" if config.use_fused_resln else "xla",
            block_impl=config.block_impl,
            gelu_impl=config.gelu_impl,
            drop_path=config.drop_path,
            gelu_bwd=config.gelu_bwd,
            attn_bwd=config.attn_bwd,
            remat_blocks=config.remat_blocks,
            remat_policy=config.remat_policy,
            token_keep=config.token_keep,
            token_reduce_layer=config.token_reduce_layer,
            token_reduce_mode=config.token_reduce_mode,
            token_reduce_train=config.token_reduce_train,
            device=device,
        ), text, text_proj)

    def encode_vision(self, images: torch.Tensor, modality_id: int) -> torch.Tensor:
        return self.vision.encode_single(images, modality_id)

    def encode_vision_stacked(self, images: torch.Tensor, deterministic: bool = True,
                              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, Mv, H, W, 3] -> [B, Mv, fusion_dim], one trunk call."""
        return self.vision.encode_stacked(images, deterministic, generator)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_proj(self.text(tokens), self.text.dtype)
