"""CLIP text tower (counterpart of the JAX package's ``models/text.py``).

Architecture (openai/clip-vit-base-patch16): vocab 49,408, width 512, 12
layers, 8 heads, context 77, quick_gelu, causal attention, a final LN, and
the pooled output read at the EOT token (the highest token id, so its
position is ``argmax(tokens)``).  ``text_proj`` (width -> fusion_dim, no
bias) lives in the unified encoder, not here.

The attention core is the plain einsum core with the causal mask
(``ops/attention.py::xla_attention``), as the JAX tower's ``impl="xla"``.
Parameters keep the flax names and layouts: ``token_embedding.embedding``
[vocab, width], ``pos_embed`` [context, width], ``block_{i}`` with
``ln1``/``ln2`` and the ``[in, out]`` kernels of ``q_proj``, ``k_proj``,
``v_proj``, ``out_proj``, ``fc1`` and ``fc2``.
"""
from __future__ import annotations

import torch
from torch import nn

from prcv2025reid_tpu_torch.models.mer import Dense, LayerNorm, _param
from prcv2025reid_tpu_torch.ops.attention import xla_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class TextBlock(nn.Module):
    """Pre-LN causal transformer block (HF ``CLIPEncoderLayer``).  No padding
    mask: under the causal mask position i sees only positions <= i, and the
    pooled output is read at the EOT token, the last real one, so padding
    (all after it) never reaches it."""

    def __init__(self, width: int, num_heads: int, mlp_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.ln1 = LayerNorm(width, device=device)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(width, width, device=device))
        self.ln2 = LayerNorm(width, device=device)
        self.fc1 = Dense(width, mlp_dim, device=device)
        self.fc2 = Dense(mlp_dim, width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        H, dt = self.num_heads, self.dtype

        def split(t):
            return t.reshape(B, S, H, D // H).permute(0, 2, 1, 3)

        h = self.ln1(x, dt)
        q, k, v = (split(getattr(self, n)(h, dt)) for n in ("q_proj", "k_proj", "v_proj"))
        attn = xla_attention(q, k, v, causal=True).permute(0, 2, 1, 3).reshape(B, S, D)
        x = x + self.out_proj(attn, dt)
        h = quick_gelu(self.fc1(self.ln2(x, dt), dt))
        return x + self.fc2(h, dt)


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding`` [vocab, width] in the compute
    dtype (gathered, then cast: the same values as casting the table)."""

    def __init__(self, vocab: int, width: int, device=None):
        super().__init__()
        self.embedding = _param(vocab, width, device=device)

    def forward(self, tokens: torch.Tensor, dtype) -> torch.Tensor:
        return self.embedding[tokens].to(dtype)


class TextTower(nn.Module):
    """tokens [B, S] (int, padded, S <= context length) -> pooled [B, width]."""

    def __init__(self, vocab_size: int = 49408, width: int = 512, num_layers: int = 12,
                 num_heads: int = 8, mlp_dim: int = 2048, context_length: int = 77,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.num_layers = dtype, num_layers
        self.token_embedding = Embed(vocab_size, width, device=device)
        self.pos_embed = _param(context_length, width, device=device)
        for i in range(num_layers):
            self.add_module(f"block_{i}",
                            TextBlock(width, num_heads, mlp_dim, dtype, device=device))
        self.ln_final = LayerNorm(width, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()  # numpy rows arrive as int64 or int32: the same ids
        x = self.token_embedding(tokens, self.dtype)
        S = tokens.shape[1]
        x = x + self.pos_embed[:S].to(x.dtype)[None]
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_final(x, self.dtype)
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]
