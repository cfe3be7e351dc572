"""Top-level multi-modal Re-ID model (counterpart of the JAX package's
``models/reid_model.py``) and its loss, ``compute_loss``.

Missing modalities are handled by masked blending with learnable null
tokens: feat = mask * enc + (1 - mask) * null.  ``encode_subset`` computes
only the active vision towers (one trunk call over all of them), fuses the
modality tokens and returns BNNeck features (L2 x 8); ``encode_weighted``
embeds each active modality alone through the head and weight-sums the
unit features.  ``forward`` is the
full model, the training forward with ``train=True``: every modality
densely, the SDM module, modality dropout, fusion and BNNeck on batch
statistics.  Its randomness comes from ``torch.Generator``s, one per purpose
('dropout', 'droppath', 'moddrop', as the JAX package's rng streams).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.encoder import DTYPES, UnifiedEncoder
from prcv2025reid_tpu_torch.models.mer import Dense, LayerNorm, _param, gelu_erf, keep_mask
from prcv2025reid_tpu_torch.ops.losses import (
    masked_cross_entropy,
    multimodal_sdm_loss,
    multimodal_sdm_loss_batched,
    scalar_f32,
)

Generators = Optional[Mapping[str, torch.Generator]]


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: x / keep where a Bernoulli(keep) draw keeps it,
    else 0."""
    if deterministic or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


class SemanticDisentanglementModule(nn.Module):
    """Seq-len-1 self-attention + residual + 2-layer projection.  With one
    token the softmax weight is exactly 1, so the attention is
    attn_out_proj(v_proj(x)); the attention-weight dropout then drops and
    rescales per (sample, head).  The q/k projections cancel and do not
    exist."""

    def __init__(self, dim: int, semantic_dim: int = 512, num_heads: int = 8,
                 dropout_rate: float = 0.1, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads, self.dropout_rate, self.dtype = num_heads, dropout_rate, dtype
        self.v_proj = Dense(dim, dim, device=device)
        self.attn_out_proj = Dense(dim, dim, device=device)
        self.proj1 = Dense(dim, semantic_dim, device=device)
        self.proj_ln = LayerNorm(semantic_dim, eps=1e-6, device=device)  # flax's default eps
        self.proj2 = Dense(semantic_dim, semantic_dim, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        B, D = x.shape
        v = self.v_proj(x, dt)
        if not deterministic and self.dropout_rate > 0:
            H = self.num_heads
            keep = 1.0 - self.dropout_rate
            mask = keep_mask((B, H, 1), keep, generator, x.dtype, x.device)
            v = (v.reshape(B, H, D // H) * mask / keep).reshape(B, D)
        x = x + self.attn_out_proj(v, dt)
        h = torch.relu(self.proj_ln(self.proj1(x, dt), dt))
        h = dropout(h, self.dropout_rate, deterministic, generator)
        return self.proj2(h, dt)


class FeatureFusion(nn.Module):
    """Mask-aware multi-head fusion over modality tokens, with the
    all-masked-sample rescue (unmask slot 0 and substitute the global mean
    feature) and the masked mean pool."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 2.0,
                 dtype=torch.float32, dropout_rate: float = 0.1, device=None):
        super().__init__()
        self.num_heads, self.dtype, self.dropout_rate = num_heads, dtype, dropout_rate
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(dim, dim, device=device))
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, device=device)
        self.mlp_ln = LayerNorm(dim, device=device)
        self.mlp_fc1 = Dense(dim, hidden, device=device)
        self.mlp_fc2 = Dense(hidden, dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)

    def forward(self, feats: torch.Tensor, masks: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feats [B, M, D], masks [B, M] -> [B, D]; in training (not
        ``deterministic``) dropout on the attention weights and after the
        GELU and fc2 of the MLP."""
        B, M, D = feats.shape
        rate = self.dropout_rate
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
        weights = dropout(weights, rate, deterministic, generator)
        attn = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        attn = self.out_proj(attn.permute(0, 2, 1, 3).reshape(B, M, D), dt)

        x = self.norm1(feats + attn, dt)
        h = self.mlp_fc1(self.mlp_ln(x, dt), dt)
        h = dropout(gelu_erf(h), rate, deterministic, generator)
        h = dropout(self.mlp_fc2(h, dt), rate, deterministic, generator)
        x = self.norm2(x + h, dt)
        x = torch.nan_to_num(x, nan=0.0, posinf=1e4, neginf=-1e4)

        valid = masks[..., None]
        counts = torch.clamp(masks.sum(dim=1, keepdim=True), min=1.0)
        return (x * valid).sum(dim=1) / counts


class _TorchBatchNorm(nn.Module):
    """BatchNorm with torch ``BatchNorm1d``'s running-statistics semantics:
    ``scale`` parameter, ``mean``/``var`` buffers, no bias.  Training
    normalises with the batch's biased variance (E[x^2] - E[x]^2, clamped at
    0) and averages the unbiased one (x n / (n - 1)) into the running
    variance, with flax's convention: running = 0.9 running + 0.1 batch."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = _param(features, device=device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * (torch.rsqrt(self.var + self.eps) * self.scale)

    def batch_forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training: (output on the batch statistics, new running mean, new
        running var).  The buffers are left as they are: the caller writes
        the new statistics (the train step keeps the old ones on a skipped
        step)."""
        n = x.shape[0]
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
        m = self.momentum
        with torch.no_grad():
            new_mean = m * self.mean + (1.0 - m) * mean
            new_var = m * self.var + (1.0 - m) * (var * (n / max(n - 1, 1)))
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale), new_mean, new_var


class BNNeck(nn.Module):
    """BatchNorm -> L2-normalize x 8 -> dropout -> bias-free f32 classifier.
    ``forward`` is the embedding (bn features only); :meth:`head` adds the
    logits and, in training, the batch statistics."""

    def __init__(self, dim: int, num_classes: int, dropout_rate: float = 0.5, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.bn = _TorchBatchNorm(dim, device=device)
        self.classifier = Dense(dim, num_classes, use_bias=False, device=device)

    @staticmethod
    def _l2x8(bn: torch.Tensor) -> torch.Tensor:
        norm = torch.clamp(torch.linalg.vector_norm(bn, dim=1, keepdim=True), min=1e-12)
        return bn / norm * 8.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._l2x8(self.bn(x.float()))

    def head(self, x: torch.Tensor, train: bool = False,
             generator: Optional[torch.Generator] = None):
        """(bn_features, logits, new running statistics or None)."""
        stats = None
        if train:
            bn, new_mean, new_var = self.bn.batch_forward(x.float())
            stats = {"bn_neck.bn.mean": new_mean, "bn_neck.bn.var": new_var}
        else:
            bn = self.bn(x.float())
        bn_features = self._l2x8(bn)
        dropped = dropout(bn_features, self.dropout_rate, not train, generator)
        return bn_features, self.classifier(dropped, torch.float32), stats


class MultiModalReIDModel(nn.Module):
    """Vision and text encoders + SDM module + fusion + BNNeck + null
    tokens."""

    def __init__(self, config: TrainingConfig, num_classes: int, device=None):
        super().__init__()
        self.config = config
        self.dtype = DTYPES[config.compute_dtype]
        self.encoder = UnifiedEncoder.from_config(config, device=device)
        self.sdm_module = SemanticDisentanglementModule(
            config.fusion_dim, config.sdm_semantic_dim, config.sdm_num_heads,
            config.sdm_dropout, self.dtype, device=device)
        self.fusion = FeatureFusion(config.fusion_dim, config.fusion_num_heads,
                                    config.fusion_mlp_ratio, self.dtype,
                                    config.fusion_dropout, device=device)
        self.bn_neck = BNNeck(config.fusion_dim, num_classes, config.dropout_rate,
                              device=device)
        # one row per vision slot + the text slot (last row)
        self.null_tokens = _param(len(config.vision_modalities) + 1, config.fusion_dim,
                                  device=device)

    def _check_active(self, active: Sequence[str], text_tokens: Optional[torch.Tensor],
                      text_mask: Optional[torch.Tensor]) -> None:
        names = self.config.vision_modalities + ("text",)
        unknown = [m for m in active if m not in names]
        if unknown:
            raise ValueError(f"active modalities {unknown} not in {names}")
        if "text" in active and (text_tokens is None or text_mask is None):
            raise ValueError("'text' in the active set needs text_tokens and text_mask")

    def _active_vision(self, images: torch.Tensor, active: Sequence[str]):
        """One trunk call over the active vision modalities, G = n_active
        groups: [(slot, modality, features [B, fusion_dim])]."""
        active_vis = [(mi, mod) for mi, mod in enumerate(self.config.vision_modalities)
                      if mod in active]
        if not active_vis:
            return []
        vit = self.encoder.vision
        tokens = torch.stack([vit.patch_embed(mod)(images[:, mi]) for mi, mod in active_vis],
                             dim=0)
        feats = vit.trunk(tokens, tuple(mi for mi, _ in active_vis))
        return [(mi, mod, feats[j]) for j, (mi, mod) in enumerate(active_vis)]

    def encode_subset(self, images: torch.Tensor, image_mask: torch.Tensor,
                      text_tokens: Optional[torch.Tensor], text_mask: Optional[torch.Tensor],
                      active: Sequence[str]) -> torch.Tensor:
        """Eval embedding computing only the active modality towers.

        images uint8 (or normalized float) [B, Mv, H, W, 3]; image_mask
        [B, Mv]; text_tokens [B, S] (int) and text_mask [B], read only when
        "text" is active (the last slot).  Inactive slots carry null tokens
        with zero masks.  Returns bn_features [B, fusion_dim] (L2 x 8, f32)."""
        self._check_active(active, text_tokens, text_mask)
        B, Mv = images.shape[:2]
        M = Mv + 1
        dt = self.dtype
        null = self.null_tokens.to(dt)
        feats = null[None].expand(B, M, null.shape[-1]).clone()
        masks = torch.zeros(B, M, dtype=torch.float32, device=images.device)

        for mi, _, f in self._active_vision(images, active):
            m = image_mask[:, mi].float()[:, None]
            feats[:, mi] = m.to(dt) * f + (1 - m).to(dt) * null[mi]
            masks[:, mi] = m[:, 0]
        if "text" in active:
            f = self.encoder.encode_text(text_tokens)
            m = text_mask.float()[:, None]
            feats[:, M - 1] = m.to(dt) * f + (1 - m).to(dt) * null[M - 1]
            masks[:, M - 1] = m[:, 0]

        return self.bn_neck(self.fusion(feats, masks))

    def encode_weighted(self, images: torch.Tensor, image_mask: torch.Tensor,
                        text_tokens: Optional[torch.Tensor], text_mask: Optional[torch.Tensor],
                        active: Sequence[str], weights: Sequence[float]) -> torch.Tensor:
        """Weighted-sum fusion of per-modality embeddings: each active
        modality alone through the head (its own slot, null tokens
        elsewhere; fusion, then BNNeck on running statistics), L2-normalised
        in f32, weight-summed (``weights``, one per active modality) and
        renormalised.  All active vision modalities go through one stacked
        trunk call.  Inputs as ``encode_subset``; returns unit f32
        [B, fusion_dim]."""
        self._check_active(active, text_tokens, text_mask)
        B, Mv = images.shape[:2]
        M = Mv + 1
        dt = self.dtype
        null = self.null_tokens.to(dt)

        # modality -> (slot, features, mask [B])
        per_mod = {mod: (mi, f, image_mask[:, mi].float())
                   for mi, mod, f in self._active_vision(images, active)}
        if "text" in active:
            per_mod["text"] = (M - 1, self.encoder.encode_text(text_tokens), text_mask.float())

        acc = None
        for mod, w in zip(active, weights):
            slot, f, m = per_mod[mod]
            m = m[:, None]
            feats = null[None].expand(B, M, null.shape[-1]).clone()
            feats[:, slot] = m.to(dt) * f + (1 - m).to(dt) * null[slot]
            masks = torch.zeros(B, M, dtype=torch.float32, device=images.device)
            masks[:, slot] = m[:, 0]
            bn = self.bn_neck(self.fusion(feats, masks)).float()
            bn = bn / torch.clamp(torch.linalg.vector_norm(bn, dim=1, keepdim=True), min=1e-12)
            acc = bn * w if acc is None else acc + bn * w
        return acc / torch.clamp(torch.linalg.vector_norm(acc, dim=1, keepdim=True), min=1e-12)

    def forward(self, images: torch.Tensor, image_mask: torch.Tensor, text_tokens: torch.Tensor,
                text_mask: torch.Tensor, train: bool = False,
                enable_modality_dropout: bool = False, generators: Generators = None,
                ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
        """The full model: every modality encoded densely (masks carry
        validity), null blend, the SDM module (training only), modality
        dropout (training, when enabled), fusion and BNNeck.

        images uint8 (or normalized float) [B, Mv, H, W, 3], image_mask
        [B, Mv], text_tokens [B, S] int, text_mask [B].  Returns (outputs,
        new_batch_stats): outputs holds JAX's seven keys (``features``,
        ``raw_modality_features`` [M, B, D], ``modality_features``,
        ``feature_masks`` [M, B], ``effective_masks``, ``bn_features``,
        ``logits``); new_batch_stats is BNNeck's new running statistics by
        buffer name in training, None in eval.  ``generators`` maps
        'dropout', 'droppath' and 'moddrop' to the generator each purpose
        draws from (a missing one: the global generator)."""
        cfg = self.config
        gens = dict(generators or {})
        B, Mv = images.shape[:2]
        M = Mv + 1
        vis = self.encoder.encode_vision_stacked(images, not train, gens.get("droppath"))
        feats = torch.cat([vis, self.encoder.encode_text(text_tokens)[:, None]], dim=1)
        masks = torch.cat([image_mask, text_mask[:, None]], dim=1).float()
        m = masks[..., None].to(feats.dtype)
        raw = m * feats + (1.0 - m) * self.null_tokens.to(feats.dtype)[None]
        if train:
            sem = self.sdm_module(raw.reshape(B * M, -1), False,
                                  gens.get("dropout")).reshape(B, M, -1)
        else:
            sem = raw
        eff_masks = masks
        if train and enable_modality_dropout and cfg.modality_dropout > 0:
            coin = torch.rand(M, generator=gens.get("moddrop"), device=masks.device)
            keep = (coin > cfg.modality_dropout).to(masks.dtype)
            keep[0] = 1.0  # never drop 'vis'
            dropped = masks * keep[None, :]
            sample_ok = (dropped.sum(dim=1) > 0) | (masks.sum(dim=1) == 0)
            safe = sample_ok.all() & (keep.sum() >= cfg.min_modalities)
            eff_masks = torch.where(safe, dropped, masks)
        fused = self.fusion(sem, eff_masks, not train, gens.get("dropout"))
        bn_features, logits, stats = self.bn_neck.head(fused, train, gens.get("dropout"))
        outputs = {
            "features": fused,
            "raw_modality_features": raw.transpose(0, 1),
            "modality_features": sem.transpose(0, 1),
            "feature_masks": masks.T,
            "effective_masks": eff_masks.T,
            "bn_features": bn_features,
            "logits": logits,
        }
        return outputs, stats


def compute_loss(outputs: Mapping[str, torch.Tensor], labels: torch.Tensor, *,
                 ce_weight: float = 1.0, sdm_weight: Union[float, torch.Tensor] = 0.0,
                 sdm_tau: Union[float, torch.Tensor] = 0.2, label_smoothing: float = 0.1,
                 sdm_impl: str = "unrolled") -> Dict[str, torch.Tensor]:
    """CE + SDM combination, the f32 island.  ``sdm_weight`` is the live
    scheduler value (0 disables the SDM term); SDM reads the raw (pre-SDM-
    module) features; both terms read the post-modality-dropout
    ``effective_masks``.  Non-finite terms are zeroed."""
    masks = outputs.get("effective_masks", outputs["feature_masks"])  # [M, B]
    any_valid = (masks.sum(dim=0) > 0).float()
    ce_loss, ce_valid_cnt = masked_cross_entropy(outputs["logits"], labels, any_valid,
                                                 label_smoothing)
    sdm_fn = multimodal_sdm_loss_batched if sdm_impl == "batched" else multimodal_sdm_loss
    sdm = sdm_fn(outputs["raw_modality_features"].float(), masks, labels, tau=sdm_tau,
                 vis_slot=0)
    w = scalar_f32(sdm_weight, ce_loss)
    zero = torch.zeros((), dtype=torch.float32, device=ce_loss.device)
    sdm = torch.where(w > 0, sdm, zero)
    ce_loss = torch.where(torch.isfinite(ce_loss), ce_loss, zero)
    sdm = torch.where(torch.isfinite(sdm), sdm, zero)
    total = ce_weight * ce_loss + w * sdm
    return {"total_loss": total, "ce_loss": ce_loss, "sdm_loss": sdm,
            "contrastive_loss": sdm, "ce_valid_cnt": ce_valid_cnt}
