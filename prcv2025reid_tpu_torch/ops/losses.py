"""Loss functions: masked SDM alignment and masked ID cross-entropy
(counterpart of the JAX package's ``ops/losses.py``).

- ``sdm_loss``: vis-anchored Similarity Distribution Matching with static
  shapes: validity enters as row and column masks.  Invalid columns leave
  the softmax by an additive -1e9, invalid rows contribute zero and leave
  the mean.
- ``masked_cross_entropy``: label smoothing, validity = (any modality
  valid) AND (label in range).

Everything here runs in float32 whatever the trunk's compute dtype: this is
the f32 island.  The similarity products run in full f32 (TF32 off inside
the function, whatever the process default), as JAX's ``Precision.HIGHEST``.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple, Union

import torch

_NEG_BIG = -1e9  # additive mask for excluded softmax columns

Scalar = Union[float, torch.Tensor]


@contextmanager
def full_f32_matmul():
    """Products in full f32 (no TF32) for the block, restoring the setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _masked_one_side_ce(S: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                        col_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction of the SDM cross-entropy H(q, softmax(S)); S, y [N, M],
    row_valid [N], col_valid [M] (f32).  Returns (loss, num_valid_rows).  A
    row is valid iff its mask is set and it has a valid positive column."""
    y_eff = y * row_valid[:, None] * col_valid[None, :]
    row_pos = y_eff.sum(dim=1)
    valid = (row_pos > 0).to(S.dtype) * row_valid
    q = y_eff / torch.clamp(row_pos[:, None], min=1.0)  # uniform over valid positives
    log_p = torch.log_softmax(S + (1.0 - col_valid[None, :]) * _NEG_BIG, dim=1)
    ce_per_row = -(q * log_p).sum(dim=1)
    n_valid = valid.sum()
    loss = (ce_per_row * valid).sum() / torch.clamp(n_valid, min=1.0)
    return loss, n_valid


def scalar_f32(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A scalar as an f32 tensor on ``like``'s device; a Python number is
    filled there (no host-to-device copy, so no synchronisation)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def sdm_loss(qry: torch.Tensor, gal: torch.Tensor, y: torch.Tensor, qry_valid: torch.Tensor,
             gal_valid: torch.Tensor, tau: Scalar = 0.2,
             eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric SDM loss with validity masks; returns (loss, has_pairs).

    qry [N, D] (a non-vis modality), gal [M, D] (vis), y [N, M] the
    same-identity indicator, masks [N] and [M].  tau is clamped to
    [0.15, 0.5], both sides L2-normalised, similarities clamped to +-20;
    the loss is 0.5 (q->g + g->q).  ``has_pairs`` is 1 when a valid positive
    pair exists; a non-finite or negative loss is zeroed."""
    qry, gal, y = qry.float(), gal.float(), y.float()
    qry_valid, gal_valid = qry_valid.float(), gal_valid.float()
    tau_eff = torch.clamp(scalar_f32(tau, qry), 0.15, 0.5)
    qn = qry / torch.clamp(torch.linalg.vector_norm(qry, dim=1, keepdim=True), min=eps)
    gn = gal / torch.clamp(torch.linalg.vector_norm(gal, dim=1, keepdim=True), min=eps)
    with full_f32_matmul():
        S = torch.clamp(qn @ gn.T / tau_eff, -20.0, 20.0)
    L_q2g, _ = _masked_one_side_ce(S, y, qry_valid, gal_valid)
    L_g2q, _ = _masked_one_side_ce(S.T, y.T, gal_valid, qry_valid)
    symmetric = 0.5 * (L_q2g + L_g2q)
    pair_count = (y * qry_valid[:, None] * gal_valid[None, :]).sum()
    has_pairs = (pair_count > 0).float()
    keep = torch.isfinite(symmetric) & (symmetric >= 0)
    loss = torch.where(keep, symmetric, torch.zeros_like(symmetric)) * has_pairs
    return loss, has_pairs


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                         label_smoothing: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label-smoothed CE over valid samples; returns (loss, valid_count).
    Out-of-range labels are invalid."""
    logits = logits.float()
    num_classes = logits.shape[1]
    in_range = (labels >= 0) & (labels < num_classes)
    valid = valid.float() * in_range.float()
    safe = torch.clamp(labels, 0, num_classes - 1).long()
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (safe[:, None] == classes[None, :]).float()
    target = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    ce_per_row = -(target * torch.log_softmax(logits, dim=1)).sum(dim=1)
    n_valid = valid.sum()
    loss = (ce_per_row * valid).sum() / torch.clamp(n_valid, min=1.0)
    return loss, n_valid


def _same_id(labels: torch.Tensor) -> torch.Tensor:
    labels = labels.long()
    return (labels[:, None] == labels[None, :]).float()


def _finite_or_zero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def multimodal_sdm_loss(modality_features: torch.Tensor, modality_masks: torch.Tensor,
                        labels: torch.Tensor, tau: Scalar, vis_slot: int = 0) -> torch.Tensor:
    """Mean SDM loss over the non-vis modalities against the vis anchor.
    modality_features [M, B, D], modality_masks [M, B].  A modality with no
    valid positive pair is skipped; a loss zeroed by ``sdm_loss``'s guard
    keeps its gate and counts in the mean."""
    y_full = _same_id(labels)
    vis_feat, vis_mask = modality_features[vis_slot], modality_masks[vis_slot]
    losses, gates = [], []
    for m in range(modality_features.shape[0]):
        if m == vis_slot:
            continue
        loss_m, has_pairs = sdm_loss(modality_features[m], vis_feat, y_full,
                                     modality_masks[m], vis_mask, tau)
        losses.append(loss_m)
        gates.append(has_pairs)
    losses, gates = torch.stack(losses), torch.stack(gates)
    return _finite_or_zero((losses * gates).sum() / torch.clamp(gates.sum(), min=1.0))


def multimodal_sdm_loss_batched(modality_features: torch.Tensor, modality_masks: torch.Tensor,
                                labels: torch.Tensor, tau: Scalar,
                                vis_slot: int = 0) -> torch.Tensor:
    """:func:`multimodal_sdm_loss` as one vmapped pass over the stacked
    non-vis modalities (batched [M-1, B, B] similarities and masked
    softmaxes); the same math."""
    y_full = _same_id(labels)
    vis_feat, vis_mask = modality_features[vis_slot], modality_masks[vis_slot]

    def others(t):  # the non-vis slots, by slicing (no index tensor)
        return torch.cat([t[:vis_slot], t[vis_slot + 1:]])

    losses, gates = torch.vmap(
        lambda q, qm: sdm_loss(q, vis_feat, y_full, qm, vis_mask, tau)
    )(others(modality_features), others(modality_masks))
    return _finite_or_zero((losses * gates).sum() / torch.clamp(gates.sum(), min=1.0))
