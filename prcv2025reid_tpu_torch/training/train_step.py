"""The training step (counterpart of the JAX package's
``training/train_step.py::make_train_step``).

Forward + loss, gradients, the poisoned-step skip, gradient sanitising, the
adaptive clip, the AdamW update and the in-graph metrics, all as device
computation: nothing in the step reads a device value on the host (no
``.item()``, no branch on a tensor), so the host only enqueues work, as
the JAX step is one jitted program.  A skipped step is a masked update
(``torch.where`` per tensor): parameters, optimizer state and BN statistics
keep their old values.

The parameters and BN statistics live in the model and are updated in
place (the JAX Trainer donates its state the same way); the rest of the
state is a :class:`TrainState`.  Randomness (drop-path, dropout, modality
dropout) comes from one ``torch.Generator`` per purpose on the model's
device, seeded from (state seed, step) as the JAX step folds its key with
the step: the same state and batch give the same step.

Data parallel (``make_train_step(..., mesh=)`` with a mesh of N processes):
each process feeds its contiguous slice of the global batch, and the step
is the one-process step on the global batch, as JAX's GSPMD step is.  The
model's batch-coupled parts (BNNeck's statistics, the fusion's all-masked
rescue, the modality-dropout guard, every random mask) read the global
batch through ``parallel/collectives.py``; the loss and the metrics are
computed on the gathered outputs, the same on every process; the
gradients are summed over the processes, so every process applies the same
update and the parameters stay bit-identical.

Tensor parallel (a 2-D mesh, the model sharded by
``parallel/tp.py::shard_state``): the data axis is as above, over the data
group; the blocks all-reduce over the model group themselves; the replicated
leaves whose gradients are partial sums (``tp.partial_grads``) are summed
over the model group once; the global norm counts each sharded leaf's shards
(their sums of squares summed over the model group) and each replicated leaf
once, so the poisoned-step skip, the sanitising and the clip decide the same
on every process; the AdamW update is elementwise, so it runs on each shard.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel, compute_loss
from prcv2025reid_tpu_torch.ops.losses import Scalar
from prcv2025reid_tpu_torch.parallel import tp
from prcv2025reid_tpu_torch.parallel.collectives import (
    active,
    all_reduce_grads,
    data_parallel,
    global_rows,
    model_all_reduce,
)
from prcv2025reid_tpu_torch.parallel.mesh import Mesh, model_spanning, spanning
from prcv2025reid_tpu_torch.training.param_groups import OptState, build_optimizer

# the per-step metric ring's channels (one row per step, fetched by the host
# once per epoch)
RING_CHANNELS = (
    "total_loss",
    "ce_loss",
    "sdm_loss",
    "pair_coverage",
    "bn_feat_norm",
    "bn_feat_norm_s0",
)
RNG_PURPOSES = ("dropout", "droppath", "moddrop")
# the batch dim of each output of the training forward, and the batch keys
# the loss and the metrics read: gathered to the global batch under a mesh
OUTPUT_BATCH_DIM = {"features": 0, "raw_modality_features": 1, "modality_features": 1,
                    "feature_masks": 1, "effective_masks": 1, "bn_features": 0, "logits": 0}
METRIC_BATCH_KEYS = ("labels", "pids", "image_mask", "text_mask")


@dataclass
class TrainState:
    """What the step carries besides the model's parameters and BN
    statistics.  ``step`` counts calls on the host (a skipped step advances
    it too, as JAX's), so the ring row and the generators' seeds need no
    device read; every tensor lives on the model's device."""
    step: int
    seed: int
    opt_state: OptState
    grad_norm_hist: torch.Tensor  # [adaptive_clip_window] ring of clean-step norms
    grad_norm_count: torch.Tensor  # int32, clean steps so far
    skipped_total: torch.Tensor  # int32
    metric_ring: torch.Tensor  # [ring_size, len(RING_CHANNELS)]

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(model: MultiModalReIDModel, config: TrainingConfig,
                     steps_per_epoch: int, seed: int = 0) -> TrainState:
    """Freeze by group, then the optimizer state of the trainable
    parameters and zeroed monitors; the metric ring has one row per step
    of an epoch."""
    opt, trainable = build_optimizer(config, model, steps_per_epoch)
    dev = model.null_tokens.device
    return TrainState(
        step=0, seed=seed,
        opt_state=opt.init([p for _, p in trainable]),
        grad_norm_hist=torch.zeros(max(1, config.adaptive_clip_window), device=dev),
        grad_norm_count=torch.zeros((), dtype=torch.int32, device=dev),
        skipped_total=torch.zeros((), dtype=torch.int32, device=dev),
        metric_ring=torch.zeros(max(1, steps_per_epoch), len(RING_CHANNELS), device=dev),
    )


def step_generators(seed: int, step: int, device: torch.device) -> Dict[str, torch.Generator]:
    """One generator per purpose, seeded from (seed, step, purpose)."""
    gens = {}
    for i, purpose in enumerate(RNG_PURPOSES):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, step, i]).generate_state(1)[0]))
        gens[purpose] = g
    return gens


def batch_pair_coverage(pids: torch.Tensor, image_mask: torch.Tensor,
                        text_mask: torch.Tensor) -> torch.Tensor:
    """Fraction of the batch's distinct identities with both a valid vis and
    a valid non-vis instance.  Each sample weighs 1 / count(its pid), so
    every identity counts once; rows with no valid modality (padding) count
    on neither side."""
    image_mask, text_mask = image_mask.float(), text_mask.float()
    valid = ((image_mask.sum(dim=1) + text_mask) > 0).float()
    eq = (pids[:, None] == pids[None, :]).float() * valid[None, :] * valid[:, None]
    cnt = eq.sum(dim=1)
    has_vis = (image_mask[:, 0] > 0).float()
    has_nonvis = ((image_mask[:, 1:].sum(dim=1) > 0) | (text_mask > 0)).float()
    covered = ((eq @ has_vis) > 0) & ((eq @ has_nonvis) > 0)
    inv = valid / torch.clamp(cnt, min=1.0)
    return (covered.float() * inv).sum() / torch.clamp(inv.sum(), min=1e-9)


def sanitize_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Non-finite gradient entries become 0."""
    return [torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for g in grads]


def global_norm(tensors: Sequence[torch.Tensor], sharded: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm).  With
    ``sharded`` (a 0/1 float per tensor: this process holds a shard of it),
    under ``mesh``'s model axis: the shards' sums of squares summed over the
    model group, each replicated tensor counted once."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    if sharded is None:
        return torch.linalg.vector_norm(norms)
    sq = norms.float().square()
    shard_sq = model_all_reduce((sq * sharded).sum(), mesh)
    return torch.sqrt((sq * (1.0 - sharded)).sum() + shard_sq)


def loss_and_grads(model: MultiModalReIDModel, config: TrainingConfig,
                   params: Sequence[torch.Tensor], batch: Mapping[str, torch.Tensor],
                   sdm_weight: Scalar, sdm_tau: Scalar, enable_modality_dropout: bool = False,
                   generators: Optional[Mapping[str, torch.Generator]] = None):
    """The step's forward, loss and gradients: (losses, outputs,
    new_batch_stats, grads), one gradient per tensor of ``params`` (zeros
    where it does not reach the loss).  ``batch`` holds tensors on the
    model's device.  Under an active data-parallel mesh the outputs and the
    labels are the global batch's (gathered, differentiably) and each
    gradient is this process's share of the global one."""
    with torch.enable_grad():
        outputs, new_stats = model(batch["images"], batch["image_mask"], batch["text_tokens"],
                                   batch["text_mask"], train=True,
                                   enable_modality_dropout=enable_modality_dropout,
                                   generators=generators)
        labels = batch["labels"]
        if active() is not None:
            outputs = {k: global_rows(v, OUTPUT_BATCH_DIM[k]) for k, v in outputs.items()}
            labels = global_rows(labels)
        losses = compute_loss(outputs, labels, ce_weight=config.ce_weight,
                              sdm_weight=sdm_weight, sdm_tau=sdm_tau,
                              label_smoothing=config.label_smoothing, sdm_impl=config.sdm_impl)
        grads = torch.autograd.grad(losses["total_loss"], list(params), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    return losses, outputs, new_stats, grads


def _keep_old(ok: torch.Tensor, new: Sequence[torch.Tensor],
              old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.where(ok, n, o) for n, o in zip(new, old)]


def make_train_step(model: MultiModalReIDModel, config: TrainingConfig,
                    steps_per_epoch: int, mesh: Optional[Mesh] = None) -> Callable:
    """Build ``train_step(state, batch, sdm_weight, sdm_tau,
    enable_modality_dropout=False) -> (state, metrics)`` on the model's
    device.  ``batch``: ``images`` uint8 [B, Mv, H, W, 3] (or normalized
    float), ``image_mask`` [B, Mv], ``text_tokens`` [B, S] int, ``text_mask``
    [B], ``labels`` [B] and optionally ``pids`` [B].  ``metrics`` holds the
    JAX step's eleven values as device tensors.  With a ``mesh`` of N
    processes, ``batch`` is this data index's slice (every one of one size)
    of the global batch and the step is the global batch's (see the module
    docstring): the same metrics, update and state on every process; a
    mesh with a model axis needs the model sharded first
    (``parallel/tp.py::shard_state``).  ``train_step.grads(state, batch,
    sdm_weight, sdm_tau, enable_modality_dropout)`` runs the step's forward
    and backward alone: (batch, losses, outputs, BN statistics, gradients)."""
    if config.sdm_semantic_dim != config.fusion_dim:
        raise ValueError(f"sdm_semantic_dim={config.sdm_semantic_dim} must equal "
                         f"fusion_dim={config.fusion_dim}: the SDM features feed the fusion")
    opt, trainable = build_optimizer(config, model, steps_per_epoch)
    params = [p for _, p in trainable]
    bn = model.bn_neck.bn
    dev = model.null_tokens.device
    dp = spanning(mesh)
    mp = model_spanning(mesh)
    if mp is not None and not tp.is_sharded(model):
        raise ValueError("a mesh with a model axis needs the model sharded first "
                         "(parallel/tp.py::shard_state)")
    names = [n for n, _ in trainable]
    partial = [i for i, f in enumerate(tp.partial_grads(model, names)) if f]
    sharded = (torch.tensor(tp.sharded_leaves(model, names), dtype=torch.float32, device=dev)
               if mp is not None else None)

    def step_grads(state: TrainState, batch: Mapping[str, object], sdm_weight: Scalar,
                   sdm_tau: Scalar, enable_modality_dropout: bool = False):
        """The step's forward, loss and gradients, summed over the mesh:
        (batch on the device, or the global batch's metric keys under a data
        axis; losses; outputs; new BN statistics; one gradient per trainable
        parameter, of this process's shard under a model axis)."""
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with data_parallel(dp):
            losses, outputs, new_stats, grads = loss_and_grads(
                model, config, params, b, sdm_weight, sdm_tau, enable_modality_dropout,
                step_generators(state.seed, state.step, dev))
            if dp is not None:  # the global batch's, for the metrics
                b = {k: global_rows(b[k]) for k in METRIC_BATCH_KEYS if k in b}
        grads = all_reduce_grads(grads, dp)
        if partial:  # the replicated leaves whose gradients are partial sums
            for i, g in zip(partial, all_reduce_grads([grads[i] for i in partial], mp,
                                                      axis="model")):
                grads[i] = g
        return b, losses, outputs, new_stats, grads

    def train_step(state: TrainState, batch: Mapping[str, object], sdm_weight: Scalar,
                   sdm_tau: Scalar, enable_modality_dropout: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        b, losses, outputs, new_stats, grads = step_grads(state, batch, sdm_weight, sdm_tau,
                                                          enable_modality_dropout)
        with torch.no_grad():
            return _apply(state, b, outputs, new_stats, losses, grads)

    def _apply(state, b, outputs, new_stats, losses, grads):
        # poisoned-step skip: a non-finite loss, or a non-finite gradient
        # anywhere before sanitising, skips the whole update.  The norm runs
        # over the trainable leaves only; JAX's gradient tree holds zeros for
        # the frozen ones, so it is the same number
        ok = torch.isfinite(losses["total_loss"]) & torch.isfinite(
            global_norm(grads, sharded, mp))
        grads = sanitize_grads(grads)
        # adaptive clip; a skipped step leaves the norm history alone
        gnorm = global_norm(grads, sharded, mp)
        hist, count = state.grad_norm_hist, state.grad_norm_count
        window = hist.shape[0]
        slot = torch.arange(window, device=dev) == count % window
        hist = torch.where(ok & slot, gnorm, hist)
        count = count + ok.to(torch.int32)
        if config.adaptive_gradient_clip:
            pct = torch.quantile(hist, config.adaptive_clip_pct, interpolation="linear")
            adaptive = torch.clamp(pct * config.adaptive_clip_margin, config.adaptive_clip_min,
                                   config.adaptive_clip_max)
            # until the window is full the clip is 1.0
            max_norm = torch.where(count >= window, adaptive, torch.ones_like(adaptive))
        else:
            max_norm = torch.full((), config.max_grad_norm, device=dev)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
        grads = torch._foreach_mul(grads, scale)

        updates, new_opt = opt.update(grads, state.opt_state, params)
        # a skipped step moves nothing: parameters, optimizer state, BN statistics
        for p, n in zip(params, _keep_old(ok, torch._foreach_add(params, updates), params)):
            p.copy_(n)
        old = state.opt_state
        opt_state = old.replace(
            count=torch.where(ok, new_opt.count, old.count),
            mu=_keep_old(ok, new_opt.mu, old.mu), nu=_keep_old(ok, new_opt.nu, old.nu),
            mini_step=torch.where(ok, new_opt.mini_step, old.mini_step),
            acc=_keep_old(ok, new_opt.acc, old.acc))
        bn.mean.copy_(torch.where(ok, new_stats["bn_neck.bn.mean"], bn.mean))
        bn.var.copy_(torch.where(ok, new_stats["bn_neck.bn.var"], bn.var))

        # the monitor row, written on skipped steps too with NaN losses
        coverage = batch_pair_coverage(b.get("pids", b["labels"]), b["image_mask"],
                                       b["text_mask"])
        poison = torch.where(ok, 0.0, float("nan"))
        bn_norms = torch.linalg.vector_norm(outputs["bn_features"].float(), dim=1)
        row = torch.stack([losses["total_loss"] + poison, losses["ce_loss"] + poison,
                           losses["sdm_loss"] + poison, coverage, bn_norms.mean(),
                           bn_norms[0]]).float()
        ring = state.metric_ring.clone()
        ring[state.step % ring.shape[0]] = row

        labels = b["labels"]
        eff = outputs["effective_masks"]
        valid = (eff.sum(dim=0) > 0) & (labels >= 0)
        preds = outputs["logits"].argmax(dim=1)
        top1 = ((preds == labels) & valid).sum().float() / torch.clamp(valid.sum(), min=1)
        metrics = {
            "total_loss": losses["total_loss"],
            "ce_loss": losses["ce_loss"],
            "sdm_loss": losses["sdm_loss"],
            "ce_valid_cnt": losses["ce_valid_cnt"],
            "grad_norm": gnorm,
            "clip_threshold": max_norm,
            "train_top1": top1,
            "feat_norm": torch.linalg.vector_norm(outputs["features"].float(), dim=1).mean(),
            "bn_feat_norm": bn_norms.mean(),
            "bn_feat_norm_s0": bn_norms[0],
            "skipped": (~ok).float(),
        }
        new_state = state.replace(
            step=state.step + 1, opt_state=opt_state, grad_norm_hist=hist,
            grad_norm_count=count, skipped_total=state.skipped_total + (~ok).to(torch.int32),
            metric_ring=ring)
        return new_state, {k: v.detach() for k, v in metrics.items()}

    train_step.grads = step_grads
    return train_step


def make_embed_step(model: MultiModalReIDModel) -> Callable[..., torch.Tensor]:
    """Eval-time embedding through the full forward (every modality encoded
    densely, the masks carrying validity): ``embed(images, image_mask,
    text_tokens, text_mask)`` -> L2-normalised f32 ``bn_features`` [B, D] on
    the model's device (the counterpart of the JAX package's
    ``make_embed_step``; the retrieval feature is ``bn_features``).  The
    inputs are tensors or numpy arrays; the module holds its own weights, so
    the step takes no ``variables`` argument as JAX's does."""
    device = model.null_tokens.device

    @torch.inference_mode()
    def embed(images, image_mask, text_tokens, text_mask) -> torch.Tensor:
        outputs, _ = model(torch.as_tensor(images, device=device),
                           torch.as_tensor(image_mask, device=device),
                           torch.as_tensor(text_tokens, device=device),
                           torch.as_tensor(text_mask, device=device), train=False)
        feats = outputs["bn_features"].float()
        return feats / torch.clamp(torch.linalg.vector_norm(feats, dim=1, keepdim=True), min=1e-12)

    return embed
