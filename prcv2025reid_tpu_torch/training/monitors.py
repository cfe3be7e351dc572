"""Host-side training health monitors (own copy of the JAX package's
``training/monitors.py``; numpy only, no torch).

Small stateful objects fed with already-fetched scalars: the trainer reads
the train step's metric ring once an epoch and feeds each row here, so the
loop never synchronises with the device to monitor.

- ``SpikeDetector``: sliding median + MAD loss-spike detection (median +
  6 * 1.4826 * MAD, a 15% relative margin, armed after 20 samples) and the
  epoch's ``stability_score``.
- ``PairCoverageMonitor``: the moving average of the share of a batch's
  identities with both a vis and a non-vis instance (window 100, target
  >= 0.85).
- ``FeatureNormMonitor``: the BN-feature norm health check.
- ``CEDiagnostics``: CE against the ln(num_classes) random baseline.
- ``batch_composition``, ``BatchCountReport`` and ``MetricsHistory`` (the
  per-epoch CSV histories, with an optional TensorBoard export).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List

import numpy as np


class SpikeDetector:
    def __init__(self, history: int = 200, window: int = 100, min_samples: int = 20):
        self.history: Deque[float] = deque(maxlen=history)
        self.window = window
        self.min_samples = min_samples
        self.spikes = 0
        self.batches = 0

    def update(self, loss: float) -> bool:
        """Returns True when this loss is a spike."""
        is_spike = False
        if not math.isfinite(loss):
            self.spikes += 1
            self.batches += 1
            return True
        self.history.append(loss)
        if len(self.history) >= self.min_samples:
            hist = np.asarray(list(self.history)[-self.window :])
            median = float(np.median(hist))
            mad = max(float(np.median(np.abs(hist - median))), 0.05)
            threshold = max(median + 6.0 * 1.4826 * mad, median * 1.15)
            if loss > threshold:
                self.spikes += 1
                is_spike = True
        self.batches += 1
        return is_spike

    @property
    def stability_score(self) -> float:
        return max(0.0, 1.0 - self.spikes / max(1, self.batches))

    def state_dict(self) -> Dict:
        return {
            "history": list(self.history),
            "spikes": self.spikes,
            "batches": self.batches,
        }

    def load_state_dict(self, s: Dict):
        self.history = deque(s["history"], maxlen=self.history.maxlen)
        self.spikes = s["spikes"]
        self.batches = s["batches"]


class PairCoverageMonitor:
    """Fraction of batch identities with both a valid vis and a valid
    non-vis instance, smoothed over a step window."""

    def __init__(self, window: int = 100, target: float = 0.85):
        self.values: Deque[float] = deque(maxlen=window)
        self.target = target

    def update(self, pids: np.ndarray, image_mask: np.ndarray, text_mask: np.ndarray) -> float:
        """pids [B]; image_mask [B, Mv] (slot 0 = vis); text_mask [B].

        Rows with no valid modality at all are excluded — they are multi-host
        padding (pad_batch_to fills zero masks) whose phantom identity would
        deflate the ratio; mirrors train_step.batch_pair_coverage exactly."""
        valid = (image_mask.sum(axis=1) + text_mask) > 0
        pids = pids[valid]
        has_vis = image_mask[valid, 0] > 0
        has_nonvis = (image_mask[valid, 1:].sum(axis=1) > 0) | (text_mask[valid] > 0)
        cov_ids = 0
        ids = np.unique(pids)
        for pid in ids:
            sel = pids == pid
            if has_vis[sel].any() and has_nonvis[sel].any():
                cov_ids += 1
        cov = cov_ids / max(1, len(ids))
        self.values.append(cov)
        return cov

    def update_value(self, cov: float) -> float:
        """Feed a pre-computed per-batch coverage (the in-graph metric ring
        path — train_step.batch_pair_coverage computes the same statistic on
        device every step)."""
        self.values.append(float(cov))
        return float(cov)

    @property
    def moving_average(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    @property
    def healthy(self) -> bool:
        return self.moving_average >= self.target


class FeatureNormMonitor:
    """BN-feature norm health check with L2-aware thresholds
    (reference: train.py:1160-1183).

    The reference sniffs whether BNNeck output is L2-normalized by checking
    SAMPLE 0's norm against [0.8, 1.2]; if so it warns when the batch-MEAN
    norm exceeds 2.0, otherwise when it exceeds 15.0 — both only after
    epoch 5.  (With the x8.0 L2 rescale of models/model.py:219 the norm sits
    near 8, taking the non-normalized branch.)  The train step exports both
    statistics in-graph (``bn_feat_norm_s0`` / ``bn_feat_norm``).
    """

    def __init__(
        self,
        l2_band=(0.8, 1.2),
        l2_threshold: float = 2.0,
        raw_threshold: float = 15.0,
        min_epoch: int = 5,
    ):
        self.l2_band = l2_band
        self.l2_threshold = l2_threshold
        self.raw_threshold = raw_threshold
        self.min_epoch = min_epoch
        self.warnings = 0

    def check(self, sample_norm: float, mean_norm: float, epoch: int):
        if epoch <= self.min_epoch or not math.isfinite(mean_norm):
            return None
        using_l2 = self.l2_band[0] <= sample_norm <= self.l2_band[1]
        if using_l2 and mean_norm > self.l2_threshold:
            self.warnings += 1
            return (
                f"BNNeck feature norm abnormal (L2-normalized): {mean_norm:.2f} "
                f"— should be ~1.0 (reference train.py:1172-1175)"
            )
        if not using_l2 and mean_norm > self.raw_threshold:
            self.warnings += 1
            return (
                f"BNNeck feature norm too large (non-normalized): {mean_norm:.2f} "
                f"— regularization not engaging (reference train.py:1176-1179)"
            )
        return None


class CEDiagnostics:
    """Flags CE stuck at the ln(num_classes) random baseline."""

    def __init__(self, num_classes: int, tolerance: float = 0.05):
        self.random_baseline = math.log(max(2, num_classes))
        self.tolerance = tolerance

    def is_random(self, ce_loss: float) -> bool:
        return abs(ce_loss - self.random_baseline) / self.random_baseline < self.tolerance


def batch_composition(
    pids: np.ndarray, image_mask: np.ndarray, text_mask: np.ndarray
) -> Dict:
    """The reference's early-epoch batch-composition debug panel
    (train.py:783-830): distinct-ID count, mean instances/ID, and per-ID
    vis/non-vis pairing split.  Computed host-side from the small batch
    leaves; the trainer logs it for the first batches of the first epochs."""
    pids = np.asarray(pids)
    image_mask = np.asarray(image_mask)
    text_mask = np.asarray(text_mask)
    valid = pids >= 0  # multi-host padding rows carry pid -1
    pids, image_mask, text_mask = pids[valid], image_mask[valid], text_mask[valid]
    ids, counts = np.unique(pids, return_counts=True)
    has_vis = image_mask[:, 0] > 0
    has_nonvis = (image_mask[:, 1:].sum(axis=1) > 0) | (text_mask > 0)
    both = vis_only = nonvis_only = 0
    for pid in ids:
        sel = pids == pid
        v, n = bool(has_vis[sel].any()), bool(has_nonvis[sel].any())
        both += v and n
        vis_only += v and not n
        nonvis_only += (not v) and n
    return {
        "num_ids": int(len(ids)),
        "avg_instances_per_id": float(counts.mean()) if len(ids) else 0.0,
        "both": both,
        "vis_only": vis_only,
        "nonvis_only": nonvis_only,
    }


class BatchCountReport:
    """End-of-training sampler-stability statistics (train.py:1766-1783):
    actual batches/epoch vs the sampler's initial estimate, plus the
    coefficient of variation across epochs."""

    def __init__(self, estimated_batches: int):
        self.estimated = max(1, int(estimated_batches))
        self.per_epoch: List[int] = []

    def record_epoch(self, n_batches: int):
        self.per_epoch.append(int(n_batches))

    def summary(self) -> Dict:
        if not self.per_epoch:
            return {}
        arr = np.asarray(self.per_epoch, np.float64)
        avg = float(arr.mean())
        cv = float(arr.std() / avg) if avg > 0 else 0.0
        return {
            "estimated_batches": self.estimated,
            "avg_batches": avg,
            "min_batches": int(arr.min()),
            "max_batches": int(arr.max()),
            "estimate_accuracy": avg / self.estimated,
            "batch_cv": cv,
            "stable": cv < 0.1,
        }


class MetricsHistory:
    """Per-epoch metric accumulation -> CSV (reference: train.py:1751-1756)
    with optional TensorBoard scalar export (the reference has neither
    TensorBoard nor W&B, SURVEY.md §5.5)."""

    def __init__(self, tensorboard_dir: str | None = None, tag_prefix: str = ""):
        self.rows: List[Dict] = []
        self.tag_prefix = tag_prefix
        self._tb = None
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:
                import logging

                logging.getLogger(__name__).warning(
                    "TensorBoard export disabled (%s: %s) — CSV histories still written",
                    type(e).__name__,
                    e,
                )
                self._tb = None

    def append(self, row: Dict):
        self.rows.append(dict(row))
        if self._tb is not None:
            step = int(row.get("epoch", len(self.rows)))
            for k, v in row.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    self._tb.add_scalar(f"{self.tag_prefix}{k}", float(v), step)
            self._tb.flush()

    def to_csv(self, path: str):
        if not self.rows:
            return
        keys = sorted({k for r in self.rows for k in r})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self.rows:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")

    def load_csv(self, path: str):
        """Reload rows previously written by to_csv — a resumed run must
        append to the prior epochs' history, not erase it (to_csv rewrites
        the whole file)."""
        import csv
        import os

        if not os.path.exists(path):
            return
        with open(path) as f:
            for raw in csv.DictReader(f):
                row = {}
                for k, v in raw.items():
                    if v == "" or v is None:
                        continue
                    try:
                        row[k] = int(v)
                    except ValueError:
                        try:
                            row[k] = float(v)
                        except ValueError:
                            row[k] = v
                if row:
                    self.rows.append(row)
