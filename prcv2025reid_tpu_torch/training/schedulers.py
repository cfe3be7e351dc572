"""SDM weight/temperature schedulers and the epoch-level LR multipliers
(counterpart of the JAX package's ``training/schedulers.py``).

The scheduler classes are host-side Python (they react to per-epoch
metrics) and feed plain scalars into the train step.  The LR multipliers
come twice: ``warmup_cosine_multiplier`` on a host int, and
``lr_multiplier`` on a device tensor of epochs (the optimizer reads its
update count on the device, so no host synchronisation is needed), in f32
as the JAX package's traced versions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig


@dataclass
class SDMWeightScheduler:
    """0 during warmup epochs, then stepwise schedule [0.1, 0.3, 0.5] -> final.

    Reference: models/sdm_scheduler.py:10-107.
    """

    warmup_epochs: int = 1
    schedule: Tuple[float, ...] = (0.1, 0.3, 0.5)
    initial_weight: float = 0.1
    final_weight: float = 0.5
    max_weight: float = 0.5
    current_weight: float = 0.0
    # single-authority escalation flags: the reference mutates current_weight
    # from three places and lets the next epoch's stepwise recompute clobber
    # them (models/sdm_scheduler.py:62-107 + train.py:1614-1628); here
    # get_weight() is the one authority and increase/decrease set flags it
    # honors instead of racing it.
    boosted: bool = False
    suppressed: bool = False

    @classmethod
    def from_config(cls, c: TrainingConfig) -> "SDMWeightScheduler":
        return cls(
            warmup_epochs=c.sdm_weight_warmup_epochs,
            schedule=tuple(c.sdm_weight_schedule),
            initial_weight=c.sdm_weight_initial,
            final_weight=c.sdm_weight_final,
            max_weight=c.sdm_weight_max,
            # the live weight before the first epoch-driven update
            # (reference: models/model.py:294 seeds it from config)
            current_weight=c.contrastive_weight,
        )

    def get_weight(self, epoch: int) -> float:
        """epoch is 1-based (reference convention)."""
        if epoch <= self.warmup_epochs:
            weight = 0.0
        else:
            # past the stepwise schedule the FINAL weight applies — the
            # reference's own `else: final_weight` arm is dead (its idx is
            # min-clamped, sdm_scheduler.py:56-60) making sdm_weight_final a
            # dead knob there; this implements the documented intent
            # ("0.1 -> 0.3 -> 0.5 -> final", identical behavior at the
            # defaults where final == schedule[-1])
            idx = epoch - self.warmup_epochs - 1
            weight = self.schedule[idx] if idx < len(self.schedule) else self.final_weight
            if self.boosted:
                weight = self.max_weight
            elif self.suppressed:
                weight = min(weight, self.initial_weight)
        self.current_weight = weight
        return weight

    def can_increase_weight(
        self, epoch: int, train_metrics: Dict, val_metrics: Optional[Dict] = None
    ) -> bool:
        if epoch < 10:
            return False
        if train_metrics.get("stability_score", 0.0) < 0.8:
            return False
        if val_metrics and val_metrics.get("map_avg2", 0.0) < 0.1:
            return False
        return True

    def increase_to_max(self) -> bool:
        self.suppressed = False
        if self.current_weight < self.max_weight:
            self.boosted = True
            self.current_weight = self.max_weight
            return True
        return False

    def decrease_weight(self, reason: str = "") -> bool:
        self.boosted = False
        self.suppressed = True
        if self.current_weight > self.initial_weight:
            self.current_weight = self.initial_weight
            return True
        return False

    def state_dict(self) -> Dict:
        return {
            "current_weight": self.current_weight,
            "boosted": self.boosted,
            "suppressed": self.suppressed,
        }

    def load_state_dict(self, s: Dict):
        self.current_weight = s["current_weight"]
        self.boosted = s.get("boosted", False)
        self.suppressed = s.get("suppressed", False)


@dataclass
class SDMTemperatureScheduler:
    """init 0.18 -> final 0.16 after warmup; fallback 0.20 on instability.

    Reference: models/sdm_scheduler.py:110-196.
    """

    init_temp: float = 0.18
    final_temp: float = 0.16
    fallback_temp: float = 0.20
    warmup_epochs: int = 3
    current_temp: float = 0.18
    use_fallback: bool = False

    @classmethod
    def from_config(cls, c: TrainingConfig) -> "SDMTemperatureScheduler":
        return cls(
            init_temp=c.sdm_init_temperature,
            final_temp=c.sdm_final_temperature,
            fallback_temp=c.sdm_fallback_temperature,
            warmup_epochs=c.sdm_temp_warmup_epochs,
            # the live tau before the scheduler's first epoch-driven update:
            # the reference's loss uses config.sdm_temperature directly
            # (models/model.py:288,616) until the scheduler takes over
            current_temp=c.sdm_temperature,
        )

    def get_temperature(self, epoch: int) -> float:
        if self.use_fallback:
            return self.fallback_temp
        temp = self.init_temp if epoch <= self.warmup_epochs else self.final_temp
        self.current_temp = temp
        return temp

    def check_stability(self, train_metrics: Dict) -> bool:
        sdm_loss = train_metrics.get("sdm_loss", 0.0)
        if sdm_loss > 5.0 or sdm_loss < 0:
            self.use_fallback = True
            return True
        if train_metrics.get("stability_score", 0.0) < 0.5:
            self.use_fallback = True
            return True
        return False

    def reset_to_normal(self) -> bool:
        if self.use_fallback:
            self.use_fallback = False
            return True
        return False

    def state_dict(self) -> Dict:
        return {"current_temp": self.current_temp, "use_fallback": self.use_fallback}

    def load_state_dict(self, s: Dict):
        self.current_temp = s["current_temp"]
        self.use_fallback = s["use_fallback"]


@dataclass
class SDMScheduler:
    """Combined weight + temperature scheduler (models/sdm_scheduler.py:199-269)."""

    weight_scheduler: SDMWeightScheduler = field(default_factory=SDMWeightScheduler)
    temp_scheduler: SDMTemperatureScheduler = field(
        default_factory=SDMTemperatureScheduler
    )

    @classmethod
    def from_config(cls, c: TrainingConfig) -> "SDMScheduler":
        return cls(
            SDMWeightScheduler.from_config(c), SDMTemperatureScheduler.from_config(c)
        )

    def get_weight(self, epoch: int) -> float:
        return self.weight_scheduler.get_weight(epoch)

    def get_parameters(
        self, epoch: int, train_metrics: Dict, val_metrics: Optional[Dict] = None
    ) -> Tuple[float, float]:
        """THE single authority for the live (weight, temperature) pair —
        callers must not re-derive either value (the reference computes the
        weight twice per epoch and lets the second read clobber the first,
        train.py:1614-1628; rationalized here per SURVEY.md §2.7 intent).

        Without metrics (first epoch / resume edge) the current values hold
        (reference: models/sdm_scheduler.py get_parameters no-ops, and
        train.py:841 falls back to config.contrastive_weight — which seeds
        ``current_weight``)."""
        if not train_metrics or "stability_score" not in train_metrics:
            return (
                self.weight_scheduler.current_weight,
                self.temp_scheduler.current_temp,
            )
        self.temp_scheduler.check_stability(train_metrics)
        return (
            self.weight_scheduler.get_weight(epoch),
            self.temp_scheduler.get_temperature(epoch),
        )

    def can_increase_weight(self, epoch, train_metrics, val_metrics=None) -> bool:
        return self.weight_scheduler.can_increase_weight(epoch, train_metrics, val_metrics)

    def increase_weight(self) -> bool:
        return self.weight_scheduler.increase_to_max()

    def decrease_weight(self, reason: str = "") -> bool:
        return self.weight_scheduler.decrease_weight(reason)

    def reset_temperature(self) -> bool:
        return self.temp_scheduler.reset_to_normal()

    def state_dict(self) -> Dict:
        return {
            "weight": self.weight_scheduler.state_dict(),
            "temp": self.temp_scheduler.state_dict(),
        }

    def load_state_dict(self, s: Dict):
        self.weight_scheduler.load_state_dict(s["weight"])
        self.temp_scheduler.load_state_dict(s["temp"])


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau on eval mAP (reference: train.py:1504-1510 —
    mode='max', factor=0.5, patience=8, threshold=0.001 relative,
    min_lr = base_lr * 0.001).

    Host-side: ``step(map_avg2)`` returns the live LR *scale* in (0, 1];
    the trainer writes it into the optimizer's ``plateau_scale`` state leaf
    (training/param_groups.py::set_plateau_scale) between epochs.
    """

    factor: float = 0.5
    patience: int = 8
    threshold: float = 0.001  # relative, mode 'max' (torch default threshold_mode)
    min_scale: float = 0.001
    best: float = float("-inf")
    num_bad_epochs: int = 0
    scale: float = 1.0

    @classmethod
    def from_config(cls, c: TrainingConfig) -> "PlateauScheduler":
        return cls(
            factor=c.plateau_factor,
            patience=c.plateau_patience,
            threshold=c.plateau_threshold,
            min_scale=c.plateau_min_scale,
        )

    def step(self, metric: float) -> float:
        if metric > self.best * (1.0 + self.threshold) or self.best == float("-inf"):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale = max(self.min_scale, self.scale * self.factor)
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> Dict:
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "scale": self.scale,
        }

    def load_state_dict(self, s: Dict):
        self.best = s["best"]
        self.num_bad_epochs = s["num_bad_epochs"]
        self.scale = s["scale"]


def warmup_cosine_multiplier(
    epoch: int, num_epochs: int, warmup_epochs: int, floor: float = 0.01
) -> float:
    """Epoch-level LR multiplier: linear warmup from ``floor`` then cosine
    decay to ``floor`` (reference: train.py:1250-1262).  Applied uniformly to
    every param group so per-group LR ratios are preserved."""
    if epoch < warmup_epochs:
        return floor + (1.0 - floor) * (epoch + 1) / max(1, warmup_epochs)
    span = max(1, num_epochs - warmup_epochs)
    progress = min(1.0, (epoch - warmup_epochs) / span)
    return floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * progress))


def _warmup_ramp(epoch: torch.Tensor, warmup_epochs: int, floor: float) -> torch.Tensor:
    """The shared linear warmup ramp."""
    return floor + (1.0 - floor) * (epoch + 1.0) / max(1, warmup_epochs)


def _f32_epoch(epoch) -> torch.Tensor:
    return torch.as_tensor(epoch).to(torch.float32)


def warmup_cosine_multiplier_t(epoch, num_epochs: int, warmup_epochs: int,
                               floor: float = 0.01) -> torch.Tensor:
    """``warmup_cosine_multiplier`` on a tensor of epochs, in f32."""
    epoch = _f32_epoch(epoch)
    warm = _warmup_ramp(epoch, warmup_epochs, floor)
    span = max(1, num_epochs - warmup_epochs)
    progress = torch.clamp((epoch - warmup_epochs) / span, max=1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * progress))
    return torch.where(epoch < warmup_epochs, warm, cos)


def lr_multiplier(epoch, *, scheduler: str = "cosine", num_epochs: int = 60,
                  warmup_epochs: int = 5, floor: float = 0.01, step_every: int = 20,
                  step_gamma: float = 0.1,
                  milestones: Tuple[int, ...] = (30, 50)) -> torch.Tensor:
    """Epoch tensor -> LR multiplier for every scheduler: cosine
    (warmup + cosine), step (gamma every N epochs after warmup), multistep
    (gamma at milestones), plateau (warmup, then flat: the drops come from
    the host through ``PlateauScheduler`` and the optimizer's plateau
    scale)."""
    if scheduler == "cosine":
        return warmup_cosine_multiplier_t(epoch, num_epochs, warmup_epochs, floor)
    epoch = _f32_epoch(epoch)
    warm = _warmup_ramp(epoch, warmup_epochs, floor)
    if scheduler == "plateau":
        return torch.where(epoch < warmup_epochs, warm, torch.ones_like(epoch))
    if scheduler == "step":
        n_drops = torch.floor(torch.clamp(epoch - warmup_epochs, min=0.0) / max(1, step_every))
    elif scheduler == "multistep":
        n_drops = sum((epoch >= m).to(torch.float32) for m in milestones)
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    decayed = torch.pow(torch.full_like(epoch, step_gamma), n_drops)
    return torch.where(epoch < warmup_epochs, warm, torch.clamp(decayed, min=floor))
