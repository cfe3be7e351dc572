"""Layered learning rates, backbone freezing and the optimizer
(counterpart of the JAX package's ``training/param_groups.py``).

Each parameter gets a group label from its flax-style key (the port's
state-dict name with ``/`` for ``.``, see ``params.py``).  Under
``freeze_backbone`` only the LoRA experts, the classifier head and the
other modules (null tokens, fusion, SDM module, BN-neck) train.  Frozen
parameters get ``requires_grad_(False)``, the counterpart of the JAX step's
``stop_gradient``: no weight gradient of theirs is computed, and they hold
no optimizer state.

The optimizer is :class:`GroupAdamW`, optax's ``adamw`` per group (b1 0.9,
b2 0.999, eps 1e-8 outside the square root, decoupled decay lr * wd * p)
over lists of tensors, with what the JAX package chains around it: the
per-group schedules read the update count on the device, ``opt_nu_dtype``
stores the second moment narrowed (f32 arithmetic), ``optax.MultiSteps``
accumulation advances the count once per effective update, and the plateau
scale is a state value that the host writes.  ``update`` returns new
tensors and leaves its inputs as they were, so the train step can keep the
old state on a skipped step without a host branch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.training.schedulers import lr_multiplier

GROUPS = (
    "clip_backbone",
    "mer_loras",
    "tokenizers",
    "projections",
    "classification_head",
    "other_modules",
    "frozen",
)
B1, B2, EPS = 0.9, 0.999, 1e-8
NU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_key(name: str) -> str:
    """A state-dict name as its flax path: ``a.b.c`` -> ``a/b/c``."""
    return name.replace(".", "/")


def label_for_path(joined: str, freeze_backbone: bool, freeze_text_backbone: bool = False) -> str:
    """The LR group of a parameter's ``/``-joined flax path (without the
    ``params`` collection).  ``freeze_text_backbone`` freezes the text tower
    alone, not ``text_proj``."""
    if "lora_A" in joined or "lora_B" in joined:
        return "mer_loras"
    if "bn_neck/classifier" in joined:
        return "classification_head"
    if "null_tokens" in joined or joined.startswith(("bn_neck", "fusion", "sdm_module")):
        return "other_modules"
    if freeze_text_backbone and joined.startswith("encoder/text/"):
        return "frozen"
    if freeze_backbone:
        return "frozen"
    if "patch_embed_" in joined:
        return "tokenizers"
    if "vision/proj" in joined or "text_proj" in joined:
        return "projections"
    return "clip_backbone"  # shared trunks, the text tower, cls / pos embeds


def label_params(model: torch.nn.Module, config: TrainingConfig) -> Dict[str, str]:
    """{parameter name: group} under the config's two freeze flags."""
    return {name: label_for_path(param_key(name), config.freeze_backbone,
                                 config.freeze_text_backbone)
            for name, _ in model.named_parameters()}


def freeze(model: torch.nn.Module, config: TrainingConfig) -> List[Tuple[str, torch.nn.Parameter]]:
    """Set ``requires_grad`` by group (frozen: False) and return the
    trainable (name, parameter) pairs in the model's order."""
    labels = label_params(model, config)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
        if p.requires_grad:
            trainable.append((name, p))
    return trainable


def count_trainable(model: torch.nn.Module, freeze_backbone: bool,
                    freeze_text_backbone: bool = False) -> Dict[str, int]:
    """Parameter counts per group under the labelling the optimizer uses."""
    counts = {g: 0 for g in GROUPS}
    for name, p in model.named_parameters():
        counts[label_for_path(param_key(name), freeze_backbone, freeze_text_backbone)] += p.numel()
    return counts


def group_learning_rates(config: TrainingConfig) -> Dict[str, float]:
    return {
        "clip_backbone": config.base_learning_rate,
        "mer_loras": config.mer_learning_rate,
        "tokenizers": config.tokenizer_learning_rate,
        "projections": config.fusion_learning_rate,
        "classification_head": config.head_learning_rate,
        "other_modules": config.fusion_learning_rate,
        "frozen": 0.0,
    }


def group_schedules(config: TrainingConfig,
                    steps_per_epoch: int) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """Per-group schedules: update count (an int tensor) -> f32 LR tensor.
    Accumulation advances the count once per effective update, so the epoch
    is count // ceil(batches / accum).  classification_head is flat at its
    base LR from the 1-based epoch ``head_lr_warmup_epochs``."""
    base_lrs = group_learning_rates(config)
    updates_per_epoch = max(1, -(-steps_per_epoch // config.accum_steps))

    def make_schedule(base_lr: float, flat_after: Optional[int] = None):
        def schedule(count: torch.Tensor) -> torch.Tensor:
            epoch = torch.div(count, updates_per_epoch, rounding_mode="floor")
            lr = base_lr * lr_multiplier(
                epoch, scheduler=config.scheduler, num_epochs=config.num_epochs,
                warmup_epochs=config.warmup_epochs, floor=config.lr_floor_ratio,
                step_every=config.step_lr_every, step_gamma=config.step_lr_gamma,
                milestones=tuple(config.multistep_milestones))
            if flat_after is not None:
                lr = torch.where(epoch + 1 >= flat_after, torch.full_like(lr, base_lr), lr)
            return lr

        return schedule

    return {g: make_schedule(base_lrs[g], config.head_lr_warmup_epochs
                             if g == "classification_head" else None)
            for g in GROUPS if g != "frozen"}


@dataclass
class OptState:
    """GroupAdamW's state, every value on the parameters' device: ``count``
    (int32, effective updates so far: the Adam count and the schedules'),
    ``mu`` and ``nu`` (one per trainable parameter; nu in the configured
    dtype), ``plateau_scale`` (f32, written by the host under
    ``scheduler="plateau"``), and for accumulation ``mini_step`` (int32)
    and ``acc`` (the running mean of the mini-batch gradients)."""
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    plateau_scale: torch.Tensor
    mini_step: torch.Tensor
    acc: List[torch.Tensor] = field(default_factory=list)

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state, in a fixed order."""
        return [self.count, *self.mu, *self.nu, self.plateau_scale, self.mini_step, *self.acc]

    def replace(self, **kw) -> "OptState":
        return dataclasses.replace(self, **kw)


class GroupAdamW:
    """optax ``adamw`` per LR group over the trainable parameters (in the
    order of ``groups``), with accumulation, a narrowed second moment and
    the plateau scale (see the module docstring)."""

    def __init__(self, config: TrainingConfig, groups: Sequence[str], steps_per_epoch: int):
        if "frozen" in groups:
            raise ValueError("frozen parameters take no optimizer state")
        self.groups = tuple(groups)
        self.schedules = group_schedules(config, steps_per_epoch)
        self.weight_decay = config.weight_decay
        self.nu_dtype = NU_DTYPES[config.opt_nu_dtype]
        self.accum = config.accum_steps
        self.plateau = config.scheduler == "plateau"
        self.index = {g: [i for i, lbl in enumerate(self.groups) if lbl == g]
                      for g in dict.fromkeys(self.groups)}

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        dev = params[0].device
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            nu=[torch.zeros_like(p, dtype=self.nu_dtype) for p in params],
            plateau_scale=torch.ones((), dtype=torch.float32, device=dev),
            mini_step=torch.zeros((), dtype=torch.int32, device=dev),
            acc=[torch.zeros_like(p) for p in params] if self.accum > 1 else [],
        )

    def _adamw(self, grads: List[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]):
        """One inner AdamW update on ``grads``: (updates, count, mu, nu)."""
        mu = list(torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1),
                                     torch._foreach_mul(state.mu, B1)))
        nu32 = [v.float() for v in state.nu]
        nu32 = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2),
                                  torch._foreach_mul(nu32, B2))
        count = state.count + 1
        c = count.float()
        bc1 = 1.0 - torch.pow(torch.full_like(c, B1), c)
        bc2 = 1.0 - torch.pow(torch.full_like(c, B2), c)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu32, bc2)), EPS)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        updates = list(torch._foreach_add(updates, torch._foreach_mul(list(params),
                                                                      self.weight_decay)))
        for g, idx in self.index.items():
            step_size = -self.schedules[g](state.count)
            scaled = torch._foreach_mul([updates[i] for i in idx], step_size)
            for i, u in zip(idx, scaled):
                updates[i] = u
        if self.plateau:
            updates = list(torch._foreach_mul(updates, state.plateau_scale))
        nu = [v.to(self.nu_dtype) for v in nu32]
        return updates, count, mu, nu

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], OptState]:
        """(updates to add to the parameters, the new state).  With
        accumulation the gradients' running mean feeds the inner update,
        which lands (and advances the count) on every ``accum``-th call;
        the other calls return zero updates and the old inner state."""
        grads = list(grads)
        if self.accum == 1:
            updates, count, mu, nu = self._adamw(grads, state, params)
            return updates, state.replace(count=count, mu=mu, nu=nu)
        n = state.mini_step.float() + 1.0
        acc = torch._foreach_add(state.acc, torch._foreach_div(
            torch._foreach_sub(grads, state.acc), n))
        updates, count, mu, nu = self._adamw(acc, state, params)
        emit = state.mini_step == self.accum - 1
        emit_f = emit.float()

        def on_emit(new, old):
            return [torch.where(emit, a, b) for a, b in zip(new, old)]

        return list(torch._foreach_mul(updates, emit_f)), state.replace(
            count=torch.where(emit, count, state.count),
            mu=on_emit(mu, state.mu),
            nu=on_emit(nu, state.nu),
            mini_step=(state.mini_step + 1) % self.accum,
            acc=list(torch._foreach_mul(acc, 1.0 - emit_f)),
        )


def build_optimizer(config: TrainingConfig, model: torch.nn.Module, steps_per_epoch: int
                    ) -> Tuple[GroupAdamW, List[Tuple[str, torch.nn.Parameter]]]:
    """Freeze by group and build the optimizer over the trainable
    parameters: (optimizer, [(name, parameter), ...])."""
    trainable = freeze(model, config)
    labels = label_params(model, config)
    return GroupAdamW(config, [labels[n] for n, _ in trainable], steps_per_epoch), trainable


def set_plateau_scale(state: OptState, scale: float) -> None:
    """Write the host's plateau LR scale (``PlateauScheduler.step``) into the
    optimizer state; it multiplies every update under scheduler="plateau"."""
    state.plateau_scale.fill_(scale)
