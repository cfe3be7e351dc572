"""Entry points: build the model on a device, embed a batch of any
modality combo or through the full forward, and train it.

``make_combo_embed_step`` is the counterpart of the JAX package's
``training/train_step.py::make_combo_embed_step``: uint8 images
[B, Mv, H, W, 3] (and, for a combo with text, token rows [B, S]) in,
L2-normalised f32 [B, fusion_dim] out, on the model's device;
``make_embed_step`` (from ``training/train_step.py``) embeds every modality
through the full forward, as JAX's ``make_embed_step``;
``make_weighted_embed_step`` is the weighted-sum query fusion of JAX's
``make_weighted_embed_step`` (text 1.2).
``init_train_state(model, config, steps_per_epoch, seed=0)`` and
``make_train_step(model, config, steps_per_epoch)`` (from
``training/train_step.py``) are the counterparts of ``TrainState.create`` +
``build_optimizer`` and of ``make_train_step``: ``train_step(state, batch,
sdm_weight, sdm_tau, enable_modality_dropout=False) -> (state, metrics)``,
one training step on the model's device with no host synchronisation.
``Trainer(config, device="cuda")`` (from ``training/trainer.py``, loaded on
first access) runs the whole training loop: epochs, evaluation,
checkpoints and resume; ``load_checkpoint_model(model_path, device)``
restores the eval model of a checkpoint it wrote (the eval and serving
command lines).  Entry points run on the card unless the caller
passes ``device="cpu"``; with no CUDA device they raise rather than carry
on on the CPU.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel
from prcv2025reid_tpu_torch.params import check_skipped, init_params, load_params
from prcv2025reid_tpu_torch.training.train_step import (  # noqa: F401 (entry points)
    init_train_state,
    make_embed_step,
    make_train_step,
)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain versions on the CPU"
        )
    return dev


def build_model(config: TrainingConfig,
                params: Optional[Union[str, Mapping[str, np.ndarray]]] = None,
                device: Union[str, torch.device] = "cuda",
                num_classes: Optional[int] = None, seed: int = 0) -> MultiModalReIDModel:
    """The eval model on ``device``.  ``params``: a flat ``/``-keyed dict or
    the path of a ``params_to_npz`` file; None = ``init_params(config,
    num_classes, seed)``."""
    dev = resolve_device(device)
    if params is None:
        if num_classes is None:
            raise ValueError("num_classes is required when params is None")
        params = init_params(config, num_classes, seed)
    elif isinstance(params, str):
        with np.load(params) as z:
            params = {k: z[k] for k in z.files}
    if num_classes is None:
        num_classes = params["params/bn_neck/classifier/kernel"].shape[-1]
    model = MultiModalReIDModel(config, num_classes, device=dev)
    check_skipped(load_params(model, params))
    return model.eval()


def load_checkpoint_model(model_path: str, device: Union[str, torch.device] = "cuda",
                          **overrides) -> Tuple[TrainingConfig, MultiModalReIDModel, object,
                                                dict]:
    """The eval model of a checkpoint directory written by the port's
    trainer (``state.pt`` + ``host_state.json``) -> ``(config, model,
    state, host_state)``.  The config is the sidecar's with ``overrides``
    applied (a combination the config refuses raises ``ValueError``); every
    parameter and BN statistic comes from the checkpoint, whose optimizer
    state is checked against an ``init_train_state`` template."""
    from prcv2025reid_tpu_torch.training.checkpoint import restore_checkpoint

    dev = resolve_device(device)
    with open(os.path.join(model_path, "host_state.json")) as f:
        host = json.load(f)
    config = TrainingConfig.from_json(host["config"])
    if overrides:
        config = config.replace(**overrides)
    model = MultiModalReIDModel(config, host["num_classes"], device=dev).eval()
    template = init_train_state(model, config, steps_per_epoch=1)
    path = os.path.abspath(model_path)  # abspath strips a trailing /
    state, _ = restore_checkpoint(os.path.dirname(path), model, template,
                                  name=os.path.basename(path), device=dev)
    return config, model, state, host


def make_combo_embed_step(model: MultiModalReIDModel,
                          active: Sequence[str]) -> Callable[..., torch.Tensor]:
    """Embedding specialised to a static modality combo (gallery 'vis' = one
    ViT pass).  The step takes ``images`` [B, Mv, H, W, 3] (uint8) and
    ``image_mask`` [B, Mv], and for a combo with "text" also ``text_tokens``
    [B, S] (int) and ``text_mask`` [B], as tensors or numpy arrays; a combo
    without "text" ignores them, as JAX's does."""
    active = tuple(active)

    @torch.inference_mode()
    def embed(images, image_mask, text_tokens=None, text_mask=None) -> torch.Tensor:
        args = _step_inputs(model, active, images, image_mask, text_tokens, text_mask)
        feats = model.encode_subset(*args, active).float()
        norm = torch.clamp(torch.linalg.vector_norm(feats, dim=1, keepdim=True), min=1e-12)
        return feats / norm

    return embed


def _step_inputs(model: MultiModalReIDModel, active: Tuple[str, ...], images, image_mask,
                 text_tokens, text_mask):
    """An embed step's arguments as tensors on the model's device; the text
    rows only for a combo with "text", which needs them."""
    device = model.null_tokens.device
    images = torch.as_tensor(images, device=device)
    image_mask = torch.as_tensor(image_mask, device=device)
    if "text" not in active:
        return images, image_mask, None, None
    if text_tokens is None or text_mask is None:
        raise ValueError(f"the combo {active} needs text_tokens and text_mask")
    return (images, image_mask, torch.as_tensor(text_tokens, device=device),
            torch.as_tensor(text_mask, device=device))


def make_weighted_embed_step(model: MultiModalReIDModel, active: Sequence[str],
                             weights: Optional[Mapping[str, float]] = None
                             ) -> Callable[..., torch.Tensor]:
    """Weighted-sum query fusion (``MultiModalReIDModel.encode_weighted``):
    each active modality embedded alone through the head, the unit features
    weight-summed (text 1.2, every other modality 1.0, unless ``weights``
    says otherwise) and renormalised, with one stacked trunk pass.  The
    step takes the arguments of ``make_combo_embed_step``'s step and returns
    unit f32 [B, fusion_dim]."""
    active = tuple(active)
    weights = weights or {}
    w = tuple(float(weights.get(m, 1.2 if m == "text" else 1.0)) for m in active)

    @torch.inference_mode()
    def embed(images, image_mask, text_tokens=None, text_mask=None) -> torch.Tensor:
        args = _step_inputs(model, active, images, image_mask, text_tokens, text_mask)
        return model.encode_weighted(*args, active, w)

    return embed


def __getattr__(name: str):
    # the trainer imports this module, so it loads on first access
    if name == "Trainer":
        from prcv2025reid_tpu_torch.training.trainer import Trainer

        return Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
