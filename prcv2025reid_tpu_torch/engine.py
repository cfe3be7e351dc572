"""Entry points: build the model on a device, embed a batch of any
modality combo or through the full forward, and train it.

``make_combo_embed_step`` is the counterpart of the JAX package's
``training/train_step.py::make_combo_embed_step``: uint8 images
[B, Mv, H, W, 3] (and, for a combo with text, token rows [B, S]) in,
L2-normalised f32 [B, fusion_dim] out, on the model's device;
``make_embed_step`` (from ``training/train_step.py``) embeds every modality
through the full forward, as JAX's ``make_embed_step``.
``init_train_state(model, config, steps_per_epoch, seed=0)`` and
``make_train_step(model, config, steps_per_epoch)`` (from
``training/train_step.py``) are the counterparts of ``TrainState.create`` +
``build_optimizer`` and of ``make_train_step``: ``train_step(state, batch,
sdm_weight, sdm_tau, enable_modality_dropout=False) -> (state, metrics)``,
one training step on the model's device with no host synchronisation.
Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device they raise rather than carry on on the CPU.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Union

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


def make_combo_embed_step(model: MultiModalReIDModel,
                          active: Sequence[str]) -> Callable[..., torch.Tensor]:
    """Embedding specialised to a static modality combo (gallery 'vis' = one
    ViT pass).  The step takes ``images`` [B, Mv, H, W, 3] (uint8) and
    ``image_mask`` [B, Mv], and for a combo with "text" also ``text_tokens``
    [B, S] (int) and ``text_mask`` [B], as tensors or numpy arrays; a combo
    without "text" ignores them, as JAX's does."""
    active = tuple(active)
    device = model.null_tokens.device

    @torch.inference_mode()
    def embed(images, image_mask, text_tokens=None, text_mask=None) -> torch.Tensor:
        images = torch.as_tensor(images, device=device)
        image_mask = torch.as_tensor(image_mask, device=device)
        if "text" in active:
            if text_tokens is None or text_mask is None:
                raise ValueError(f"the combo {active} needs text_tokens and text_mask")
            text_tokens = torch.as_tensor(text_tokens, device=device)
            text_mask = torch.as_tensor(text_mask, device=device)
        else:
            text_tokens = text_mask = None
        feats = model.encode_subset(images, image_mask, text_tokens, text_mask, active).float()
        norm = torch.clamp(torch.linalg.vector_norm(feats, dim=1, keepdim=True), min=1e-12)
        return feats / norm

    return embed

