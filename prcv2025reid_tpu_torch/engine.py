"""Entry points: build the model on a device and embed a gallery batch.

``make_combo_embed_step`` is the counterpart of the JAX package's
``training/train_step.py::make_combo_embed_step``: uint8 images
[B, Mv, H, W, 3] in, L2-normalised f32 [B, fusion_dim] out, on the model's
device.  Entry points run on the card unless the caller passes
``device="cpu"``; with no CUDA device they raise rather than carry on on the
CPU.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel
from prcv2025reid_tpu_torch.params import check_skipped, init_params, load_params


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
    ``image_mask`` [B, Mv], as tensors or numpy arrays."""
    active = tuple(active)
    if "text" in active:
        raise NotImplementedError(
            "'text' in the active set is not ported yet: ROADMAP.md §1, the item "
            "'Text tower and encoder' (text tower)"
        )
    device = model.null_tokens.device

    @torch.inference_mode()
    def embed(images, image_mask) -> torch.Tensor:
        images = torch.as_tensor(images, device=device)
        image_mask = torch.as_tensor(image_mask, device=device)
        feats = model.encode_subset(images, image_mask, None, None, active).float()
        norm = torch.clamp(torch.linalg.vector_norm(feats, dim=1, keepdim=True), min=1e-12)
        return feats / norm

    return embed
