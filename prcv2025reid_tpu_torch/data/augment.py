"""Device-side image normalization (counterpart of the JAX package's
``data/augment.py::normalize_images_device``)."""
from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device):
    """The constants on ``device``, copied there once: a host-to-device copy
    of pageable memory waits for the device, so a step must not make one."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def normalize_images_device(images: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> ImageNet-normalized float32 on the tensor's
    device.  Float inputs pass through unchanged (already normalized)."""
    if images.dtype != torch.uint8:
        return images
    x = images.to(torch.float32) / 255.0
    mean, std = _mean_std(images.device)
    return (x - mean) / std
