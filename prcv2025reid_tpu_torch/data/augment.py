"""Host-side image augmentation (PIL + numpy), own copy of the JAX
package's ``data/augment.py::ImageTransform``.

Reference: datasets/dataset.py:259-307 (ModalityAugmentation) —
train: RandomResizedCrop(scale 0.8-1.0) + HFlip(0.5) + ColorJitter(0.2/0.2)
+ ImageNet normalize + RandomErasing(p=0.3); val: resize + normalize.

Output layout is NHWC uint8; normalization runs on the device
(``data/device_feed.py::normalize_images_device``).  All randomness flows
through an explicit numpy Generator so the pipeline is reproducible and
checkpointable.  This module imports no torch: the pipeline's worker
processes import it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _random_resized_crop_params(
    rng: np.random.Generator,
    width: int,
    height: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
):
    """Sample (left, top, w, h) a la torchvision RandomResizedCrop."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            left = int(rng.integers(0, width - w + 1))
            top = int(rng.integers(0, height - h + 1))
            return left, top, w, h
    # center-crop fallback
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    return (width - w) // 2, (height - h) // 2, w, h


# uint8 pixel values whose normalized form is ~0 (erase fill; the reference
# erases with 0 in NORMALIZED space, datasets/dataset.py:269-276)
_ERASE_FILL_U8 = np.round(IMAGENET_MEAN * 255.0).astype(np.uint8)


class ImageTransform:
    """Train/val transform: PIL image -> uint8 [H, W, 3].

    The host side stays in uint8 (integer jitter/erase, PIL crops) — 4x less
    worker IPC + host->device traffic than float32; the model applies /255 +
    ImageNet normalization on the device.  Augment semantics match the
    reference's float pipeline up to uint8 rounding.
    """

    def __init__(
        self,
        image_size: int = 224,
        train: bool = False,
        crop_scale_min: float = 0.8,
        flip: bool = True,
        color_jitter: float = 0.2,
        random_erase: float = 0.3,
        random_crop: bool = True,
    ):
        self.image_size = image_size
        self.train = train
        self.crop_scale_min = crop_scale_min
        self.flip = flip
        self.color_jitter = color_jitter
        self.random_erase = random_erase
        self.random_crop = random_crop

    def set_crop_scale_min(self, value: float):
        """Augmentation relaxation hook (reference: train.py:1630-1644)."""
        self.crop_scale_min = value

    def __call__(
        self, img: Image.Image, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        S = self.image_size
        if self.train and rng is not None:
            if self.random_crop:
                left, top, w, h = _random_resized_crop_params(
                    rng, img.width, img.height, (self.crop_scale_min, 1.0)
                )
                img = img.resize(
                    (S, S), Image.BILINEAR, box=(left, top, left + w, top + h)
                )
            else:
                img = img.resize((S, S), Image.BILINEAR)
            x = np.asarray(img, np.uint8)
            return self._flip_jitter_erase(x, rng)
        img = img.resize((S, S), Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def load_and_transform(
        self,
        path: str,
        rng: Optional[np.random.Generator] = None,
        use_native: bool = False,
    ) -> np.ndarray:
        """File -> transformed uint8 [S, S, 3].

        ``use_native=True`` routes JPEG decode + crop + resize through the
        C++ worker (data/native_image.py, one pass, PIL-matching resample);
        anything it cannot handle falls back to the PIL path.  The RNG draw
        ORDER is identical in both paths (crop box, flip, jitter, erase), so
        a run is reproducible as long as each image keeps taking the same
        path.
        """
        if use_native:
            x = self._native_load(path, rng)
            if x is not None:
                return x
        img = Image.open(path).convert("RGB")
        return self(img, rng)

    def _native_load(
        self, path: str, rng: Optional[np.random.Generator]
    ) -> Optional[np.ndarray]:
        from prcv2025reid_tpu_torch.data import native_image

        if not native_image.available():
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        info = native_image.decode_info(data)
        if info is None:
            return None
        w, h = info
        S = self.image_size
        if self.train and rng is not None:
            box = (
                _random_resized_crop_params(rng, w, h, (self.crop_scale_min, 1.0))
                if self.random_crop
                else None
            )
            x = native_image.decode_crop_resize(data, (S, S), box)
            if x is None:
                return None
            return self._flip_jitter_erase(x, rng)
        return native_image.decode_crop_resize(data, (S, S))

    def _flip_jitter_erase(
        self, x: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        """Shared post-decode train augmentations on a uint8 array (one RNG
        draw sequence for both the PIL and native decode paths)."""
        if self.flip and rng.random() < 0.5:
            x = x[:, ::-1]
        if self.color_jitter > 0:
            # torchvision adjust_contrast blends toward the mean of the LUMA
            # grayscale (0.299R+0.587G+0.114B), not the flat channel mean
            def _gray_point(img):
                return (img @ np.array([0.299, 0.587, 0.114], np.float32)).mean()

            x = x.astype(np.float32)
            b = rng.uniform(1 - self.color_jitter, 1 + self.color_jitter)
            c = rng.uniform(1 - self.color_jitter, 1 + self.color_jitter)
            if rng.random() < 0.5:
                x = np.clip(x * b, 0, 255)
                gray = _gray_point(x)
                x = np.clip((x - gray) * c + gray, 0, 255)
            else:
                gray = _gray_point(x)
                x = np.clip((x - gray) * c + gray, 0, 255)
                x = np.clip(x * b, 0, 255)
            x = x.astype(np.uint8)
        x = np.ascontiguousarray(x)
        if self.random_erase > 0 and rng.random() < self.random_erase:
            x = self._erase(x, rng)
        return x

    @staticmethod
    def _erase(
        x: np.ndarray,
        rng: np.random.Generator,
        scale=(0.02, 0.2),  # the reference overrides torchvision's 0.33 cap
        ratio=(0.3, 3.3),   # (datasets/dataset.py:296)
    ) -> np.ndarray:
        H, W = x.shape[:2]
        area = H * W
        for _ in range(10):
            target = area * rng.uniform(*scale)
            aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
            h = int(round(math.sqrt(target * aspect)))
            w = int(round(math.sqrt(target / aspect)))
            if h < H and w < W:
                top = int(rng.integers(0, H - h + 1))
                left = int(rng.integers(0, W - w + 1))
                x = x.copy()
                x[top : top + h, left : left + w] = _ERASE_FILL_U8
                return x
        return x
