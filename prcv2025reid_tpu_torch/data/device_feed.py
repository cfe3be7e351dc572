"""The device side of the data path: host batches onto the card, and the
images' normalization there.

``prefetch_to_device`` is the counterpart of the JAX package's
``data/pipeline.py::prefetch_to_device`` (there: double-buffered
``jax.device_put``); ``normalize_images_device`` of its
``data/augment.py::normalize_images_device``.  This module imports torch, so
the host pipeline's worker processes never import it (``data/pipeline.py``
and the modules it loads stay torch-free).
"""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD


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
    # torch.export traces with tensors of its own: none may enter the cache
    mean, std = (_mean_std.__wrapped__ if torch.compiler.is_exporting() else _mean_std)(
        images.device)
    return (x - mean) / std


class _PinnedSlot:
    """One batch's pinned host buffers (by key) and the event of the last
    copy out of them: the buffers are rewritten only once that copy is done."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def stage(self, key: str, array: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(array)
        buf = self.buffers.get(key)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.buffers[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        return buf.copy_(src)


def _feed_cuda(it: Iterator[Mapping[str, np.ndarray]], size: int,
               device: torch.device) -> Iterator[Dict[str, torch.Tensor]]:
    """``size`` batches ahead: each copied from pinned memory with
    ``non_blocking=True`` on a side stream, an event recorded after its
    copies; at hand-over the consumer's stream waits for that event and each
    tensor is recorded on it (so the caching allocator does not hand its
    memory to the side stream while the consumer still reads it)."""
    copy_stream = torch.cuda.Stream(device)
    slots = [_PinnedSlot() for _ in range(size + 1)]
    inflight: List = []  # (batch on the device, its copies' event)
    n = 0

    def put(batch: Mapping[str, np.ndarray]):
        nonlocal n
        slot = slots[n % len(slots)]
        n += 1
        if slot.copied is not None:
            slot.copied.synchronize()  # only that earlier copy, not the device
        staged = {k: slot.stage(k, np.asarray(v)) for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            on_dev = {k: b.to(device, non_blocking=True) for k, b in staged.items()}
            slot.copied = torch.cuda.Event()
            slot.copied.record(copy_stream)
        inflight.append((on_dev, slot.copied))

    for _ in range(size):
        batch = next(it, None)
        if batch is None:
            break
        put(batch)
    while inflight:
        on_dev, ready = inflight.pop(0)
        batch = next(it, None)
        if batch is not None:
            put(batch)  # into the slot of the batch handed over before this one
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for t in on_dev.values():
            t.record_stream(consumer)
        yield on_dev


def prefetch_to_device(iterator: Iterable[Mapping[str, np.ndarray]], size: int = 2,
                       device: Union[str, torch.device] = "cuda", sharding=None,
                       mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches (dicts of numpy arrays) -> dicts of tensors on
    ``device``, ``size`` batches ahead of the consumer.

    On a CUDA device each batch is staged in pinned host memory and copied
    with ``non_blocking=True`` on a side stream; the consumer's current
    stream waits on the copy's event, so neither the copy nor the hand-over
    makes the host wait for the device (a pinned buffer is reused only after
    its earlier copy's event has completed).  ``device="cpu"`` yields the
    batches as CPU tensors.  There is no CPU fallback when a CUDA device was
    asked for and none is present: that raises.

    Data parallel (a ``parallel/mesh.py::Mesh``): with ``mesh`` the batches
    are this process's slices of the global batch (``HostPipeline`` makes
    them) and go to this process's ``device`` as they are, the slice the
    data-parallel step takes; with ``sharding`` each batch is the global
    batch, and only this process's rows are copied."""
    if size < 1:
        raise ValueError(f"size={size} must be >= 1")
    from prcv2025reid_tpu_torch.engine import resolve_device  # engine imports the models
    from prcv2025reid_tpu_torch.parallel.mesh import shard_batch, spanning

    dev = resolve_device(device)
    it = iter(iterator)
    spanning(mesh)  # a mesh of N processes outside a group of N raises
    if spanning(sharding) is not None:
        it = (shard_batch(b, sharding) for b in it)
    if dev.type == "cuda":
        return _feed_cuda(it, size, dev)
    return ({k: torch.as_tensor(np.asarray(v), device=dev) for k, v in b.items()} for b in it)
