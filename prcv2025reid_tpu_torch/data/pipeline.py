"""Batch collation + multiprocess host pipeline (own copy of the JAX
package's ``data/pipeline.py``: ``collate``, ``resolve_num_workers``,
``HostPipeline``; ``pad_batch_to`` is ``parallel/mesh.py``'s, as in JAX).

Reference counterparts:
- ``collate``: compatible_collate_fn (datasets/dataset.py:1467-1606) — stacks
  samples and RECOMPUTES the real modality mask by checking image tensors are
  actually non-zero AND the sampler-declared mask (|x|.sum() > 1e-6 clause at
  datasets/dataset.py:1526-1554).
- ``HostPipeline``: replaces torch DataLoader workers (train.py:1388-1396)
  with spawn-based worker PROCESSES (decode+augment is GIL-bound in threads).
  Workers run pure numpy/PIL: this module and every module it loads import
  no torch, so a worker neither loads the model stack nor touches the card;
  the main process collates and tokenizes (tokenization is cached/native and
  cheap).  The device copy is ``data/device_feed.py::prefetch_to_device``,
  which workers never import.

Images travel as uint8 (4x less IPC and H2D traffic than float32);
normalization runs on the device inside the model.
"""
from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
from prcv2025reid_tpu_torch.data.sampler import PKBatchSampler
from prcv2025reid_tpu_torch.parallel.mesh import pad_batch_to  # noqa: F401 (re-exported)
from prcv2025reid_tpu_torch.utils import distributed


def collate(samples: Sequence[Dict], tokenizer) -> Dict[str, np.ndarray]:
    """Stack samples into the dense batch the model consumes."""
    images = np.stack([s["images"] for s in samples])  # [B, Mv, H, W, 3] uint8
    # Real-mask semantics: the reference's collate re-tests each NORMALIZED
    # tensor (|x|.sum() > 1e-6, dataset.py:1526-1554) to tell zero-placeholder
    # failures apart from real images — any successfully loaded image (even
    # all-black) is non-zero after normalize.  Here get_sample sets image_mask
    # per load success, which IS that distinction; a uint8 pixel test would
    # wrongly drop genuinely black source images (zero uint8 == placeholder).
    image_mask = np.stack([s["image_mask"] for s in samples])  # [B, Mv]

    captions = [s["caption"] or "" for s in samples]
    tokens = tokenizer(captions).astype(np.int32)
    # real-text check: whitespace-only captions are masked out, mirroring the
    # reference's has_valid_text = len(td.strip()) > 0 (dataset.py:1530-1540)
    text_mask = np.asarray(
        [s["text_mask"] * (1.0 if str(c).strip() else 0.0) for s, c in zip(samples, captions)],
        np.float32,
    )

    return {
        "images": images,
        "image_mask": image_mask.astype(np.float32),
        "text_tokens": tokens,
        "text_mask": text_mask,
        "labels": np.asarray([s["label"] for s in samples], np.int32),
        "pids": np.asarray([s["pid"] for s in samples], np.int32),
        "indices": np.asarray([s["index"] for s in samples], np.int32),
    }


def resolve_num_workers(n: int) -> int:
    """-1 (auto) -> size the decode pool to the host: available cores - 1
    (the main process needs its own core for collate/tokenize/dispatch),
    clamped to [1, 32].  Non-negative values pass through (0 = in-process).

    A fixed small default (the reference's workers=2, train.py:1388-1396)
    starves a fast device: chip_smoke.py's dataset phase prints the
    pipeline's batches/s beside the train step's it/s on the card."""
    if n >= 0:
        return n
    import os

    # honor cgroup quotas / affinity masks: on a restricted container
    # os.cpu_count() reports the machine, not the allotment
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 2
    return max(1, min(32, cores - 1))


# ----- worker-process plumbing (spawn-safe, no torch in workers) -----

_WORKER_DS: Optional[MultiModalDataset] = None
_WORKER_DROPOUT: Optional[float] = None


def _worker_init(dataset: MultiModalDataset, modality_dropout: Optional[float]):
    global _WORKER_DS, _WORKER_DROPOUT
    _WORKER_DS = dataset
    _WORKER_DROPOUT = modality_dropout


def _worker_make_samples(args):
    pos, indices, seed = args
    rng = np.random.default_rng(seed)
    samples = [
        _WORKER_DS.get_sample(i, rng, modality_dropout=_WORKER_DROPOUT)
        for i in indices
    ]
    return pos, samples


class HostPipeline:
    """Sampler -> per-sample load/augment (worker processes) -> collate.

    Multi-process: every process runs the SAME sampler stream (identical
    seed -> identical global index batches) and materializes only its
    contiguous slice of each global batch; a slice that the global batch
    does not fill is padded (zero masks, label and pid -1).  Single process
    is the degenerate pc=1 path — one code path.  ``process_index`` and
    ``process_count`` default to the ``torch.distributed`` group's (0 and 1
    without one), as JAX's ask its runtime.
    """

    def __init__(
        self,
        dataset: MultiModalDataset,
        sampler: PKBatchSampler,
        tokenizer,
        num_workers: int = -1,
        prefetch: int = 2,
        seed: int = 0,
        modality_dropout: Optional[float] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.tokenizer = tokenizer
        self.num_workers = resolve_num_workers(num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.epoch = 0
        self.modality_dropout = modality_dropout
        self._pool: Optional[ProcessPoolExecutor] = None
        if process_index is None:
            process_index = distributed.process_index()
        if process_count is None:
            process_count = distributed.process_count()
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))

    def _local_slice(self, indices: List[int]):
        """(local_indices, local_size, n_real) — this process's contiguous
        slice of a global batch.  Every process contributes an EQUAL local
        size (the global batch is assembled from equal shards); when the
        global batch does not divide evenly the tail rows are padding (zero
        masks + label -1, via pad_batch_to in _finalize).  A process whose
        slice is entirely padding loads one structure-only dummy sample that
        _finalize crops away."""
        pc, pi = self.process_count, self.process_index
        if pc == 1:
            return list(indices), len(indices), len(indices)
        per = -(-len(indices) // pc)  # ceil
        start = pi * per
        end = min(start + per, len(indices))
        local = list(indices[start:max(start, end)])
        n_real = len(local)
        if not local:
            local = [indices[0]]
        return local, per, n_real

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _make_batch(self, indices: List[int], batch_seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(batch_seed)
        samples = [
            self.dataset.get_sample(i, rng, modality_dropout=self.modality_dropout)
            for i in indices
        ]
        return collate(samples, self.tokenizer)

    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            ctx = mp.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=ctx,
                initializer=_worker_init,
                initargs=(self.dataset, self.modality_dropout),
            )
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def refresh_workers(self):
        """Re-pickle the dataset into fresh workers.  Call after mutating
        dataset state (e.g. the epoch-5 augmentation relaxation,
        train.py:1630-1644) — existing workers hold the old pickled copy."""
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        return len(self.sampler)

    def _finalize(self, batch: Dict[str, np.ndarray], local_size: int, n_real: int):
        if n_real != batch["labels"].shape[0]:
            batch = {k: v[:n_real] for k, v in batch.items()}  # drop dummy rows
        if batch["labels"].shape[0] != local_size:
            batch = pad_batch_to(batch, local_size)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # every process draws the same global stream; the per-batch seed is
        # offset by the process index only through the slice (augment RNG is
        # per-sample-position, so local slices must use distinct seeds)
        global_batches = list(self.sampler)
        sliced = [self._local_slice(idxs) for idxs in global_batches]
        seeds = [
            self.seed
            + self.epoch * 1_000_003
            + i * (self.process_count + 1)
            + self.process_index
            for i in range(len(sliced))
        ]
        if self.num_workers == 0:
            for (idxs, local_size, n_real), s in zip(sliced, seeds):
                yield self._finalize(self._make_batch(idxs, s), local_size, n_real)
            return

        pool = self._ensure_pool()
        inflight = self.num_workers + self.prefetch
        futures: Dict[int, object] = {}
        tasks = list(enumerate(zip(sliced, seeds)))
        next_submit = 0
        next_pos = 0
        while next_pos < len(tasks):
            while next_submit < len(tasks) and len(futures) < inflight:
                pos, ((idxs, _, _), s) = tasks[next_submit]
                futures[pos] = pool.submit(_worker_make_samples, (pos, idxs, s))
                next_submit += 1
            fut = futures.pop(next_pos)
            _, samples = fut.result()
            yield self._finalize(
                collate(samples, self.tokenizer),
                sliced[next_pos][1],
                sliced[next_pos][2],
            )
            next_pos += 1

