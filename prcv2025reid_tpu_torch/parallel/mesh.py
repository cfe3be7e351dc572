"""The data-parallel mesh over a process group (counterpart of the JAX
package's ``parallel/mesh.py``, with its names).

JAX builds a ``jax.sharding.Mesh`` over every chip of every process; GSPMD
then runs the one global-batch program on it.  The port's mesh is the
``torch.distributed`` process group itself, one device a process: a
:class:`Mesh` names the group's size and this process's rank along the
single ``'data'`` axis.  Parameters and optimizer state are replicated (every
process builds the same ones from the same seed and applies the same
all-reduced update); each batch is split into contiguous per-process slices
of the global batch; the train step computes the global-batch loss,
statistics and gradients with explicit collectives
(``parallel/collectives.py``).

Two rules of JAX's have no counterpart (ROADMAP.md §3): a process drives one
device, so several devices a process are not meshed; and the mesh cannot
shrink to the largest size that divides a batch (a process cannot sit
out), so a batch the process count does not divide is padded by the host
pipeline instead (label and pid -1, zero masks).  Tensor parallelism, the
2-D ``('data', 'model')`` mesh, is not ported yet (ROADMAP.md §1, item 8b).

No torch import at module level: ``pad_batch_to`` runs in the data path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from prcv2025reid_tpu_torch.utils import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"  # tensor parallelism: item 8b


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` processes along ``'data'``, this
    one at ``rank``.  ``size == 1`` is the one-process mesh."""
    size: int = 1
    rank: int = 0
    axis_names: tuple = (DATA_AXIS,)


def create_mesh(config=None, n_devices: Optional[int] = None) -> Mesh:
    """The mesh over the process group (one process: size 1).

    ``config.mesh_axis_names`` must be ``('data',)``: a model axis raises
    NotImplementedError (tensor parallelism, item 8b).  ``config.mesh_shape``
    or ``n_devices``, when given, must equal the process count: the mesh is
    the group, and JAX's shrinking of the data axis to divide a batch has no
    counterpart (the pipeline pads instead)."""
    axis_names = tuple(config.mesh_axis_names) if config is not None else (DATA_AXIS,)
    if MODEL_AXIS in axis_names:
        raise NotImplementedError(
            f"mesh_axis_names={axis_names!r}: tensor parallelism is not ported yet "
            "(ROADMAP.md §1, item 8b 'Tensor parallelism'); the port's mesh is the 1-D "
            f"({DATA_AXIS!r},) data-parallel one")
    if axis_names != (DATA_AXIS,):
        raise ValueError(f"supported meshes: ({DATA_AXIS!r},); got {axis_names!r}")
    size, rank = distributed.process_count(), distributed.process_index()
    if n_devices is None and config is not None and config.mesh_shape:
        n_devices = math.prod(config.mesh_shape)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices over {size} process(es): the port's "
                         "mesh is the process group, one device a process")
    return Mesh(size=size, rank=rank)


def spanning(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when it spans more than one process, else None (the
    one-process path).  A mesh of N processes must match the group this
    process is in: without it its collectives would quietly run alone."""
    if mesh is None or mesh.size == 1:
        return None
    n = distributed.process_count()
    if n != mesh.size or distributed.process_index() != mesh.rank:
        raise ValueError(f"a mesh of {mesh.size} processes at rank {mesh.rank}, but this "
                         f"process is rank {distributed.process_index()} of {n}: join the "
                         "group first (utils/distributed.py::initialize_from_config)")
    return mesh


def data_axis_size(mesh: Mesh) -> int:
    """Shard count along the batch / gallery ('data') axis."""
    return mesh.size


def process_local_indices(n: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> slice:
    """This process's contiguous slice of ``n`` global rows (``n`` divides
    by the process count; the pipeline pads).  The index and count default
    to the group's."""
    pi = distributed.process_index() if process_index is None else process_index
    pc = distributed.process_count() if process_count is None else process_count
    per = n // pc
    return slice(pi * per, (pi + 1) * per)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """A global host batch (every process holds it) -> this process's rows."""
    sl = process_local_indices(next(iter(batch.values())).shape[0], mesh.rank, mesh.size)
    return {k: np.asarray(v)[sl] for k, v in batch.items()}


def make_global_batch(local_batch: Dict, mesh: Mesh) -> Dict:
    """Every process's local rows -> the global batch (numpy), on every
    process: the inverse of :func:`shard_batch`.  One process: the batch as
    numpy."""
    if mesh.size == 1:
        return {k: np.asarray(v) for k, v in local_batch.items()}
    return {k: distributed.fetch_global(v) for k, v in local_batch.items()}


def pad_batch_to(batch: Dict, size: int) -> Dict:
    """Pad every array's batch dim to ``size`` with zeros; padded rows carry
    zero masks and label -1 so every loss / metric ignores them."""
    b = next(iter(batch.values())).shape[0]
    if b == size:
        return batch
    pad = size - b

    def _pad(name, x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        # labels AND pids pad with -1: -1 labels are loss-masked, and every
        # pid consumer treats negatives as padding — a 0 fill would conflate
        # padding with a real identity 0
        fill = -1 if name in ("labels", "pids") else 0
        return np.pad(np.asarray(x), widths, constant_values=fill)

    return {k: _pad(k, v) for k, v in batch.items()}
