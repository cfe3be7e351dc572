"""The process mesh over a process group (counterpart of the JAX package's
``parallel/mesh.py``, with its names).

JAX builds a ``jax.sharding.Mesh`` over every chip of every process; GSPMD
then runs the one global-batch program on it.  The port's mesh is the
``torch.distributed`` process group itself, one device a process, laid out
as JAX's ``devs.reshape(d, m)``: process r sits at data index ``r // m`` and
model index ``r % m``.  A :class:`Mesh` names the data axis's size and this
process's index along it (``size``, ``rank``), the model axis's
(``model_size``, ``model_rank``), and the two groups that its collectives
run on: the data group (the ``d`` processes with this model index) and the
model group (the ``m`` processes with this data index).

- Data axis: parameters and optimizer state are the same on the ``d``
  processes of a model index; each batch is split into contiguous
  per-process slices of the global batch (the ``m`` processes of a model
  group hold the same rows); the train step computes the global-batch loss,
  statistics and gradients with explicit collectives
  (``parallel/collectives.py``).
- Model axis (tensor parallelism, ``parallel/tp.py``): each process of a
  model group holds its Megatron shard of every column- and row-parallel
  projection, and the blocks all-reduce over the model group.

Two rules of JAX's have no counterpart (ROADMAP.md §3): a process drives one
device, so several devices a process are not meshed; and the mesh cannot
shrink to the largest data size that divides a batch (a process cannot sit
out), so a batch the data size does not divide is padded by the host
pipeline instead (label and pid -1, zero masks).

No torch import at module level: ``pad_batch_to`` runs in the data path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from prcv2025reid_tpu_torch.utils import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"  # tensor-parallel axis (parallel/tp.py)

# (d, m) -> (data groups by model index, model groups by data index): every
# process creates every group once, in the same order
_GROUPS: Dict[tuple, tuple] = {}


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh: ``size`` processes along ``'data'``, this
    one at ``rank``; ``model_size`` along ``'model'``, this one at
    ``model_rank``.  ``data_group`` / ``model_group``: the process groups of
    the two axes (None: the whole group, or an axis of one).  ``Mesh()`` is
    the one-process mesh."""
    size: int = 1
    rank: int = 0
    axis_names: tuple = (DATA_AXIS,)
    model_size: int = 1
    model_rank: int = 0
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    @property
    def world(self) -> int:
        """The process count, ``size * model_size``."""
        return self.size * self.model_size

    @property
    def process_rank(self) -> int:
        """This process's rank in the group, ``rank * model_size + model_rank``."""
        return self.rank * self.model_size + self.model_rank


def _groups(d: int, m: int):
    """The data groups (one a model index) and model groups (one a data
    index) of a ``d x m`` mesh over the whole group; an axis of one process
    has no group (its collectives are no-ops), and on a 1-D mesh the data
    group is the whole group (None)."""
    if (d, m) not in _GROUPS:
        import torch.distributed as dist

        data = ([None] * m if m == 1 or d == 1 else
                [dist.new_group([i * m + j for i in range(d)]) for j in range(m)])
        model = ([None] * d if m == 1 else
                 [None] if d == 1 else
                 [dist.new_group([i * m + j for j in range(m)]) for i in range(d)])
        _GROUPS[(d, m)] = (data, model)
    return _GROUPS[(d, m)]


def create_mesh(config=None, n_devices: Optional[int] = None,
                model_axis_size: Optional[int] = None) -> Mesh:
    """The mesh over the process group (one process: ``Mesh()``).

    1-D ``('data',)`` by default; 2-D ``('data', 'model')`` when
    ``config.mesh_axis_names`` says so (the model size is
    ``config.mesh_shape[1]``) or ``model_axis_size`` > 1, as JAX's.  A
    model size that does not divide the process count raises ValueError,
    as does a 2-D mesh with no model size.  ``config.mesh_shape`` or
    ``n_devices``, when given, must equal the process count: the mesh is
    the group, and JAX's shrinking of the data axis to divide a batch has no
    counterpart (the pipeline pads instead)."""
    axis_names = tuple(config.mesh_axis_names) if config is not None else (DATA_AXIS,)
    if model_axis_size is not None and model_axis_size > 1:
        axis_names = (DATA_AXIS, MODEL_AXIS)
    if not axis_names or axis_names[0] != DATA_AXIS:
        raise ValueError(f"mesh_axis_names must start with {DATA_AXIS!r}, got {axis_names!r}")
    if len(axis_names) > 2 or (len(axis_names) == 2 and axis_names[1] != MODEL_AXIS):
        raise ValueError(f"supported meshes: ({DATA_AXIS!r},) data-parallel or ({DATA_AXIS!r}, "
                         f"{MODEL_AXIS!r}) tensor-parallel; got {axis_names!r}")
    m = model_axis_size or 1
    if len(axis_names) == 2 and model_axis_size is None:
        if config is None or len(config.mesh_shape) != 2:
            raise ValueError("a ('data','model') mesh needs mesh_shape=(d, m) or an explicit "
                             "model_axis_size")
        m = int(config.mesh_shape[1])
    world, r = distributed.process_count(), distributed.process_index()
    if n_devices is None and config is not None and config.mesh_shape:
        n_devices = math.prod(config.mesh_shape)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over {world} process(es): the port's "
                         "mesh is the process group, one device a process")
    if m < 1 or world % m:
        raise ValueError(f"model_axis_size={m} does not divide {world} process(es)")
    d = world // m
    if world == 1:
        return Mesh(axis_names=axis_names)
    data, model = _groups(d, m)
    return Mesh(size=d, rank=r // m, axis_names=axis_names, model_size=m, model_rank=r % m,
                data_group=data[r % m], model_group=model[0 if d == 1 else r // m])


def _check_group(mesh: Mesh) -> None:
    """A mesh of N processes must match the group this process is in:
    without it its collectives would quietly run alone."""
    n = distributed.process_count()
    if n != mesh.world or distributed.process_index() != mesh.process_rank:
        raise ValueError(f"a mesh of {mesh.world} processes at rank {mesh.process_rank}, but "
                         f"this process is rank {distributed.process_index()} of {n}: join the "
                         "group first (utils/distributed.py::initialize_from_config)")


def spanning(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when its data axis spans more than one process, else None
    (the one-process path of the data axis)."""
    if mesh is None or mesh.world == 1:
        return None
    _check_group(mesh)
    return mesh if mesh.size > 1 else None


def model_spanning(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when its model axis spans more than one process, else None
    (no tensor parallelism)."""
    if mesh is None or mesh.world == 1:
        return None
    _check_group(mesh)
    return mesh if mesh.model_size > 1 else None


def data_axis_size(mesh: Mesh) -> int:
    """Shard count along the batch / gallery ('data') axis."""
    return mesh.size


def process_local_indices(n: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> slice:
    """This process's contiguous slice of ``n`` global rows (``n`` divides
    by the count; the pipeline pads).  The index and count default to the
    group's; a 2-D mesh passes its data index and size."""
    pi = distributed.process_index() if process_index is None else process_index
    pc = distributed.process_count() if process_count is None else process_count
    per = n // pc
    return slice(pi * per, (pi + 1) * per)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """A global host batch (every process holds it) -> this data index's rows."""
    sl = process_local_indices(next(iter(batch.values())).shape[0], mesh.rank, mesh.size)
    return {k: np.asarray(v)[sl] for k, v in batch.items()}


def make_global_batch(local_batch: Dict, mesh: Mesh) -> Dict:
    """Every data index's local rows -> the global batch (numpy), on every
    process: the inverse of :func:`shard_batch`.  A data axis of one: the
    batch as numpy."""
    if mesh.size == 1:
        return {k: np.asarray(v) for k, v in local_batch.items()}
    return {k: fetch_global(v, mesh) for k, v in local_batch.items()}


def fetch_global(x, mesh: Optional[Mesh]) -> np.ndarray:
    """``distributed.fetch_global`` over ``mesh``'s data group: this data
    index's rows in, the global rows in data order out."""
    return distributed.fetch_global(x, group=None if mesh is None else mesh.data_group)


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
