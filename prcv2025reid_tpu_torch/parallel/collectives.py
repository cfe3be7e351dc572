"""The collectives of the parallel train step and evaluation: the data
axis's and the model axis's.

Under GSPMD, JAX's sharded step is the one-device step on the global batch.
The port's processes each hold a contiguous slice of it (one a data index),
so every place where samples couple is made global here, explicitly, over
the mesh's data group (the processes with this model index):

- :func:`global_rows`: the global batch's rows of a per-sample tensor, on
  every process, differentiable.  Forward: an all-reduce of a zeroed
  [N*B, ...] buffer holding this process's rows.  Backward: this process's
  rows of the incoming gradient.  Every process computes the same loss from
  the same gathered tensor, so the gradient that reaches the gather is the
  whole dL/dG on each; its own rows are its share, with no reduction.
- :func:`global_sum`: a sum over the processes, differentiable.  Forward and
  backward are both an all-reduce: each process's gradient of the sum holds
  only its own rows' contributions (its downstream is local), and the true
  one is their sum.
- :func:`uniform_rows`: a random draw of the global batch's shape, of which
  this process keeps its rows, so that N processes draw the masks one
  process draws for the global batch.
- :func:`all_reduce_grads`: the parameter gradients summed over the
  processes in one flat buffer.  With the two rules above, each process's
  gradient is its rows' share of the global-batch gradient, so their SUM is
  that gradient (not a mean: dividing by N would give 1/N of it).

The step makes them active with :func:`data_parallel`; outside it (a data
axis of one, or no mesh) each is the identity, or the local draw.  The
gather assumes equal shards (the host pipeline pads the global batch to a
multiple of the data size), so no size crosses to the host.

The model axis (tensor parallelism, ``parallel/tp.py``) has the two Megatron
operators, over the mesh's model group (the processes with this data
index), which the sharded blocks call themselves:

- :func:`copy_to_model`: identity forward, all-reduce backward; at the input
  of a column-parallel section, whose processes each compute their outputs
  from the whole input, so the input's gradient is the sum of theirs.
- :func:`reduce_from_model`: all-reduce forward, identity backward; after a
  row-parallel product, whose processes each hold a partial sum.  Its
  backward is the identity (unlike :func:`global_sum`'s all-reduce): every
  process of the group computes the same loss from the reduced output, so
  each holds the whole gradient already.

Every collective is an ``all_reduce``, which gloo runs on CUDA tensors as
well as CPU ones; a backend that refuses a tensor raises.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, List, Optional, Sequence

import torch

from prcv2025reid_tpu_torch.parallel.mesh import Mesh

# the mesh whose collectives are active (the step's; per thread and task)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_parallel_mesh", default=None)

# wall seconds and calls spent in the data axis's (``stats``) and the model
# axis's (``model_stats``) collectives; ``timed`` makes each call
# synchronise the device before and after, so that the seconds are the
# collective's own
stats = {"calls": 0, "seconds": 0.0}
model_stats = {"calls": 0, "seconds": 0.0}
timed = False


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Run the block with ``mesh``'s collectives active (a mesh of one
    process, or None: none)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.size > 1 else None)
    try:
        yield _ACTIVE.get()
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Mesh]:
    return _ACTIVE.get()


def _all_reduce(t: torch.Tensor, group=None, counter=None) -> torch.Tensor:
    """``t`` summed in place over ``group`` (None: the whole group), counted
    in ``counter`` (default ``stats``)."""
    import torch.distributed as dist

    if timed and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if timed and t.is_cuda:
        torch.cuda.synchronize(t.device)
    counter = stats if counter is None else counter
    counter["calls"] += 1
    counter["seconds"] += time.perf_counter() - t0
    return t


def model_all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed in place over ``mesh``'s model group (no autograd)."""
    return _all_reduce(t, mesh.model_group, model_stats)


def model_all_gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which each process of ``mesh``'s model group
    holds an equal slice along ``dim``, in model order (no autograd): an
    all-reduce of a zeroed buffer holding this process's slice."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * mesh.model_size
    out = t.new_zeros(shape)
    out.narrow(dim, mesh.model_rank * n, n).copy_(t)
    return model_all_reduce(out, mesh)


def _gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    moved = x.movedim(dim, 0)
    b = moved.shape[0]
    out = torch.zeros((mesh.size * b,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
    out[mesh.rank * b:(mesh.rank + 1) * b] = moved
    return _all_reduce(out, mesh.data_group).movedim(0, dim)


class _GlobalRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.b = mesh, dim, x.shape[dim]
        return _gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        m = ctx.mesh
        return grad.narrow(ctx.dim, m.rank * ctx.b, ctx.b), None, None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad.clone(), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return model_all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a column-parallel section: ``x`` itself, whose gradient
    is summed over ``mesh``'s model group.  ``x`` itself without a model
    axis, or without autograd."""
    if mesh is None or mesh.model_size == 1 or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over ``mesh``'s model
    group; the gradient passes through unchanged.  ``x`` itself without a
    model axis."""
    if mesh is None or mesh.model_size == 1:
        return x
    if x.requires_grad:
        return _ReduceFromModel.apply(x, mesh)
    return model_all_reduce(x.detach().clone(), mesh)


def global_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch's ``x`` (every process's rows along ``dim`` in
    process order), differentiable; ``x`` itself without an active mesh."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    if x.requires_grad:
        return _GlobalRows.apply(x, mesh, dim)
    return _gather(x.detach(), mesh, dim)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, differentiable; ``x`` itself without
    an active mesh."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    if x.requires_grad:
        return _GlobalSum.apply(x, mesh.data_group)
    return _all_reduce(x.detach().clone(), mesh.data_group)


def process_count() -> int:
    """The active mesh's data size (1 without one)."""
    mesh = _ACTIVE.get()
    return 1 if mesh is None else mesh.size


def uniform_rows(shape: Sequence[int], generator: Optional[torch.Generator],
                 device, batch_dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)``, where ``shape[batch_dim]`` is this process's
    rows of the global batch: with an active mesh the draw has the global
    batch's shape and this process keeps its rows, so the values are those
    one process draws for the global batch."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    shape = list(shape)
    b = shape[batch_dim]
    shape[batch_dim] = b * mesh.size
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return u.narrow(batch_dim, mesh.rank * b, b).contiguous()


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Optional[Mesh],
                     axis: str = "data") -> List[torch.Tensor]:
    """The gradients summed over ``mesh``'s data group (``axis="model"``:
    its model group), through one flat buffer a dtype; the list itself
    without more than one process along the axis."""
    grads = list(grads)
    n = 1 if mesh is None else (mesh.size if axis == "data" else mesh.model_size)
    if n == 1 or not grads:
        return grads
    group, counter = ((mesh.data_group, stats) if axis == "data"
                      else (mesh.model_group, model_stats))
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), group, counter)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out
