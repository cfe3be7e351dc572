"""The collectives of the data-parallel train step, and the step's mesh.

Under GSPMD, JAX's sharded step is the one-device step on the global batch.
The port's processes each hold a contiguous slice of it, so every place
where samples couple is made global here, explicitly:

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

The step makes them active with :func:`data_parallel`; outside it (one
process, or no mesh) each is the identity, or the local draw.  The gather
assumes equal shards (the host pipeline pads the global batch to a
multiple of the process count), so no size crosses to the host.

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

# wall seconds and calls spent in the step's collectives; ``timed`` makes
# each call synchronise the device before and after, so that the seconds
# are the collective's own
stats = {"calls": 0, "seconds": 0.0}
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


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    if timed and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t)
    if timed and t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return t


def _gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    moved = x.movedim(dim, 0)
    b = moved.shape[0]
    out = torch.zeros((mesh.size * b,) + tuple(moved.shape[1:]), dtype=x.dtype, device=x.device)
    out[mesh.rank * b:(mesh.rank + 1) * b] = moved
    return _all_reduce(out).movedim(0, dim)


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
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone())


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
    if _ACTIVE.get() is None:
        return x
    if x.requires_grad:
        return _GlobalSum.apply(x)
    return _all_reduce(x.detach().clone())


def process_count() -> int:
    """The active mesh's size (1 without one)."""
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


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """The gradients summed over ``mesh``'s processes, through one flat
    buffer a dtype; the list itself without a mesh of more than one."""
    grads = list(grads)
    if mesh is None or mesh.size == 1 or not grads:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out
