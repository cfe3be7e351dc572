"""Multi-process runtime glue (counterpart of the JAX package's
``utils/distributed.py``), over a ``torch.distributed`` process group with
one device a process.

- :func:`initialize_from_config`: ``torch.distributed.init_process_group``
  driven by ``TrainingConfig`` (JAX's ``off`` / ``auto`` / ``on`` modes and
  flags).  It must run before the first device use; the command lines call
  it first.
- :func:`is_main_process`: the process that writes the host-side artifacts
  (histories, TensorBoard files, checkpoints, the gallery cache).
- :func:`barrier`: a cross-process sync point.
- :func:`fetch_global`: this process's rows of a row-sharded tensor -> the
  global numpy array, on every process.
- :func:`broadcast_one_to_all`: process 0's numpy array on every process.

The backend is NCCL when each process has a CUDA device of its own and gloo
on the CPU.  Processes that share one card pass ``backend="gloo"``
explicitly (NCCL refuses two ranks on one device).  Every collective here is
an ``all_reduce`` or a ``broadcast``: the two collectives that gloo runs on
CUDA tensors as well as on the CPU; a gather is an all-reduce into a zeroed
buffer in which each process fills its own rows.  A collective that refuses
a tensor raises: nothing moves to the CPU in its place.

With no group, or a group of one, every helper is the single-process
identity.  No torch import at module level: the host pipeline's workers,
which import the data modules, stay free of it.
"""
from __future__ import annotations

import atexit
import logging
import os
import sys
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

# set by initialize_from_config, so a second call never initializes again
_INITIALIZED = False

# the environment of a managed launcher, where the coordinator is
# discoverable without flags: COORDINATOR_ADDRESS (JAX's name, forwarded as
# tcp://), MASTER_ADDR (torchrun's; init_process_group reads it, with
# MASTER_PORT, RANK and WORLD_SIZE, through env://)
_AUTO_ENV_VARS = ("COORDINATOR_ADDRESS", "MASTER_ADDR")


def _dist():
    """``torch.distributed`` when a group of more than one process is up,
    else None."""
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return None
    return dist if dist.get_world_size() > 1 else None


def initialize_from_config(config, backend: Optional[str] = None) -> bool:
    """Join the process group per ``config.distributed``.

    Modes:
      - ``"off"`` (default): never initialize; one process.
      - ``"auto"``: initialize only when a coordinator is discoverable:
        ``config.coordinator_address`` is set or the environment names one.
      - ``"on"``: always initialize (``--coordinator_address=host:port
        --num_processes=N --process_id=R`` on each process).

    ``coordinator_address`` is ``host:port`` (a TCP store on process 0) or
    an init method URL such as ``file:///shared/rendezvous``.  ``backend``:
    None picks NCCL when CUDA is available, else gloo; with NCCL each process
    takes the device ``process_id % device_count``.  Returns True iff this
    call initialized the group.
    """
    mode = getattr(config, "distributed", "off")
    if mode == "off":
        return False
    global _INITIALIZED
    if _INITIALIZED:
        return False
    coord = getattr(config, "coordinator_address", None)
    has_env = any(os.environ.get(v) for v in _AUTO_ENV_VARS)
    if mode == "auto" and not (coord or has_env):
        logger.info("--distributed=auto: no coordinator discoverable (flags/env) — "
                    "running single-process")
        return False

    import torch
    import torch.distributed as dist

    if not coord and os.environ.get("COORDINATOR_ADDRESS"):
        # JAX's trigger name, which torch's env:// discovery does not read
        coord = os.environ["COORDINATOR_ADDRESS"]
    init_method = (coord if "://" in coord else f"tcp://{coord}") if coord else "env://"
    kwargs = {"init_method": init_method}
    n = getattr(config, "num_processes", None)
    if n is not None:
        kwargs["world_size"] = int(n)
    r = getattr(config, "process_id", None)
    if r is not None:
        kwargs["rank"] = int(r)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, **kwargs)
    _INITIALIZED = True
    # a group left up at exit aborts the process in gloo's threads
    atexit.register(_destroy_group)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    logger.info("torch.distributed initialized: %s, backend %s, process %s of %s", init_method,
                backend, kwargs.get("rank", "(env)"), kwargs.get("world_size", "(env)"))
    return True


def _destroy_group() -> None:
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


def process_count() -> int:
    dist = _dist()
    return 1 if dist is None else dist.get_world_size()


def is_main_process() -> bool:
    """True on the process that owns the shared host-side artifacts: whole-
    file rewrites that N writers on shared storage would race on."""
    return process_index() == 0


def _comm_device():
    """Where a host array goes for a collective: the CPU under gloo, this
    process's CUDA device under NCCL."""
    import torch

    dist = _dist()
    if dist is not None and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "") -> None:
    """Block until every process reaches this point (no-op in one process).
    ``name`` documents the sync point; every process must pass the same ones
    in the same order."""
    dist = _dist()
    if dist is None:
        return
    if dist.get_backend() == "nccl":
        import torch

        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def gather_rows(t, dim: int = 0, group=None):
    """Every process's ``t`` concatenated along ``dim`` in process order, on
    every process of ``group`` (None: the whole group): an all-reduce of a
    zeroed buffer in which each process writes its own rows.  Each process
    may hold a different number of rows.  No gradient
    (``parallel/collectives.py`` has the differentiable one)."""
    import torch

    dist = _dist()
    if dist is None or dist.get_world_size(group) == 1:
        return t
    if t.dtype == torch.bool:
        return gather_rows(t.to(torch.uint8), dim, group).bool()
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    sizes = torch.zeros(world, dtype=torch.int64, device=t.device)
    sizes[rank] = t.shape[dim]
    dist.all_reduce(sizes, group=group)
    sizes = sizes.tolist()
    moved = t.movedim(dim, 0)
    out = torch.zeros((sum(sizes),) + tuple(moved.shape[1:]), dtype=t.dtype, device=t.device)
    start = sum(sizes[:rank])
    out[start:start + sizes[rank]] = moved
    dist.all_reduce(out, group=group)
    return out.movedim(0, dim)


def fetch_global(x, group=None) -> np.ndarray:
    """``np.asarray`` of a row-sharded value: this process's rows (a tensor
    or an array) in, the global array in process order over ``group``
    (None: the whole group) out, on every process.  One process: the value
    itself as numpy."""
    import torch

    if _dist() is None:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.device.type == "cpu":
        t = t.to(_comm_device())
    return gather_rows(t.detach(), group=group).cpu().numpy()


def broadcast_one_to_all(x) -> np.ndarray:
    """Process 0's numpy array on every process (each passes one of the same
    shape and dtype; the others' values are ignored).  One process: the
    array itself."""
    import torch

    dist = _dist()
    arr = np.asarray(x)
    if dist is None:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy().reshape(arr.shape)
