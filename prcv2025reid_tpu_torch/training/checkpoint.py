"""Checkpoints with exact resume (counterpart of the JAX package's
``training/checkpoint.py``; the same layout and guarantees, written with
``torch.save``).

``<directory>/<name>/state.pt`` holds the training state as plain dicts of
tensors (``torch.load(..., weights_only=True)`` reads it): the model's
``state_dict`` (parameters and BN statistics), the optimizer state (the
update count, mu, nu, the plateau scale, the accumulation step and
buffer), the host step and seed, the clip's norm history and count, the
skip counter and the metric ring.  The train step's generators are seeded
from (seed, step), so they need no slot.  ``host_state.json`` beside it
holds the host-side state (epoch, best mAP, schedulers, sampler stream,
config) and the writer's ring shapes.

A save is staged in ``<name>.tmp``, and the sidecar, written last, is the
commit marker; a complete staging directory is swapped into place so that
at every instant one complete checkpoint exists under ``<name>``,
``<name>.old`` or ``<name>.tmp`` (``_recover_interrupted_swap`` reconciles
a crash between the renames).  ``block=False`` copies every tensor to the
host synchronously and writes in a background thread; its sidecar and swap
land in ``finalize_pending_saves``, which also raises what the thread
raised.  At most one save is in flight.

Several processes (a data-parallel run: the state is replicated): process
0 cleans the staging directory, writes the state and the sidecar and swaps
(the others write nothing), each step behind a barrier; the verdict of
``latest_checkpoint_exists`` is process 0's, broadcast (a split verdict on
shared storage would send some processes into a restore and the rest into
training); every process restores the replicated state itself.

Tensor parallel (a model sharded by ``parallel/tp.py``): every process
gathers each sharded leaf, and its moments, whole over its model group (a
collective, so all of them build the payload), and process 0 writes the
one-process layout; a restore slices each whole leaf to this process's
shard.  So a tensor-parallel checkpoint loads in one process, and a
one-process checkpoint resumes under tensor parallelism.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.parallel import tp
from prcv2025reid_tpu_torch.training.param_groups import OptState
from prcv2025reid_tpu_torch.training.train_step import TrainState
from prcv2025reid_tpu_torch.utils.distributed import (
    barrier,
    broadcast_one_to_all,
    is_main_process,
    process_count,
)

HOST_STATE_FILE = "host_state.json"
STATE_FILE = "state.pt"
RING_LEAVES = ("metric_ring", "grad_norm_hist")

# at most one async save in flight: (writer thread, its error box, staging
# dir, final dir, host_state)
_PENDING: list = []


def _default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _is_complete(path: str) -> bool:
    """A checkpoint dir is complete iff the sidecar exists: it is written
    only after the state file, so it doubles as the commit marker."""
    return os.path.exists(os.path.join(path, HOST_STATE_FILE)) and os.path.isfile(
        os.path.join(path, STATE_FILE))


def _swap_into_place(staging: str, path: str):
    """Atomically promote a COMPLETE staging dir to ``path``: the previous
    ``path`` is renamed aside before the staging rename and removed only
    after."""
    old = path + ".old"
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(staging, path)
    if os.path.isdir(old):
        shutil.rmtree(old)


def _recover_interrupted_swap(path: str):
    """Make ``path`` a complete checkpoint again after a crash mid-swap."""
    staging, old = path + ".tmp", path + ".old"
    if _is_complete(path):
        return
    if _is_complete(staging):  # newest durable state: finish the swap
        _swap_into_place(staging, path)
    elif _is_complete(old) and not os.path.exists(path):  # roll back
        os.rename(old, path)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    # a copy even on the CPU: the train step updates the live tensors in place
    return t.detach().to("cpu", copy=True)


def _state_payload(model: torch.nn.Module, state: TrainState) -> Dict[str, Any]:
    """What ``state.pt`` holds, every tensor copied to the host; a sharded
    model's leaves and moments whole (a collective over the model group)."""
    opt = state.opt_state
    return {
        "model": {k: _host_copy(v) for k, v in tp.full_state_dict(model).items()},
        "step": int(state.step),
        "seed": int(state.seed),
        "opt_state": {
            "count": _host_copy(opt.count),
            "mu": [_host_copy(t) for t in tp.full_list(model, opt.mu)],
            "nu": [_host_copy(t) for t in tp.full_list(model, opt.nu)],
            "plateau_scale": _host_copy(opt.plateau_scale),
            "mini_step": _host_copy(opt.mini_step),
            "acc": [_host_copy(t) for t in tp.full_list(model, opt.acc)],
        },
        "grad_norm_hist": _host_copy(state.grad_norm_hist),
        "grad_norm_count": _host_copy(state.grad_norm_count),
        "skipped_total": _host_copy(state.skipped_total),
        "metric_ring": _host_copy(state.metric_ring),
    }


def _write(payload: Dict[str, Any], staging: str, errors: List[BaseException]):
    """The background thread's write."""
    try:
        torch.save(payload, os.path.join(staging, STATE_FILE))
    except BaseException as e:  # handed to finalize_pending_saves, which raises it
        errors.append(e)


def _commit(staging: str, path: str, host_state: Dict[str, Any]):
    barrier("ckpt-commit")
    if is_main_process():
        with open(os.path.join(staging, HOST_STATE_FILE), "w") as f:
            json.dump(host_state, f, default=_default)
        _swap_into_place(staging, path)
    barrier("ckpt-swapped")


def finalize_pending_saves():
    """Block until the in-flight async save is written, then write its
    sidecar into the staging dir and swap it into place.  An exception of
    the background write is raised here; its staging dir stays incomplete,
    so the previous checkpoint keeps serving."""
    while _PENDING:
        thread, errors, staging, path, host_state = _PENDING.pop(0)
        if thread is not None:  # None: a process that writes nothing
            thread.join()
        if errors:
            raise errors[0]
        _commit(staging, path, host_state)


def save_checkpoint(directory: str, model: torch.nn.Module, state: TrainState,
                    host_state: Dict[str, Any], *, name: str = "latest", block: bool = True):
    """Write ``<directory>/<name>/`` with the training state and the host
    sidecar (see the module docstring); ``block=False`` returns after the
    copy to the host and leaves the write to a background thread."""
    finalize_pending_saves()  # order saves; at most one in flight
    path = os.path.abspath(os.path.join(directory, name))
    staging = path + ".tmp"
    main = is_main_process()
    if main and os.path.isdir(staging):
        shutil.rmtree(staging)
    barrier("ckpt-staging-clean")
    host_state = dict(host_state)
    # the writer's ring shapes: a reader with another steps_per_epoch or
    # clip window restores these leaves at the saved shapes, and stays
    # strict on every other shape
    host_state["ring_shapes"] = {leaf: list(getattr(state, leaf).shape) for leaf in RING_LEAVES}
    if not main:  # the state is replicated: process 0 writes it
        if tp.is_sharded(model):
            _state_payload(model, state)  # its gathers are collectives
        if block:
            _commit(staging, path, host_state)
        else:
            _PENDING.append((None, [], staging, path, host_state))
        return
    os.makedirs(staging)
    payload = _state_payload(model, state)
    if block:
        torch.save(payload, os.path.join(staging, STATE_FILE))
        _commit(staging, path, host_state)
        return
    errors: List[BaseException] = []
    thread = threading.Thread(target=_write, args=(payload, staging, errors),
                              name=f"checkpoint-{name}")
    thread.start()
    _PENDING.append((thread, errors, staging, path, host_state))


def _checked(name: str, saved: torch.Tensor, like: torch.Tensor, dev: torch.device,
             shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    want = tuple(like.shape) if shape is None else tuple(shape)
    if tuple(saved.shape) != want or saved.dtype != like.dtype:
        raise ValueError(f"checkpoint {name}: {tuple(saved.shape)} {saved.dtype}, expected "
                         f"{want} {like.dtype}")
    return saved.to(dev)


def _checked_list(name: str, saved: List[torch.Tensor], like: List[torch.Tensor],
                  dev: torch.device) -> List[torch.Tensor]:
    if len(saved) != len(like):
        raise ValueError(f"checkpoint {name}: {len(saved)} tensors, expected {len(like)}")
    return [_checked(f"{name}[{i}]", s, t, dev) for i, (s, t) in enumerate(zip(saved, like))]


def restore_checkpoint(directory: str, model: torch.nn.Module, state: TrainState, *,
                       name: str = "latest",
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint written by ``save_checkpoint``: the model's
    parameters and BN statistics are copied into ``model`` in place, and
    a TrainState shaped like ``state`` (the template) is returned with the
    host sidecar.  Its tensors land on ``device`` (default: the model's),
    whatever device wrote them.  Every shape and dtype must match the
    template's, except the ring leaves, which take the writer's shapes as
    the sidecar records them."""
    finalize_pending_saves()  # never read past an in-flight write
    path = os.path.abspath(os.path.join(directory, name))
    if is_main_process():
        _recover_interrupted_swap(path)
    barrier("ckpt-recovered")
    if not is_main_process():
        _await_visible(path)
    with open(os.path.join(path, HOST_STATE_FILE)) as f:
        host_state = json.load(f)
    dev = torch.device(device) if device is not None else model.null_tokens.device
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=dev, weights_only=True)
    live = model.state_dict()
    if set(saved["model"]) != set(live):
        raise ValueError(
            f"checkpoint model keys differ: missing {sorted(set(live) - set(saved['model']))[:8]}, "
            f"unknown {sorted(set(saved['model']) - set(live))[:8]}")
    with torch.no_grad():
        for k, t in live.items():
            whole = saved["model"][k]
            t.copy_(_checked(f"model/{k}", tp.local_shard(model, k, whole), t, t.device))
    ring_shapes = host_state.get("ring_shapes") or {}
    rings = {leaf: _checked(leaf, saved[leaf], getattr(state, leaf), dev,
                            ring_shapes.get(leaf)) for leaf in RING_LEAVES}
    so, opt = saved["opt_state"], state.opt_state
    restored = state.replace(
        step=int(saved["step"]), seed=int(saved["seed"]),
        opt_state=OptState(
            count=_checked("opt_state/count", so["count"], opt.count, dev),
            mu=_checked_list("opt_state/mu", tp.local_list(model, so["mu"]), opt.mu, dev),
            nu=_checked_list("opt_state/nu", tp.local_list(model, so["nu"]), opt.nu, dev),
            plateau_scale=_checked("opt_state/plateau_scale", so["plateau_scale"],
                                   opt.plateau_scale, dev),
            mini_step=_checked("opt_state/mini_step", so["mini_step"], opt.mini_step, dev),
            acc=_checked_list("opt_state/acc", tp.local_list(model, so["acc"]), opt.acc, dev)),
        grad_norm_count=_checked("grad_norm_count", saved["grad_norm_count"],
                                 state.grad_norm_count, dev),
        skipped_total=_checked("skipped_total", saved["skipped_total"], state.skipped_total, dev),
        **rings)
    return restored, host_state


def _await_visible(path: str, timeout: float = 60.0) -> None:
    """On a process other than 0: wait (bounded) until process 0's
    checkpoint is visible here, as a shared filesystem may lag; on expiry
    the read that follows raises the informative error."""
    deadline = time.monotonic() + timeout
    while not _is_complete(path) and time.monotonic() < deadline:
        time.sleep(0.5)


def latest_checkpoint_exists(directory: str, name: str = "latest") -> bool:
    path = os.path.abspath(os.path.join(directory, name))
    try:
        if is_main_process():
            _recover_interrupted_swap(path)
    except OSError:
        pass
    barrier("ckpt-exists")
    if process_count() == 1:
        return _is_complete(path)
    # process 0 is the authority: every process takes its verdict
    verdict = np.asarray(1 if is_main_process() and _is_complete(path) else 0, np.int64)
    exists = bool(broadcast_one_to_all(verdict))
    if exists and not is_main_process():
        _await_visible(path)
    return exists
