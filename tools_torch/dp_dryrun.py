#!/usr/bin/env python3
"""Data- and tensor-parallel dry run: two processes in a
``torch.distributed`` gloo group, each with one device, through the port's
multi-process runtime (the counterpart of the JAX package's
``__graft_entry__.py::_two_process_leg``).

    python3 tools_torch/dp_dryrun.py --cpu [--legs runtime,step,ranking,tp]
    python3 tools_torch/dp_dryrun.py [--legs step,ranking,tp] [--set key=value ...]

It launches two copies of itself (a ``file://`` rendezvous in ``--out``,
each under TIMEOUT seconds) and checks what they return:

- ``runtime``: the barrier, ``is_main_process``, ``fetch_global`` of each
  process's rows, ``broadcast_one_to_all``, the gallery cache's authority
  (process 0's save is every process's hit; a miss everywhere; another
  process's save writes nothing) and the checkpoint verdict (process 0
  writes; ``latest_checkpoint_exists`` is True, and False for a missing
  name, on every process; every process restores the same state);
- ``step``: STEPS global-batch train steps (``make_train_step(...,
  mesh=create_mesh(cfg))`` on each process's slice of a seeded P x K batch)
  against the one-process step on the whole batch in this process, from the
  same ``init_params`` state: the metrics within RTOL, the processes'
  parameters and optimizer state the same bits; #1's launches a step, each
  process's device ms a step (CUDA events, on the card) and the ms its
  all-reduces took;
- ``ranking``: ``sharded_topk`` of the queries against a gallery split over
  the processes, against ``stable_topk`` over the whole gallery in this
  process (the indices exactly).  The features are small integers, so
  every product is exact whatever the shard's shape, and ties are many;
- ``tp``: tensor parallelism on the ``(1, 2)`` mesh (``parallel/tp.py``):
  STEPS train steps from the same ``init_params`` state, sharded by
  ``shard_state``, on the whole global batch, against the one-process step:
  the metrics within RTOL; step 1's gradients, gathered whole, against the
  one process's (on the CPU every leaf within TP_TOL; on the card each LR
  group's cosine >= GRAD_COS); the replicated leaves the same bits on both
  processes; the gathered sharded leaves against the one-process state (on
  the CPU within TP_TOL; on the card the frozen ones bit for bit, and the
  trained ones' update cosine printed beside a rounding control: the same
  one-process steps with the other attention core, which move the update
  by rounding alone); each sharded leaf 1/2 of the whole; on the card #1's
  launches a step and their head counts, the device ms a step, the peak
  memory above what was allocated before the model (and one process's) and
  the model all-reduces' count and ms; then the fused-stream eval embed
  (``use_pallas_attention``, ``use_fused_mlp``, ``use_fused_resln``) of a
  seeded uint8 vis batch against one process (min-cosine >= MIN_COSINE),
  and on the card its launches of #1, #8 and #9 a process.

On the card: full ViT-B/16 width (``TrainingConfig()``, bf16,
``use_pallas_attention``, drop-path 0.1), the 8 x 4 batch, 1,024 queries
against 45,113 x 512, top 100, an eval batch of 128; the processes share one
card, so the group is gloo's (NCCL wants a device a process).  ``--cpu``:
the tiny widths in f32, a 4 x 2 batch, 5 x 37 x 8, top 5, an eval batch of
8.  ``--set key=value`` overrides
config fields.  The last line of the output is a JSON summary; the exit
code is 0 only if every check passed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the tests' tiny widths (tests/conftest.py TINY_BASE), f32
TINY = dict(gradient_accumulation_steps=1, vision_hidden_dim=64, vision_layers=2,
            vision_heads=4, vision_mlp_dim=128, text_hidden_dim=32, text_layers=2,
            text_heads=4, text_mlp_dim=64, text_vocab_size=100, text_context_length=16,
            image_size=32, fusion_dim=32, sdm_semantic_dim=32, sdm_num_heads=4,
            fusion_num_heads=4, compute_dtype="float32", num_epochs=4, warmup_epochs=1)
NPROC, STEPS, SEED, DROP_PATH, TIMEOUT = 2, 3, 0, 0.1, 420
STEPS_PER_EPOCH = 10
SDM_WEIGHT, SDM_TAU = 0.1, 0.18
LEGS = ("runtime", "step", "ranking")  # and "tp", asked for by name
# (card, --cpu): the P x K batch, the metrics' bar against one process (bf16
# summed in another order on the card; f32 on the CPU), the ranking's
# queries, gallery rows, width and depth, and the tp leg's eval batch
SIZES = {"pk": ((8, 4), (4, 2)), "rtol": (2e-3, 1e-4), "ranking": ((1024, 45113, 512, 100),
                                                                   (5, 37, 8, 5)),
         "eval_batch": (128, 8)}
# the tp leg: the gathered leaves and gradients against one process on the
# CPU (f32, JAX's bound for its TP step parameters), a trainable group's
# gradient cosine on the card (bf16; chip_smoke.py's bar for one group's
# gradient between two paths), the embed's min-cosine.  The state after the
# steps has no bar on the card: Adam moves a leaf whose gradient is at
# rounding level by a whole step in a random direction, on any path
TP_TOL, GRAD_COS, MIN_COSINE = (2e-4, 2e-5), 0.99, 0.999
EVAL_FLAGS = dict(use_pallas_attention=True, use_fused_mlp=True, use_fused_resln=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="tiny widths on the CPU")
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "dp_dryrun"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def size(args, name):
    return SIZES[name][1 if args.cpu else 0]


def build_config(args):
    from prcv2025reid_tpu_torch.configs import TrainingConfig, apply_cli_overrides

    base = dict(TINY) if args.cpu else dict(use_pallas_attention=True)
    cfg = TrainingConfig(**base, drop_path=DROP_PATH, seed=SEED)
    return apply_cli_overrides(cfg, [f"--{kv}" for kv in args.set])


def global_batch(cfg, P: int, K: int, seed: int):
    """A seeded P x K global batch as the pipeline collates it (uint8 images,
    some nir / cp / caption slots missing, captions BOS, words, EOT)."""
    rng = np.random.default_rng(seed)
    B, Mv, S = P * K, len(cfg.vision_modalities), cfg.image_size
    ctx, vocab = cfg.text_context_length, cfg.text_vocab_size
    tokens = np.zeros((B, ctx), np.int32)
    for i in range(B):
        n = int(rng.integers(3, ctx + 1))
        tokens[i, 0], tokens[i, n - 1] = vocab - 2, vocab - 1
        tokens[i, 1:n - 1] = rng.integers(1, vocab - 2, n - 2)
    image_mask = (rng.random((B, Mv)) > 0.15).astype(np.float32)
    image_mask[:, 0] = 1.0
    text_mask = (rng.random(B) > 0.15).astype(np.float32)
    labels = np.repeat(np.arange(P), K).astype(np.int32)
    return dict(images=rng.integers(0, 256, (B, Mv, S, S, 3), dtype=np.uint8),
                image_mask=image_mask, text_tokens=tokens, text_mask=text_mask,
                labels=labels, pids=labels + 1000)


def ranking_data(Q: int, G: int, D: int):
    """Small-integer queries and gallery: every product and sum exact in f32."""
    rng = np.random.default_rng(SEED)
    return (rng.integers(-3, 4, (Q, D)).astype(np.float32),
            rng.integers(-3, 4, (G, D)).astype(np.float32))


def _digest(model, state) -> str:
    """sha256 of the parameters, BN statistics and optimizer state's bits."""
    import torch

    opt = state.opt_state
    h = hashlib.sha256()
    for t in [v for _, v in sorted(model.state_dict().items())] + [opt.count, *opt.mu, *opt.nu]:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


_PARAMS: dict = {}  # the init_params draw of a config, which the eval flags do not change


def _model(args, cfg, dev):
    from prcv2025reid_tpu_torch import build_model, init_params
    from prcv2025reid_tpu_torch.configs import TrainingConfig

    key = cfg.replace(**{k: getattr(TrainingConfig(), k) for k in EVAL_FLAGS}).to_json()
    if key not in _PARAMS:
        _PARAMS[key] = init_params(cfg, size(args, "pk")[0], SEED, perturb=True)
    return build_model(cfg, _PARAMS[key], device=dev)


def run_steps(args, cfg, dev, mesh, save=None, snapshot=None):
    """The step leg on this process: (per-step records, model, state).
    ``snapshot``: a dict that receives the initial state dict (``init``)
    and step 1's gradients by name (``grads``) on the host."""
    import torch

    from prcv2025reid_tpu_torch import init_train_state, make_train_step
    from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha
    from prcv2025reid_tpu_torch.parallel import collectives
    from prcv2025reid_tpu_torch.parallel.mesh import shard_batch

    P, K = size(args, "pk")
    model = _model(args, cfg, dev)
    state = init_train_state(model, cfg, STEPS_PER_EPOCH, seed=SEED + 1)
    step = make_train_step(model, cfg, STEPS_PER_EPOCH, mesh=mesh)
    records = []
    for s in range(STEPS):
        b = global_batch(cfg, P, K, seed=100 + s)
        if mesh is not None and mesh.size > 1:
            b = shard_batch(b, mesh)
        if snapshot is not None and s == 0:
            snapshot["init"] = {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()}
            names = [n for n, p in model.named_parameters() if p.requires_grad]
            grads = step.grads(state, b, SDM_WEIGHT, SDM_TAU, True)[-1]
            snapshot["grads"] = {n: g.cpu() for n, g in zip(names, grads)}
        launches0 = fused_mha.launches
        calls0, secs0 = collectives.stats["calls"], collectives.stats["seconds"]
        collectives.timed = dev.type == "cuda"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        state, m = step(state, b, SDM_WEIGHT, SDM_TAU, enable_modality_dropout=True)
        device_ms = None
        if dev.type == "cuda":
            end.record()
            torch.cuda.synchronize(dev)
            device_ms = start.elapsed_time(end)
        collectives.timed = False
        records.append({"metrics": {k: float(v) for k, v in m.items()},
                        "fused_mha": fused_mha.launches - launches0, "device_ms": device_ms,
                        "wall_ms": (time.perf_counter() - t0) * 1e3,
                        "collective_calls": collectives.stats["calls"] - calls0,
                        "collective_ms": (collectives.stats["seconds"] - secs0) * 1e3})
        if save is not None and s == 0:
            _save_state(model, state, save + "_step1.pt")
    if save is not None:
        _save_state(model, state, save + ".pt")
    return records, model, state


def _save_state(model, state, path):
    import torch

    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "mu": [t.detach().cpu() for t in state.opt_state.mu],
                "nu": [t.detach().cpu() for t in state.opt_state.nu],
                "count": state.opt_state.count.detach().cpu()}, path)


def _peak_from(dev):
    """The device memory allocated now (the peak counter restarts here)."""
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_gb(dev, base):
    """GB of device memory at the peak since ``_peak_from`` above what was
    allocated then (None on the CPU)."""
    import torch

    return None if base is None else (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def eval_batch(args, cfg):
    """The tp leg's seeded uint8 vis batch: (images, image_mask)."""
    rng = np.random.default_rng(SEED + 7)
    B, Mv, S = size(args, "eval_batch"), len(cfg.vision_modalities), cfg.image_size
    return (rng.integers(0, 256, (B, Mv, S, S, 3), dtype=np.uint8),
            np.ones((B, Mv), np.float32))


def embed_once(args, cfg, dev, mesh=None):
    """The fused-stream eval embed of :func:`eval_batch` (sharded over
    ``mesh``'s model axis when it has one): (features, launches a wrapper)."""
    from prcv2025reid_tpu_torch import make_combo_embed_step
    from prcv2025reid_tpu_torch.ops.library import launch_counts
    from prcv2025reid_tpu_torch.parallel import tp

    ecfg = cfg.replace(**EVAL_FLAGS)
    model = _model(args, ecfg, dev)
    tp.shard_variables(model, mesh)
    images, mask = eval_batch(args, ecfg)
    before = launch_counts()
    feats = make_combo_embed_step(model, ("vis",))(images, mask).cpu().numpy()
    after = launch_counts()
    return feats, {k: after[k] - before[k] for k in after}


def tp_leg(args, cfg, dev, mesh, rank):
    """The tp leg on this process (see the module docstring): its readings;
    rank 0 also writes the gathered sharded leaves."""
    import torch

    from prcv2025reid_tpu_torch import init_train_state, make_train_step
    from prcv2025reid_tpu_torch.ops import fused_attention
    from prcv2025reid_tpu_torch.parallel import collectives, tp

    P, K = size(args, "pk")
    base = _peak_from(dev)
    model = _model(args, cfg, dev)
    state = init_train_state(model, cfg, STEPS_PER_EPOCH, seed=SEED + 1)
    whole = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = tp.shard_state(model, state, mesh)
    step = make_train_step(model, cfg, STEPS_PER_EPOCH, mesh=mesh)
    plan = model.tp_plan
    names = tp.trainable_names(model)
    grads = tp.full_list(model, step.grads(state, global_batch(cfg, P, K, seed=100), SDM_WEIGHT,
                                           SDM_TAU, True)[-1])
    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    proj = [k for k in local if any(n in tp.path_keys(k) for n in ("q_proj", "k_proj", "v_proj",
                                                                   "out_proj", "fc1", "fc2"))
            and k.startswith("encoder.")]
    out = {"plan_leaves": len(plan), "shapes": {k: [local[k], whole[k]] for k in plan},
           "proj_numel": [sum(math.prod(local[k]) for k in proj),
                          sum(math.prod(whole[k]) for k in proj)],
           "sharded_numel": [sum(math.prod(local[k]) for k in plan),
                             sum(math.prod(whole[k]) for k in plan)]}
    heads = []
    launch = fused_attention.mha_launch

    def counted(q, *rest):  # the kernel's launch, its head count noted
        heads.append(q.shape[1])
        return launch(q, *rest)

    fused_attention.mha_launch = counted
    records = []
    try:
        for s in range(STEPS):
            b = global_batch(cfg, P, K, seed=100 + s)  # a data axis of one: the whole batch
            launches0, heads0 = fused_attention.fused_mha.launches, len(heads)
            calls0, secs0 = collectives.model_stats["calls"], collectives.model_stats["seconds"]
            collectives.timed = dev.type == "cuda"
            device_ms = None
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            state, m = step(state, b, SDM_WEIGHT, SDM_TAU, enable_modality_dropout=True)
            if dev.type == "cuda":
                end.record()
                torch.cuda.synchronize(dev)
                device_ms = start.elapsed_time(end)
            collectives.timed = False
            records.append({"metrics": {k: float(v) for k, v in m.items()},
                            "fused_mha": fused_attention.fused_mha.launches - launches0,
                            "heads": sorted(set(heads[heads0:])), "device_ms": device_ms,
                            "model_calls": collectives.model_stats["calls"] - calls0,
                            "model_ms": (collectives.model_stats["seconds"] - secs0) * 1e3})
    finally:
        fused_attention.mha_launch = launch
    out["steps"] = records
    out["peak_gb"] = _peak_gb(dev, base)
    opt = state.opt_state
    h = hashlib.sha256()  # the replicated leaves' bits
    replicated = [v for k, v in sorted(model.state_dict().items()) if k not in plan] + [
        t for n, pair in zip(names, zip(opt.mu, opt.nu)) if n not in plan for t in pair]
    for t in replicated + [opt.count]:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    out["replicated_digest"] = h.hexdigest()
    full = tp.full_state_dict(model)
    mu, nu = tp.full_list(model, opt.mu), tp.full_list(model, opt.nu)
    if rank == 0:
        torch.save({"model": {k: full[k].cpu() for k in plan},
                    "mu": {n: t.cpu() for n, t in zip(names, mu) if n in plan},
                    "nu": {n: t.cpu() for n, t in zip(names, nu) if n in plan},
                    "grads": {n: t.cpu() for n, t in zip(names, grads)}},
                   os.path.join(args.out, "tp_state.pt"))
    del model, state, step, full, mu, nu, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    feats, out["embed_launches"] = embed_once(args, cfg, dev, mesh)
    np.save(os.path.join(args.out, f"tp_rank{rank}_embed.npy"), feats)
    return out


def runtime_leg(out_dir, model, state, rank, world):
    """Barrier, fetch_global, broadcast, cache authority, checkpoint verdict."""
    import torch

    from prcv2025reid_tpu_torch.evaluation.protocol import GalleryCache
    from prcv2025reid_tpu_torch.training import checkpoint
    from prcv2025reid_tpu_torch.utils import distributed

    checks = {}
    distributed.barrier("start")
    checks["is_main"] = distributed.is_main_process() == (rank == 0)
    full = np.arange(world * 6, dtype=np.float32).reshape(world * 2, 3)
    mine = torch.from_numpy(full[rank * 2:(rank + 1) * 2])
    checks["fetch_global"] = bool(np.array_equal(distributed.fetch_global(mine), full))
    sent = np.arange(5, dtype=np.int64) * (7 if rank == 0 else -1)
    checks["broadcast"] = bool(np.array_equal(distributed.broadcast_one_to_all(sent),
                                              np.arange(5) * 7))
    cache = GalleryCache(os.path.join(out_dir, "cache"), "mp")
    feats = np.arange(12, dtype=np.float32).reshape(4, 3)
    pids = np.arange(4, dtype=np.int64)
    if rank == 0:
        cache.save([1, 2, 3, 4], feats, pids)
    distributed.barrier("saved")
    got = cache.load([1, 2, 3, 4])
    checks["cache_hit"] = got is not None and bool(np.array_equal(got[0], feats)) and bool(
        np.array_equal(got[1], pids))
    checks["cache_miss"] = cache.load([9, 9]) is None
    if rank == 1:
        cache.save([7, 7], feats, pids)  # not process 0: writes nothing
    distributed.barrier("rank1-save")
    checks["cache_one_writer"] = cache.load([7, 7]) is None
    ck = os.path.join(out_dir, "ckpt")
    checks["ckpt_absent"] = checkpoint.latest_checkpoint_exists(ck) is False
    checkpoint.save_checkpoint(ck, model, state, {"epoch": 1})
    checks["ckpt_exists"] = checkpoint.latest_checkpoint_exists(ck) is True
    checks["ckpt_missing_name"] = checkpoint.latest_checkpoint_exists(ck, name="nope") is False
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    restored, host = checkpoint.restore_checkpoint(ck, model, state)
    checks["ckpt_restored"] = host["epoch"] == 1 and all(
        torch.equal(v, before[k]) for k, v in model.state_dict().items()) and \
        restored.step == state.step
    checks["ckpt_one_writer"] = sorted(os.listdir(ck)) == ["latest"]
    distributed.barrier("done")
    return checks


def child(args) -> int:
    import torch

    from prcv2025reid_tpu_torch.parallel.mesh import create_mesh
    from prcv2025reid_tpu_torch.utils.distributed import initialize_from_config

    rank, legs = args.rank, args.legs.split(",")
    group = argparse.Namespace(distributed="on", num_processes=NPROC, process_id=rank,
                               coordinator_address=f"file://{os.path.join(args.out, 'rdv')}")
    initialize_from_config(group, backend="gloo")
    dev = torch.device("cpu" if args.cpu else "cuda")
    if args.cpu:
        torch.set_num_threads(1)  # tiny shapes: threads would contend with the other process
    cfg = build_config(args)
    mesh = create_mesh(cfg)
    result = {"rank": rank, "world": mesh.size}
    model = state = None
    if "step" in legs:
        result["steps"], model, state = run_steps(args, cfg, dev, mesh)
        result["digest"] = _digest(model, state)
    if "tp" in legs:
        # a second mesh over the same group: (1, 2), the model axis over both
        result["tp"] = tp_leg(args, cfg, dev, create_mesh(model_axis_size=NPROC), rank)
    if "ranking" in legs:
        from prcv2025reid_tpu_torch.parallel.ranking import sharded_topk

        Q, G, D, k = size(args, "ranking")
        q, g = ranking_data(Q, G, D)
        t0 = time.perf_counter()
        _, idx = sharded_topk(q, g, k, mesh, device=dev)
        result["ranking_ms"] = (time.perf_counter() - t0) * 1e3
        np.save(os.path.join(args.out, f"rank{rank}_topk.npy"), idx.cpu().numpy())
    if "runtime" in legs:
        if model is None:
            from prcv2025reid_tpu_torch import init_train_state

            model = _model(args, cfg, dev)
            state = init_train_state(model, cfg, STEPS_PER_EPOCH, seed=SEED + 1)
        result["runtime"] = runtime_leg(args.out, model, state, rank, mesh.size)
    result["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "prcv2025reid_tpu"))
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()
    return 0


def _run_children(argv, out):
    """The two processes, each this tool with ``--rank``: -> (exit codes,
    outputs), or None past TIMEOUT (both killed)."""
    cmd = [sys.executable, os.path.abspath(__file__), *argv, f"--out={out}"]
    procs = [subprocess.Popen(cmd + [f"--rank={r}"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(NPROC)]
    deadline = time.monotonic() + TIMEOUT
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        return None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def launch(argv) -> dict:
    """Run the two processes with ``argv`` (this tool's flags) and check
    them against this process; -> the summary (``ok``, ``failures`` and the
    readings)."""
    import torch

    argv = [a for a in argv if not a.startswith("--rank=")]
    args = build_parser().parse_args(argv)
    args.out = os.path.abspath(args.out)  # the rendezvous is a file:// URL
    legs = args.legs.split(",")
    os.makedirs(args.out, exist_ok=True)
    for name in os.listdir(args.out):  # the rendezvous file must be new
        p = os.path.join(args.out, name)
        shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":  # built once here, loaded by the processes
        from prcv2025reid_tpu_torch.ops import _kernels

        _kernels.build_all()
    cfg = build_config(args)
    summary = {"nproc": NPROC, "legs": legs, "device": str(dev), "failures": []}
    fail = summary["failures"].append

    ref = None
    if "step" in legs or "tp" in legs:  # the one-process step on the global batch, first
        t0 = time.perf_counter()
        snap = {}
        base = _peak_from(dev)
        ref, model, state = run_steps(args, cfg, dev, None, snapshot=snap)
        summary["single_peak_gb"] = _peak_gb(dev, base)
        if "tp" in legs:  # the one-process leaves, a rounding control, the embed
            names = [n for n, p in model.named_parameters() if p.requires_grad]
            ref_state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                         "mu": dict(zip(names, (t.cpu() for t in state.opt_state.mu))),
                         "nu": dict(zip(names, (t.cpu() for t in state.opt_state.nu))),
                         **snap}
            del model, state
            _, model, _ = run_steps(args, cfg.replace(
                use_pallas_attention=not cfg.use_pallas_attention), dev, None)
            ref_state["control"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            ref_embed, ref_launches = embed_once(args, cfg, dev)
        summary["single_s"] = time.perf_counter() - t0
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    done = _run_children(argv, args.out)
    summary["children_s"] = time.perf_counter() - t0
    if done is None:
        fail(f"the processes did not finish within {TIMEOUT} s (deadlock?)")
    else:
        for r, (code, out) in enumerate(zip(*done)):
            if code != 0:
                fail(f"process {r} exited {code}:\n{out[-4000:]}")
    if summary["failures"]:
        summary["ok"] = False
        return summary
    ranks = []
    for r in range(NPROC):
        with open(os.path.join(args.out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    # the processes import the port only
    summary["foreign_modules"] = sorted({m for x in ranks for m in x["foreign_modules"]})
    if summary["foreign_modules"]:
        fail(f"the processes imported {summary['foreign_modules']}")

    if "tp" in legs:
        summary["tp"] = check_tp(args, cfg, dev, [x["tp"] for x in ranks], ref, ref_state,
                                 ref_embed, ref_launches, fail)
    if "step" in legs:
        rtol = size(args, "rtol")
        summary["ranks_bit_identical"] = len({x["digest"] for x in ranks}) == 1
        if not summary["ranks_bit_identical"]:
            fail("the processes' parameters / optimizer state differ")
        rows = []
        for s, want in enumerate(ref):
            got = [x["steps"][s] for x in ranks]
            if any(x["metrics"] != got[0]["metrics"] for x in got):
                fail(f"step {s + 1}: the processes' metrics differ")
            worst = max(abs(got[0]["metrics"][k] - v) / max(abs(v), 1e-6)
                        for k, v in want["metrics"].items())
            losses = ("total_loss", "ce_loss", "sdm_loss")
            rows.append({"step": s + 1, "single": {k: want["metrics"][k] for k in losses},
                         "multi": {k: got[0]["metrics"][k] for k in losses}, "max_rel": worst,
                         "fused_mha": [x["fused_mha"] for x in got],
                         "device_ms": [x["device_ms"] for x in got],
                         "collective_ms": [x["collective_ms"] for x in got],
                         "collective_calls": [x["collective_calls"] for x in got],
                         "single_fused_mha": want["fused_mha"],
                         "single_device_ms": want["device_ms"]})
            if worst > rtol:
                fail(f"step {s + 1}: metrics {worst:.3e} from the one-process step (> {rtol})")
        summary["steps"] = rows
    if "ranking" in legs:
        from prcv2025reid_tpu_torch.evaluation.rerank import stable_topk
        from prcv2025reid_tpu_torch.evaluation.similarity import similarity

        Q, G, D, k = size(args, "ranking")
        q, g = ranking_data(Q, G, D)
        got = [np.load(os.path.join(args.out, f"rank{r}_topk.npy")) for r in range(NPROC)]
        _, want = stable_topk(similarity(torch.as_tensor(q, device=dev),
                                         torch.as_tensor(g, device=dev)), k)
        want = want.cpu().numpy()
        summary["ranking"] = {"queries": Q, "gallery": G, "dim": D, "topk": k,
                              "indices_equal": [bool(np.array_equal(x, want)) for x in got],
                              "rows_differing": int((got[0] != want).any(1).sum()),
                              "ms": [x["ranking_ms"] for x in ranks]}
        if not all(summary["ranking"]["indices_equal"]):
            fail(f"sharded_topk's indices differ from stable_topk over the whole gallery "
                 f"({summary['ranking']['rows_differing']} rows)")
    if "runtime" in legs:
        summary["runtime"] = [x["runtime"] for x in ranks]
        bad = sorted({k for x in ranks for k, v in x["runtime"].items() if not v})
        if bad:
            fail(f"runtime checks failed: {bad}")
    summary["ok"] = not summary["failures"]
    return summary


def _over_tol(got, want) -> float:
    """max |got - want| / (atol + rtol |want|) at TP_TOL: above 1, out of it."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (TP_TOL[1] + TP_TOL[0] * want.abs())).max().item()


def _cos(a, b) -> float:
    import torch

    return torch.nn.functional.cosine_similarity(a, b, dim=0).item()


def check_tp(args, cfg, dev, got, ref, ref_state, ref_embed, ref_launches, fail) -> dict:
    """The tp leg's checks against the one-process readings; -> its
    readings for the summary."""
    import torch

    rtol = size(args, "rtol")
    L = cfg.vision_layers
    heads = cfg.vision_heads // NPROC
    out = {"plan_leaves": got[0]["plan_leaves"], "peak_gb": [x["peak_gb"] for x in got],
           "proj_numel": got[0]["proj_numel"], "sharded_numel": got[0]["sharded_numel"]}
    # each sharded leaf 1/NPROC of the whole along one dim
    uneven = [k for k, (lo, wh) in got[0]["shapes"].items()
              if math.prod(lo) * NPROC != math.prod(wh)]
    if uneven or out["plan_leaves"] == 0:
        fail(f"tp: {out['plan_leaves']} sharded leaves; not 1/{NPROC} of the whole: {uneven[:4]}")
    if len({x["replicated_digest"] for x in got}) != 1:
        fail("tp: the processes' replicated leaves differ")
    rows = []
    for s, want in enumerate(ref):
        per = [x["steps"][s] for x in got]
        if any(p["metrics"] != per[0]["metrics"] for p in per):
            fail(f"tp step {s + 1}: the processes' metrics differ")
        worst = max(abs(per[0]["metrics"][k] - v) / max(abs(v), 1e-6)
                    for k, v in want["metrics"].items())
        rows.append({"step": s + 1, "max_rel": worst, "fused_mha": [p["fused_mha"] for p in per],
                     "heads": [p["heads"] for p in per], "device_ms": [p["device_ms"] for p in per],
                     "model_ms": [p["model_ms"] for p in per],
                     "model_calls": [p["model_calls"] for p in per],
                     "single_device_ms": want["device_ms"]})
        if worst > rtol:
            fail(f"tp step {s + 1}: metrics {worst:.3e} from the one-process step (> {rtol})")
        if dev.type == "cuda" and any(p["fused_mha"] != L - 1 or p["heads"] != [heads]
                                      for p in per):
            fail(f"tp step {s + 1}: #1 launches {[p['fused_mha'] for p in per]} at heads "
                 f"{[p['heads'] for p in per]} (expected {L - 1} at {heads})")
    out["steps"] = rows
    # step 1's gradients, gathered whole, against the one process's
    from prcv2025reid_tpu_torch.training.param_groups import label_for_path, param_key

    mine = torch.load(os.path.join(args.out, "tp_state.pt"), weights_only=True)
    want_g = ref_state["grads"]
    worst_g = max(_over_tol(g, want_g[n]) for n, g in mine["grads"].items())
    groups: dict = {}
    for n, g in mine["grads"].items():
        label = label_for_path(param_key(n), cfg.freeze_backbone, cfg.freeze_text_backbone)
        groups.setdefault(label, ([], []))
        groups[label][0].append(g.flatten().float())
        groups[label][1].append(want_g[n].flatten().float())
    out["grad_cos"] = {label: _cos(torch.cat(a), torch.cat(b)) for label, (a, b) in groups.items()}
    out["grad_err_over_tol"] = worst_g
    if set(mine["grads"]) != set(want_g):
        fail("tp: the gradients' leaves differ from one process's")
    if args.cpu and worst_g > 1.0:
        fail(f"tp: step 1's gradients {worst_g:.3f} x the tolerance {TP_TOL} from one process")
    low = {k: v for k, v in out["grad_cos"].items() if v < GRAD_COS}
    if not args.cpu and low:
        fail(f"tp: step 1's gradient cosine by group {low} < {GRAD_COS}")
    # the gathered sharded leaves against the one process's state
    worst, frozen_differ, moves = 0.0, [], ([], [], [])
    for k, v in mine["model"].items():
        w, w0 = ref_state["model"][k], ref_state["init"][k]
        worst = max(worst, _over_tol(v, w))
        if torch.equal(w, w0):  # a frozen leaf: the same bits
            if not torch.equal(v, w):
                frozen_differ.append(k)
            continue
        for i, t in enumerate((v, w, ref_state["control"][k])):
            moves[i].append((t.float() - w0.float()).flatten())
    for part in ("mu", "nu"):
        for n, v in mine[part].items():
            worst = max(worst, _over_tol(v, ref_state[part][n]))
    moved = [torch.cat(m) if m else torch.zeros(1) for m in moves]
    out.update(leaf_err_over_tol=worst, frozen_differ=len(frozen_differ),
               trained_leaves=len(moves[0]), update_cos=_cos(moved[0], moved[1]),
               control_update_cos=_cos(moved[2], moved[1]))
    if frozen_differ:
        fail(f"tp: frozen sharded leaves differ from one process: {frozen_differ[:4]}")
    if args.cpu and worst > 1.0:
        fail(f"tp: gathered leaves {worst:.3f} x the tolerance {TP_TOL} from one process")
    # the fused-stream embed
    feats = [np.load(os.path.join(args.out, f"tp_rank{r}_embed.npy")) for r in range(NPROC)]
    cos = [float(((f * ref_embed).sum(1) / np.maximum(
        np.linalg.norm(f, axis=1) * np.linalg.norm(ref_embed, axis=1), 1e-12)).min())
        for f in feats]
    out["embed"] = {"batch": int(ref_embed.shape[0]), "min_cosine": cos,
                    "ranks_equal": bool(np.array_equal(feats[0], feats[1])),
                    "launches": [x["embed_launches"] for x in got], "single_launches": ref_launches}
    if min(cos) < MIN_COSINE:
        fail(f"tp embed: min-cosine {min(cos):.6f} < {MIN_COSINE}")
    if dev.type == "cuda":
        want = {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L}
        want = {k: want.get(k, 0) for k in ref_launches}
        if any(x["embed_launches"] != want for x in got) or ref_launches != want:
            fail(f"tp embed: launches {out['embed']['launches']}, one process {ref_launches}, "
                 f"expected {want}")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.rank is not None:
        return child(args)
    summary = launch(argv)
    print(json.dumps(summary, default=float))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
