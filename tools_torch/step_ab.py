#!/usr/bin/env python3
"""Device milliseconds and wall-clock embeds/s of one full-width embed step
under a few paths, for two trees of the repository on one card, in turns.

    python3 tools_torch/step_ab.py --other DIR [--paths fused_int8 xla ...] [--windows 5]

DIR is another checkout of the repository, e.g. a parent commit unpacked
into the git-ignored ``_cmp/`` (``git archive REV | tar -x -C _cmp/parent``).
Both trees hold a package named ``prcv2025reid_tpu_torch``, so each runs in a
process of its own, in the order other, this, this, other.  A process builds
ViT-B/16 at full width (``TrainingConfig()``, 400 classes, bf16) from
``init_params(seed=0, perturb=True)`` under each path, as ``chip_smoke.py``
does, and embeds one seeded uint8 batch of 128 four-modality samples as a
("vis",) gallery: two warm-up steps, then ``--windows`` torch.profiler
windows of one step each.  A window's reading is the device time summed over
the step's kernels and its kernel launches; a path's reading is the median
of its windows, with the spread (min, max) and the launch counts beside it,
so a window in which the profiler lost kernels shows.  Before the windows,
RATE_ROUNDS rounds of RATE_ITERS steps on the host clock (synchronised at
each round's ends) give the path's embeds/s (their median) and, with the
device ms, its idle share.  Prints one JSON line per path with both trees'
readings, and the card's name and power limit.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BATCH, NUM_CLASSES = 128, 400
RATE_ROUNDS, RATE_ITERS = 5, 10
FUSED_TRUNK = {"use_fused_resln": True, "use_fused_mlp": True, "use_pallas_attention": True}
PATHS = {
    "xla": {},
    "fused": {"block_impl": "fused"},
    "pallas_attention": {"use_pallas_attention": True},
    "fused_mlp": {"use_fused_mlp": True},
    "fused_trunk": FUSED_TRUNK,
    "fused_resln": {"use_fused_resln": True, "use_pallas_attention": True},
    "fused_qkv": {"block_impl": "fused_qkv"},
    "splash": {"attn_backend": "splash"},
    "fused_int8": {"block_impl": "fused_int8"},
    "fused_int8_mlp": {"block_impl": "fused_int8_mlp"},
}


def worker(tree: Path, paths, windows: int) -> None:
    """One tree's readings, one JSON line per path, on stdout."""
    sys.path.insert(0, str(tree))
    import torch
    import time

    from torch.profiler import ProfilerActivity, profile

    from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
    from prcv2025reid_tpu_torch.params import init_params

    cfg = TrainingConfig()
    params = init_params(cfg, NUM_CLASSES, seed=0, perturb=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Mv = len(cfg.vision_modalities)
    images = torch.randint(0, 256, (BATCH, Mv, cfg.image_size, cfg.image_size, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    mask = torch.ones(BATCH, Mv, device=dev)
    for name in paths:
        step = make_combo_embed_step(build_model(cfg.replace(**PATHS[name]), params), ("vis",))
        for _ in range(2):
            step(images, mask)
        rates = []
        for _ in range(RATE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RATE_ITERS):
                step(images, mask)
            torch.cuda.synchronize()
            rates.append(BATCH * RATE_ITERS / (time.perf_counter() - t0))
        readings = []
        for _ in range(windows):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(images, mask)
                torch.cuda.synchronize()
            ms, launches = 0.0, 0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                t = getattr(e, "self_device_time_total", None)
                t = e.self_cuda_time_total if t is None else t
                if t > 0:
                    ms += t / 1e3
                    launches += e.count
            readings.append((ms, launches))
        print(json.dumps({"path": name, "device_ms": [r[0] for r in readings],
                          "launches": [r[1] for r in readings], "embeds_per_s": rates}),
              flush=True)


def run_tree(tree: Path, paths, windows: int) -> dict:
    out = subprocess.run([sys.executable, __file__, "--worker", str(tree), "--windows",
                          str(windows), "--paths", *paths], capture_output=True, text=True,
                         timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"step_ab worker for {tree} failed:\n{out.stderr[-4000:]}")
    return {d["path"]: d for d in map(json.loads, out.stdout.splitlines()) if d}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout of the repo")
    ap.add_argument("--paths", nargs="+", default=["fused_int8", "fused_int8_mlp", "xla"],
                    choices=sorted(PATHS))
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.paths, args.windows)
        return 0
    if args.other is None:
        ap.error("give --other DIR")
    import torch

    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    trees = {"other": args.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        runs[who].append(run_tree(trees[who], args.paths, args.windows))
    for name in args.paths:
        line = {"path": name, "card": card}
        for who in ("other", "this"):
            line[who] = []
            for r in runs[who]:
                ms, rate = statistics.median(r[name]["device_ms"]), statistics.median(
                    r[name]["embeds_per_s"])
                line[who].append({"median_ms": ms, "min_ms": min(r[name]["device_ms"]),
                                  "max_ms": max(r[name]["device_ms"]),
                                  "launches": sorted(set(r[name]["launches"])),
                                  "embeds_per_s": rate,
                                  "idle_share": 1 - ms / (BATCH / rate * 1e3)})
        print(json.dumps(line))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
