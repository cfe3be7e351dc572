#!/usr/bin/env python3
"""Train-step timing + torch.profiler trace at full model size (the PyTorch
port's counterpart of ``tools/trace_train.py``, with its flags and lines).

Times the port's train step (SDM + CE, AdamW, adaptive clip, frozen
backbone per the reference recipe: ``engine.make_train_step``) at a
configurable P x K batch, then traces a few steps and prints the per-kernel
table, the rollup by kernel kind (JAX's "by fusion kind"), JAX's bucket
rollup (``utils/trace_table.rollup``: the port's own kernels in "pallas")
and the device ms of one step from CUDA events beside the profiler's sum.
Every flag sets the port config's field of the same name.

Usage:
    python3 tools_torch/trace_train.py [--pk 8x4] [--steps 20] [--trace-steps 3]
                                       [--out <tmp>/train_trace] [--no-trace]
                                       [--cpu] [--set key=value ...]

The ``steady state:`` line is what ``train_ab.py`` and
``toolchain_watch.py`` parse; the last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pk", default="8x4", help="ids x instances, e.g. 8x4")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace-steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "train_trace"))
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--remat", action="store_true",
                    help="enable per-block rematerialization (remat_blocks)")
    ap.add_argument("--remat-policy", default="full", choices=("full", "dots"))
    ap.add_argument("--gelu-bwd", default="stored", choices=("remat", "stored"),
                    help="training GELU backward scheduling; default matches "
                         "the production config (configs.gelu_bwd='stored')")
    ap.add_argument("--attn-bwd", default="stored", choices=("remat", "stored"),
                    help="attention backward scheduling: 'remat' recomputes "
                         "QK+softmax instead of storing the [S,S] probs")
    ap.add_argument("--donate", default=True, action=argparse.BooleanOptionalAction,
                    help="configs.donate_train_state (accepted; the port's step "
                         "updates the state in place either way)")
    ap.add_argument("--sdm-impl", default="unrolled", choices=("unrolled", "batched"),
                    help="SDM loss formulation (configs.sdm_impl)")
    ap.add_argument("--nu-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="AdamW second-moment storage dtype (configs.opt_nu_dtype)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions, f32); default: the card")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a config override (repeatable), e.g. vision_layers=2")
    return ap


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    P, K = (int(v) for v in args.pk.split("x"))
    B = P * K

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.configs import TrainingConfig, apply_cli_overrides
    from prcv2025reid_tpu_torch.engine import init_train_state, make_train_step
    from prcv2025reid_tpu_torch.utils.device import resolve_device
    from prcv2025reid_tpu_torch.utils.profiling import StepTimer, trace
    from prcv2025reid_tpu_torch.utils.timing import device_ms
    from prcv2025reid_tpu_torch.utils.trace_table import (
        kernel_kind,
        op_time_breakdown,
        print_top,
        rollup,
    )
    from tools_torch.trace_embed import random_model

    dev = resolve_device("cpu" if args.cpu else device)
    on_card = dev.type == "cuda"
    config = TrainingConfig(
        compute_dtype="bfloat16" if on_card else "float32",
        num_ids_per_batch=P,
        instances_per_id=K,
        remat_blocks=args.remat,
        remat_policy=args.remat_policy,
        gelu_bwd=args.gelu_bwd,
        attn_bwd=args.attn_bwd,
        sdm_impl=args.sdm_impl,
        opt_nu_dtype=args.nu_dtype,
        donate_train_state=args.donate,
    )
    config = apply_cli_overrides(config, [f"--{kv}" for kv in args.set])
    num_classes = 400
    Mv, S = len(config.vision_modalities), config.image_size
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.from_numpy(rng.normal(size=(B, Mv, S, S, 3)).astype(np.float32)).to(dev),
        "image_mask": torch.ones((B, Mv), dtype=torch.float32, device=dev),
        "text_tokens": torch.ones((B, config.text_context_length), dtype=torch.int32,
                                  device=dev),
        "text_mask": torch.ones((B,), dtype=torch.float32, device=dev),
        "labels": torch.from_numpy(np.repeat(np.arange(P), K)).to(dev),
    }
    model = random_model(config, num_classes, dev)
    state = [init_train_state(model, config, steps_per_epoch=100, seed=1)]
    step_fn = make_train_step(model, config, steps_per_epoch=100)
    sdm_w, sdm_tau = 0.1, config.sdm_init_temperature

    def step():
        state[0], m = step_fn(state[0], batch, sdm_w, sdm_tau)
        return m

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # 2 warm steps (the kernels build on the first)
    step()
    metrics = step()
    print(f"warm: loss={float(metrics['total_loss']):.4f} "
          f"ce={float(metrics['ce_loss']):.4f}", file=sys.stderr)

    timer = StepTimer(warmup=0)
    timer.tick()
    for i in range(args.steps):
        metrics = step()
        if i == args.steps - 1:
            loss = float(metrics["total_loss"])  # host fetch = completion barrier
        timer.tick()
    assert np.isfinite(loss)
    its = timer.steps_per_sec()
    print(f"steady state: {its:.2f} it/s "
          f"({B * its:.1f} samples/s) at P={P} K={K} "
          f"(batch {B}, {Mv} vision modalities + text, "
          f"remat={args.remat}/{args.remat_policy}, donate={args.donate})")
    summary = {"pk": args.pk, "device": dev.type, "it_per_s": its,
               "samples_per_s": B * its, "steps": args.steps, "loss": loss}

    if not args.no_trace:
        with trace(args.out):
            for _ in range(args.trace_steps):
                metrics = step()
            sync()
        table = op_time_breakdown(args.out)
        ops = {k: v / args.trace_steps for k, v in table.items()}
        total = sum(ops.values())
        print(f"\n=== per-step op table (P={P} K={K}) — "
              f"{total:.1f} ms device time/step ===")
        print_top(ops, n=30)
        groups = {}
        for op, ms in ops.items():
            kind = kernel_kind(op)
            groups[kind] = groups.get(kind, 0.0) + ms
        print("\n=== rollup by kernel kind ===")
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {v:8.3f} ms {100 * v / max(total, 1e-9):5.1f}%  {k}")
        cats = rollup(ops)
        print("\n=== rollup ===")
        for k, v in sorted(cats.items(), key=lambda kv: -kv[1]):
            print(f"  {v:9.3f} ms  {100 * v / max(total, 1e-9):5.1f}%  {k}")
        events_ms = device_ms(step) if on_card else None
        print(f"device ms of one step: CUDA events "
              + (f"{events_ms:.3f}" if events_ms is not None else "not measured (no card)")
              + f", the profiler's kernel sum {total:.3f} ({len(ops)} kernels)")
        summary.update(profiler_ms=total, table_ms=sum(ops.values()), rollup=cats,
                       device_ms=events_ms,
                       top_kinds=sorted(groups.items(), key=lambda kv: -kv[1])[:15])
    print(json.dumps({"trace_train": summary}))


if __name__ == "__main__":
    main()
