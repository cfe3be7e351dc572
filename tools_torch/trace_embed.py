#!/usr/bin/env python3
"""torch.profiler trace of the embed path (the gallery embed of a batch of
``("vis",)`` images at ViT-B/16 width) with a per-kernel cost table and a
category rollup (the PyTorch port's counterpart of ``tools/trace_embed.py``).

Usage:
    python3 tools_torch/trace_embed.py [--batch 128]
        [--block-impl xla|fused|fused_int8|fused_int8_mlp|fused_qkv]
        [--attn-backend xla|splash|onesaug] [--gelu-impl erf|tanh|poly]
        [--iters 6] [--out <tmp>/embed_trace] [--cpu] [--set key=value ...]

Runs a seeded uint8 batch through ``engine.make_combo_embed_step`` under
``utils/profiling.trace`` and prints the per-step kernel table (ms, % of
device time) and JAX's rollup into matmul / ln-reduce / softmax-exp /
transpose-copy / pallas / other buckets (``utils/trace_table.rollup``).
In the port the ``pallas`` bucket holds the hand-written kernels of
``prcv2025reid_tpu_torch/csrc`` (matched by their kernel names, before the
matmul patterns: the GEMM core's kernel has "gemm" in its name).  Beside
the profiler's total it prints the device ms of one step from CUDA events
(``utils/timing.device_ms``): the two differ (the events read the span of
a call, gaps included; the profiler drops kernels late in a long process).
No HLO is written: the port has none.  The last line is a JSON summary.
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
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--block-impl", default="xla")
    ap.add_argument("--attn-backend", default="xla", choices=("xla", "splash", "onesaug"))
    ap.add_argument("--gelu-impl", default="erf", choices=("erf", "tanh", "poly"))
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "embed_trace"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions, f32); default: the card")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a config override (repeatable), e.g. vision_layers=2")
    return ap


def print_rollup(cats, batch=None):
    """JAX's rollup lines, largest bucket first; -> the total ms."""
    total = sum(cats.values())
    print("\n=== rollup ===")
    for k, v in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {v:9.3f} ms  {100 * v / max(total, 1e-9):5.1f}%  {k}")
    if total > 0 and batch:
        print(f"  {total:9.3f} ms  total -> {batch / (total / 1e3):.0f} embeds/s "
              f"(device-op time only)")
    elif total <= 0:
        print("  no device kernels found in the trace (CPU run?)")
    return total


def random_model(config, num_classes, device, seed=0):
    """The eval model with seeded random weights drawn on ``device``: the
    tools time steps, which no weight value changes, and a draw on the card
    takes milliseconds where ``params.init_params``' numpy draws take
    seconds at full width.  Kernels are normal at 1/sqrt(fan-in), lora_A at
    1/sqrt(its input width), LayerNorm / BatchNorm scales and the running
    variance ones, biases, lora_B and the running mean zeros, the tokens,
    positions and embeddings 0.02-normal."""
    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel

    model = MultiModalReIDModel(config, num_classes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.fill_(1.0)
            elif leaf in ("bias", "mean", "lora_B"):
                t.zero_()
            elif leaf == "kernel":
                t.normal_(0.0, float(np.prod(t.shape[:-1])) ** -0.5, generator=gen)
            elif leaf == "lora_A":
                t.normal_(0.0, t.shape[-2] ** -0.5, generator=gen)
            else:
                t.normal_(0.0, 0.02, generator=gen)
    return model.eval()


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.configs import TrainingConfig, apply_cli_overrides
    from prcv2025reid_tpu_torch.engine import make_combo_embed_step
    from prcv2025reid_tpu_torch.ops import library
    from prcv2025reid_tpu_torch.utils.device import resolve_device
    from prcv2025reid_tpu_torch.utils.profiling import trace
    from prcv2025reid_tpu_torch.utils.timing import device_ms
    from prcv2025reid_tpu_torch.utils.trace_table import op_time_breakdown, print_top, rollup

    dev = resolve_device("cpu" if args.cpu else device)
    on_card = dev.type == "cuda"
    B = args.batch
    config = TrainingConfig(
        compute_dtype="bfloat16" if on_card else "float32",
        block_impl=args.block_impl,
        attn_backend=args.attn_backend,
        gelu_impl=args.gelu_impl,
    )
    config = apply_cli_overrides(config, [f"--{kv}" for kv in args.set])
    model = random_model(config, 400, dev)
    Mv, S = len(config.vision_modalities), config.image_size
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (B, Mv, S, S, 3), dtype=np.uint8)).to(dev)
    image_mask = torch.ones((B, Mv), dtype=torch.float32, device=dev)
    embed = make_combo_embed_step(model, ("vis",))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = embed(images, image_mask)
    checksum = float(out.float().sum())  # a host fetch: the warm call is done
    print(f"warm; checksum={checksum:.4f}", file=sys.stderr)

    before = library.launch_counts()
    with trace(args.out):
        for _ in range(args.iters):
            out = embed(images, image_mask)
        sync()
    launches = {k: (v - before[k]) / args.iters for k, v in library.launch_counts().items()
                if v != before[k]}

    table = op_time_breakdown(args.out)
    per_step = {k: v / args.iters for k, v in table.items()}
    print(f"\n=== per-step op table (batch={B}, block_impl={args.block_impl}) ===")
    print_top(per_step, n=40)
    cats = rollup(per_step)
    total = print_rollup(cats, B)
    events_ms = device_ms(lambda: embed(images, image_mask)) if on_card else None
    print(f"device ms of one step: CUDA events "
          + (f"{events_ms:.3f}" if events_ms is not None else "not measured (no card)")
          + f", the profiler's kernel sum {total:.3f} ({len(per_step)} kernels)")
    print(json.dumps({"trace_embed": {
        "batch": B, "block_impl": args.block_impl, "attn_backend": args.attn_backend,
        "gelu_impl": args.gelu_impl, "device": dev.type, "profiler_ms": total,
        "table_ms": sum(per_step.values()), "rollup": cats, "device_ms": events_ms,
        "launches_per_step": launches,
        "kernels_by_bucket": _names_by_bucket(per_step)}}))


def _names_by_bucket(table):
    from prcv2025reid_tpu_torch.utils.trace_table import bucket

    out = {}
    for name in table:
        out.setdefault(bucket(name), []).append(name[:120])
    return out


if __name__ == "__main__":
    main()
