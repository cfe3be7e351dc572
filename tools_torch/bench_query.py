#!/usr/bin/env python3
"""Query-side throughput benchmark (the PyTorch port's counterpart of
``tools/bench_query.py``, with its paths and flags).

The gallery rate (vis only) is the volume term; the protocol's query side
embeds MM-1..4 modality combinations (up to three vision towers, the text
tower and the fusion a query).  This measures queries/s through the embed
steps the eval and serving command lines use (``make_combo_embed_step`` /
``make_weighted_embed_step``) for:

- ``text``          the text tower alone (77-token causal transformer + head)
- ``single_nir``    one non-vis vision tower (the gallery rate's shape)
- ``quad``          MM-4: nir+sk+cp+text in one step (fusion over 4 slots)
- ``weighted_quad`` the weighted-fusion variant (one stacked trunk pass,
                    four head passes, text 1.2)

Timing is the port's rule: a host clock around ``--iters`` calls closed by
``torch.cuda.synchronize``, the median of three rounds; beside it the
device ms of one call from CUDA events behind a spin kernel
(``utils/timing.py``: torch.profiler's kernel sums drop kernels in a
long-lived process; null on the CPU).  Weights
are random (``init_params``, seed 0); inputs are seeded uint8 images and
token ids.

Prints one JSON line a path, ``{"path", "queries_per_sec", "device_ms",
"batch"}``, and a summary line with every result.

    python3 tools_torch/bench_query.py                      # all paths, on the card
    python3 tools_torch/bench_query.py --paths text,quad --batch 32
    python3 tools_torch/bench_query.py --set use_fused_resln=true \\
        --set use_fused_mlp=true --set use_pallas_attention=true  # fused-stream trunk

``main(argv, device="cpu")`` runs it on the CPU (f32, batch 2, 2 iterations
unless the flags say otherwise).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the active modality combo of each measured path
PATH_MODS = {
    "text": ("text",),
    "single_nir": ("nir",),
    "quad": ("nir", "sk", "cp", "text"),
    "weighted_quad": ("nir", "sk", "cp", "text"),
}
# text 1.2: the weighted fusion of the eval CLI's --fusion_mode weighted
WEIGHTED_W = {"nir": 1.0, "sk": 1.0, "cp": 1.0, "text": 1.2}
# the default batch of each path on the card: text is cheap (77 tokens),
# quad carries three ViT towers
DEFAULT_BATCH = {"text": 256, "single_nir": 160, "quad": 64, "weighted_quad": 64}
ROUNDS = 3


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--paths", default=",".join(PATH_MODS),
                    help="comma list of: " + ", ".join(PATH_MODS))
    ap.add_argument("--batch", type=int, default=None,
                    help="override the per-path default batch size")
    ap.add_argument("--iters", type=int, default=None,
                    help="calls a timed round (default 10 on the card)")
    ap.add_argument("--attn_backend", default=None, choices=("xla", "splash", "onesaug"))
    ap.add_argument("--gelu_impl", default=None, choices=("erf", "tanh", "poly"))
    ap.add_argument("--block_impl", default=None, choices=("xla", "fused", "fused_int8"))
    ap.add_argument("--set", dest="extra", action="append", default=[], metavar="KEY=VALUE",
                    help="extra TrainingConfig override")
    return ap


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.configs import TrainingConfig, apply_cli_overrides
    from prcv2025reid_tpu_torch.engine import (
        build_model,
        make_combo_embed_step,
        make_weighted_embed_step,
        resolve_device,
    )
    from prcv2025reid_tpu_torch.utils.timing import device_ms

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    config = TrainingConfig(compute_dtype="bfloat16" if on_card else "float32")
    overrides = {k: v for k, v in (("attn_backend", args.attn_backend),
                                   ("gelu_impl", args.gelu_impl),
                                   ("block_impl", args.block_impl)) if v is not None}
    if overrides:
        config = config.replace(**overrides)
    if args.extra:
        config = apply_cli_overrides(config, [f"--{kv}" for kv in args.extra])

    model = build_model(config, device=dev, num_classes=400)
    Mv, S, CTX = len(config.vision_modalities), config.image_size, config.text_context_length
    n_iters = args.iters or (10 if on_card else 2)
    gen = torch.Generator(device=dev).manual_seed(0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def measure(path):
        mods = PATH_MODS[path]
        B = args.batch or (DEFAULT_BATCH[path] if on_card else 2)
        has_vision = any(m in mods for m in config.vision_modalities)
        # a text-only path never reads the pixels: hold no random images for it
        images = (torch.randint(0, 256, (B, Mv, S, S, 3), generator=gen, device=dev,
                                dtype=torch.uint8) if has_vision
                  else torch.zeros((B, Mv, S, S, 3), dtype=torch.uint8, device=dev))
        image_mask = torch.tensor([[1.0 if m in mods else 0.0 for m in config.vision_modalities]],
                                  device=dev).expand(B, Mv)
        tokens = torch.randint(1, config.text_vocab_size - 1, (B, CTX), generator=gen,
                               device=dev, dtype=torch.int32)
        text_mask = torch.full((B,), 1.0 if "text" in mods else 0.0, device=dev)
        if path == "weighted_quad":
            step = make_weighted_embed_step(model, mods, WEIGHTED_W)
        else:
            step = make_combo_embed_step(model, mods)

        def call():
            return step(images, image_mask, tokens, text_mask)

        checksum = float(call().sum())  # warm: the kernels' build, the allocator
        if not np.isfinite(checksum):
            raise RuntimeError(f"{path}: non-finite features")
        rates = []
        for _ in range(ROUNDS):
            sync()
            t0 = time.perf_counter()
            for _ in range(n_iters):
                out = call()
            sync()
            rates.append(B * n_iters / (time.perf_counter() - t0))
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{path}: non-finite features")
        return statistics.median(rates), rates, (device_ms(call) if on_card else None), B

    results = {}
    for path in [p for p in args.paths.split(",") if p]:
        if path not in PATH_MODS:
            raise SystemExit(f"unknown path {path!r}; choices: {list(PATH_MODS)}")
        qps, rounds, dms, B = measure(path)
        results[path] = {"queries_per_sec": round(qps, 2), "device_ms": dms, "batch": B,
                         "rounds": [round(r, 2) for r in rounds]}
        print(json.dumps({"path": path, **results[path]}), flush=True)
    summary = {"metric": "query_embeds_per_sec", "paths": results,
               "config": {k: getattr(config, k) for k in (
                   "attn_backend", "gelu_impl", "block_impl", "use_pallas_attention",
                   "use_fused_mlp", "use_fused_resln")}}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
