#!/usr/bin/env python3
"""SDM symmetry-breaking probe at full model size (the PyTorch port's
counterpart of ``tools/probe_sdm_breaking.py``, with its flags and its JSON).

The signature it probes: CE descends and the classifier learns while the
SDM loss sits at ln(B) and val mAP stays at random.  At fusion_dim=512 the
random-init pairwise cosines concentrate at 0 +- 1/sqrt(512), so at tau=0.18
the SDM softmax is near-uniform and the symmetry-breaking gradient tiny; a
collapsed vision trunk (every image -> one direction) reads the same.  The
probe's primary axis is the trunk learning rate, tau the secondary one.

Per lr the train step is rebuilt (the rates are the optimizer's); per (tau,
weight) it is not (runtime scalars).  For each cell the model is reset to
the SAME init and stepped N times on one fixed batch (pure memorization:
a recipe that fails here will never align the real stream); the probe
reports the sdm_loss trajectory and a direct collapse metric, the mean
off-diagonal cosine of the raw vis features (collapse -> 1.0, a healthy
spread -> ~0).

    python3 tools_torch/probe_sdm_breaking.py [--pk 8x4] [--steps 150]
        [--taus 0.18,0.06] [--weights 0.5] [--lrs 1e-3,3e-4,1e-4]
        [--cpu] [--tiny] [--out probe.json]

It runs on the CUDA card in bf16; ``--cpu`` or ``--tiny`` (tiny widths)
runs on the CPU in f32.  ``main`` returns the JSON's dict.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(
    vision_hidden_dim=64, vision_layers=2, vision_heads=4,
    vision_mlp_dim=128, text_hidden_dim=32, text_layers=2,
    text_heads=4, text_mlp_dim=64, text_vocab_size=100,
    text_context_length=16, image_size=32, fusion_dim=32,
    sdm_semantic_dim=32, sdm_num_heads=4, fusion_num_heads=4,
    drop_path=0.0,
)
NUM_CLASSES = 96


def offdiag_cosine(torch, f):
    """(mean, max |.|) off-diagonal cosine of the rows of ``f`` [B, D]."""
    f = f.float()
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-12)
    S = f @ f.T
    off = S - torch.eye(S.shape[0], device=S.device) * S
    n = S.shape[0]
    return float(off.sum() / (n * (n - 1))), float(off.abs().max())


def vis_spread(torch, model, batch):
    """Collapse metric: :func:`offdiag_cosine` of the raw vis features of an
    eval forward (all collapsed -> 1.0; a healthy random spread -> ~0)."""
    with torch.inference_mode():
        out, _ = model(batch["images"], batch["image_mask"], batch["text_tokens"],
                       batch["text_mask"], train=False)
    return offdiag_cosine(torch, out["raw_modality_features"][0])  # vis [B, D]


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pk", default="8x4")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--every", type=int, default=25,
                    help="record sdm/ce every N steps")
    ap.add_argument("--taus", default="0.18,0.06")
    ap.add_argument("--weights", default="0.5")
    ap.add_argument("--lrs", default="1e-3,3e-4,1e-4",
                    help="base/mer/fusion LR grid (each value is a fresh optimizer and step)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny dims (validates the probe on the CPU)")
    ap.add_argument("--out", default=None, help="write JSON here")
    args = ap.parse_args(argv)
    P, K = (int(v) for v in args.pk.split("x"))
    B = P * K
    taus = [float(t) for t in args.taus.split(",")]
    weights = [float(w) for w in args.weights.split(",")]
    lrs = [float(v) for v in args.lrs.split(",")]

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.configs import TrainingConfig
    from prcv2025reid_tpu_torch.engine import (
        build_model,
        init_train_state,
        make_train_step,
        resolve_device,
    )
    from prcv2025reid_tpu_torch.params import init_params

    dev = resolve_device("cpu" if args.cpu or args.tiny else device)
    on_card = dev.type == "cuda"

    def make_config(lr):
        kw = dict(
            compute_dtype="bfloat16" if on_card else "float32",
            num_ids_per_batch=P,
            instances_per_id=K,
            freeze_backbone=False,
            base_learning_rate=lr,
            mer_learning_rate=lr,
            fusion_learning_rate=lr,
            head_learning_rate=3 * lr,
            warmup_epochs=0,  # constant-LR probe: measure at the recipe's peak
            head_lr_warmup_epochs=0,
        )
        if args.tiny:
            kw.update(TINY)
        return TrainingConfig(**kw)

    config = make_config(lrs[0])
    model = build_model(config, init_params(config, NUM_CLASSES, seed=0, perturb=False),
                        device=dev)
    Mv, S = len(config.vision_modalities), config.image_size
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.as_tensor(rng.normal(size=(B, Mv, S, S, 3)), dtype=torch.float32,
                                  device=dev),
        "image_mask": torch.ones(B, Mv, device=dev),
        "text_tokens": torch.as_tensor(
            rng.integers(1, config.text_vocab_size, (B, config.text_context_length)),
            dtype=torch.int32, device=dev),
        "text_mask": torch.ones(B, device=dev),
        "labels": torch.as_tensor(np.repeat(np.arange(P), K), dtype=torch.int32, device=dev),
    }
    init = {k: v.clone() for k, v in model.state_dict().items()}

    ln_b = math.log(B)
    print(f"ln(B) = {ln_b:.4f}; grid lrs={lrs} taus={taus} "
          f"weights={weights} steps={args.steps}", flush=True)
    results = []
    for lr in lrs:
        config = make_config(lr)
        step_fn = make_train_step(model, config, 100)
        for tau in taus:
            for w in weights:
                model.load_state_dict(init)
                state = init_train_state(model, config, 100, seed=1)
                traj = []
                t0 = time.perf_counter()
                for s in range(args.steps):
                    state, metrics = step_fn(state, batch, w, tau)
                    if (s + 1) % args.every == 0 or s == 0:
                        traj.append(
                            (s + 1,
                             round(float(metrics["sdm_loss"]), 4),
                             round(float(metrics["ce_loss"]), 4))
                        )
                dt = time.perf_counter() - t0
                cos_mean, cos_max = vis_spread(torch, model, batch)
                cos_mean = round(cos_mean, 4)
                final_sdm = traj[-1][1]
                broke = next(
                    (s for s, sdm, _ in traj if sdm < ln_b - 0.2), None
                )
                results.append(
                    {"lr": lr, "tau": tau, "weight": w, "trajectory": traj,
                     "final_sdm": final_sdm, "broke_at_step": broke,
                     "vis_offdiag_cos_mean": cos_mean,
                     "vis_offdiag_cos_max": round(cos_max, 4),
                     "wall_s": round(dt, 1)}
                )
                print(f"lr={lr:7.1e} tau={tau:5.2f} w={w:3.1f}: sdm "
                      + " ".join(f"{sdm:.3f}" for _, sdm, _ in traj)
                      + (f"  BROKE@{broke}" if broke else "  pinned")
                      + f"  vis_cos={cos_mean:+.3f}"
                      + f"  ({dt:.0f}s)", flush=True)

    report = {"ln_b": ln_b, "lrs": lrs, "pk": args.pk, "steps": args.steps,
              "cells": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
