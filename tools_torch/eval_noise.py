#!/usr/bin/env python3
"""How far bf16 rounding alone moves the MM-1..4 mAPs of a dataset
evaluation, on the card.

    python3 tools_torch/eval_noise.py [--ids 64 256] [--steps 20]

For each tree size: a synthetic ORBench tree (``--ids`` ids x 4 anchors,
256 px JPEGs, in a temporary directory), split as the trainer splits it
(val_ratio 0.2); ``--steps`` train steps of the 8x4 recipe on ``xla`` fed
by the host pipeline; then ``evaluate_protocol`` over the val split (all
15 plans) with the trained weights under ``xla`` and the fused-stream trunk
(bf16, batch 64 and 32) and in f32.  Prints, per pair of runs, the largest
and the mean |dmAP| over the plans and how many plans exceed 0.005 (the
ranking gate's bar): the bar is only a test of a kernel path where the bf16
reference's own distance from f32 stays below it.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIRS = (("xla@64", "fused_trunk@64"), ("xla@64", "xla@32"),
         ("fused_trunk@64", "fused_trunk@32"), ("xla@64", "f32@64"),
         ("fused_trunk@64", "f32@64"))
BAR = 0.005


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ids", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch import (TrainingConfig, build_model, init_train_state,
                                        make_combo_embed_step, make_train_step)
    from prcv2025reid_tpu_torch.data.device_feed import prefetch_to_device
    from prcv2025reid_tpu_torch.data.pipeline import HostPipeline
    from prcv2025reid_tpu_torch.data.sampler import PKBatchSampler
    from prcv2025reid_tpu_torch.data.split import create_split_datasets
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.evaluation.protocol import evaluate_protocol
    from prcv2025reid_tpu_torch.params import init_params
    from prcv2025reid_tpu_torch.utils.synthetic import make_synthetic_orbench

    if not torch.cuda.is_available():
        print("eval_noise: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip() or 'nvidia-smi failed'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = TrainingConfig(num_ids_per_batch=8, instances_per_id=4)
    params = init_params(cfg, 400, seed=0, perturb=True)
    for ids in args.ids:
        with tempfile.TemporaryDirectory(prefix="eval_noise_") as tmp:
            root = make_synthetic_orbench(os.path.join(tmp, "orbench"), num_ids=ids,
                                          anchors_per_id=4, img_size=256)
            dcfg = cfg.replace(data_root=root, json_file=os.path.join(root, "text_annos.json"))
            train_ds, val_ds, _ = create_split_datasets(dcfg)
            tok = build_tokenizer(None, dcfg.text_vocab_size, dcfg.text_context_length)
            model = build_model(dcfg, params, device=dev)
            state = init_train_state(model, dcfg, 1, seed=0)
            step = make_train_step(model, dcfg, 1)
            sampler = PKBatchSampler(train_ds, 8, 4, seed=dcfg.seed, steps_per_epoch=args.steps)
            pipe = HostPipeline(train_ds, sampler, tok, seed=dcfg.seed)
            try:
                for batch in prefetch_to_device(pipe, size=dcfg.prefetch_batches, device=dev):
                    state, _ = step(state, batch, 0.1, 0.18)
            finally:
                pipe.close()
            models = {"xla": model}
            for name, c in (("fused_trunk", dcfg.replace(use_fused_resln=True, use_fused_mlp=True,
                                                         use_pallas_attention=True)),
                            ("f32", dcfg.replace(compute_dtype="float32"))):
                models[name] = build_model(c, params, device=dev)
                models[name].load_state_dict(model.state_dict())
            runs = {}
            for name, bs in (("xla", 64), ("fused_trunk", 64), ("xla", 32), ("fused_trunk", 32),
                             ("f32", 64)):
                t0 = time.perf_counter()
                r = evaluate_protocol(
                    None, val_ds, tok, batch_size=bs, device=dev,
                    embed_factory=lambda mods, m=models[name]: make_combo_embed_step(m, mods))
                runs[f"{name}@{bs}"] = {p: d["mAP"] for p, d in r["detail"].items()}
                print(f"ids {ids}: {name}@{bs} in {time.perf_counter() - t0:.1f} s", flush=True)
            out = {}
            for a, b in PAIRS:
                d = [abs(runs[a][p] - runs[b][p]) for p in runs[a]]
                out[f"{a} vs {b}"] = {"max": max(d), "mean": float(np.mean(d)),
                                      f"n_over_{BAR}": sum(v > BAR for v in d)}
            print(f"ids {ids} (val {len(val_ds)} records): " + json.dumps(out), flush=True)
            print(f"ids {ids} mAP xla@64: " + json.dumps(runs["xla@64"]), flush=True)
            del models, model, state, step
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
