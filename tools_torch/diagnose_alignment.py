#!/usr/bin/env python3
"""Cross-modal alignment diagnostic for a trained checkpoint (the PyTorch
port's counterpart of ``tools/diagnose_alignment.py``).

Is the trunk learning identity structure at all (vis-vis same-id cosine
above diff-id), and is only the cross-modal alignment (nir/sk/cp/text vs
vis) failing, or is nothing moving outside the classifier head?

Loads a checkpoint directory the port's trainer wrote (``state.pt`` +
``host_state.json``), embeds a balanced sample of the dataset's train split
(2 samples an id, the first ``--ids`` ids) through the model's eval forward,
takes the per-modality raw features (the tensors the SDM loss consumes), and
prints a same-id vs diff-id cosine panel per modality pair.

    python3 tools_torch/diagnose_alignment.py --model_path ./ckpt/best \\
        --dataset_root /data/orbench [--ids 24] [--cpu]

It runs on the CUDA card; ``--cpu`` (or ``main(argv, device="cpu")``) on
the CPU.  ``main`` returns the panel, {"a x b": {"same", "diff", "gap"}}.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--ids", type=int, default=24)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.pipeline import collate
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.engine import load_checkpoint_model

    config, model, _, _ = load_checkpoint_model(os.path.abspath(args.model_path),
                                                "cpu" if args.cpu else device)
    config = config.replace(data_root=args.dataset_root,
                            json_file=os.path.join(args.dataset_root, "text_annos.json"))
    ds = MultiModalDataset(config, "train")
    tok = build_tokenizer(config.tokenizer_vocab_path, config.text_vocab_size,
                          config.text_context_length)

    rng = np.random.default_rng(0)
    # 2 samples per id, first --ids ids -> same-id pairs exist per modality
    by_pid = {}
    for i, rec in enumerate(ds.records):
        by_pid.setdefault(rec.pid, []).append(i)
    pids = sorted(by_pid)[: args.ids]
    idxs = [i for p in pids for i in by_pid[p][:2]]
    samples = [ds.get_sample(i, rng, modality_dropout=None) for i in idxs]
    batch = collate(samples, tok)
    B = len(idxs)
    labels = np.asarray(batch["labels"])

    dev = model.null_tokens.device
    with torch.inference_mode():
        out, _ = model(*(torch.as_tensor(np.asarray(batch[k]), device=dev)
                         for k in ("images", "image_mask", "text_tokens", "text_mask")),
                       train=False)
    feats = out["raw_modality_features"].double().cpu().numpy()  # [M, B, D]
    masks = out["feature_masks"].cpu().numpy()  # [M, B]
    mods = list(config.vision_modalities) + ["text"]
    fn = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-12)

    same = labels[:, None] == labels[None, :]
    eye = np.eye(B, dtype=bool)
    panel = {}
    print(f"{B} samples, {len(pids)} ids — cosine panel "
          "(same-id mean / diff-id mean / gap):")
    for a, ma in enumerate(mods):
        for b, mb in enumerate(mods):
            if b < a:
                continue
            valid = (masks[a][:, None] * masks[b][None, :]) > 0
            off = valid & ~eye if a == b else valid
            S = fn[a] @ fn[b].T
            s_same = S[same & off]
            s_diff = S[~same & off]
            if s_same.size == 0 or s_diff.size == 0:
                continue
            gap = s_same.mean() - s_diff.mean()
            panel[f"{ma} x {mb}"] = {"same": float(s_same.mean()), "diff": float(s_diff.mean()),
                                     "gap": float(gap)}
            flag = " <-- ALIGNED" if gap > 0.05 else ""
            print(f"  {ma:>4s} x {mb:<4s}: {s_same.mean():+.4f} / "
                  f"{s_diff.mean():+.4f} / gap {gap:+.4f}{flag}")
    return panel


if __name__ == "__main__":
    main()
