#!/usr/bin/env python3
"""ID-disjoint split of a dataset root (the PyTorch port's counterpart of
``tools/split.py``, on the port's ``data/split.py``): prints the id counts
as one JSON line and writes the ids with ``--out``.

    python3 tools_torch/split.py --data_root /data/orbench [--val_ratio 0.2 --seed 42]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from prcv2025reid_tpu_torch.configs import TrainingConfig
    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.split import split_ids

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--json_file", default=None)
    ap.add_argument("--val_ratio", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)

    config = TrainingConfig(
        data_root=args.data_root,
        json_file=args.json_file or os.path.join(args.data_root, "text_annos.json"),
        val_ratio=args.val_ratio, seed=args.seed)
    ds = MultiModalDataset(config, "train")
    train_ids, val_ids = split_ids(ds.person_ids, args.val_ratio, args.seed)
    result = {"num_ids": len(ds.person_ids), "train_ids": train_ids, "val_ids": val_ids,
              "seed": args.seed, "val_ratio": args.val_ratio}
    print(json.dumps({k: (len(v) if isinstance(v, list) else v) for k, v in result.items()}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
