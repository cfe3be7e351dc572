#!/usr/bin/env python3
"""Bounded k-reciprocal re-ranking parameter sweep on synthetic clustered
galleries (the PyTorch port's counterpart of ``tools/tune_rerank.py``).

Gallery model (ReID-shaped): each identity is a unit base direction; gallery
instances = base + sigma_g * noise; queries come from a "different modality"
= base + a shared modality offset + sigma_q * noise, all L2-normalised.
Distractor identities appear only in the gallery.  Difficulty (sigma) is
swept so that the plain-cosine mAP lands where re-ranking has room to act,
plus an easy and a hard edge case.

Prints a sensitivity table (mAP delta against plain cosine per parameter
combination) and the best row per difficulty.

    python3 tools_torch/tune_rerank.py [--quick] [--density] [--out sweep.json]

It runs on the CUDA card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def make_clustered(
    n_ids=160, per_id_g=8, n_distract=40, n_q=320, dim=64,
    sigma_g=0.6, sigma_q=0.8, mod_offset=0.5, contam=0.0, seed=0,
):
    """-> (q, q_pids, g, g_pids).  ``contam`` pulls each query toward another
    identity's base: the regime where k-reciprocity helps (the contaminating
    id's gallery items are reciprocal to each other, not to the query)."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    def noise(shape, sigma):
        # unit noise scaled by sigma: sigma is the noise-to-signal norm ratio
        return sigma * unit(rng.normal(size=shape))

    bases = unit(rng.normal(size=(n_ids + n_distract, dim)))
    offset = unit(rng.normal(size=(dim,)))  # the shared cross-modal shift

    g_pids = np.repeat(np.arange(n_ids + n_distract), per_id_g)
    g = unit(bases[g_pids] + noise((len(g_pids), dim), sigma_g))

    q_pids = rng.integers(0, n_ids, n_q)  # queries only over real ids
    other = (q_pids + 1 + rng.integers(0, n_ids - 1, n_q)) % n_ids
    q = unit(bases[q_pids] + contam * bases[other] + mod_offset * offset
             + noise((n_q, dim), sigma_q))
    return (q.astype(np.float32), q_pids.astype(np.int64), g.astype(np.float32),
            g_pids.astype(np.int64))


# the difficulties: plain mAP across the band where re-ranking acts
DIFFICULTIES = {
    "easy": dict(sigma_g=0.9, sigma_q=1.0),
    "mid": dict(sigma_g=1.1, sigma_q=1.2),
    "hard": dict(sigma_g=1.35, sigma_q=1.5),
    "contam": dict(sigma_g=0.9, sigma_q=1.0, contam=0.8),
    "contam_hard": dict(sigma_g=1.2, sigma_q=1.3, contam=0.8),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true", help="smaller grid (CI-sized)")
    ap.add_argument("--density", action="store_true",
                    help="per_id_g x k1 grid instead of the difficulty sweep: shows that the "
                         "best k1 tracks the instances per id")
    ap.add_argument("--device", default="cuda", help="where to rank and re-rank")
    args = ap.parse_args(argv)

    from prcv2025reid_tpu_torch.evaluation.protocol import compute_retrieval_metrics
    from prcv2025reid_tpu_torch.evaluation.rerank import rerank_orders

    dev = args.device

    def metrics(q, qp, g, gp, **kw):
        return compute_retrieval_metrics(q, qp, g, gp, device=dev, **kw)["mAP"]

    if args.density:
        print("per_id_g x k1 (mid regime, k2=3 lam=0.3 top_n=100, delta_min over 2 seeds):")
        for per in (4, 8, 16, 24):
            row = []
            for k1 in (6, 10, 20, 30):
                ds = []
                for s in (0, 1):
                    q, qp, g, gp = make_clustered(seed=s, per_id_g=per, sigma_g=1.1, sigma_q=1.2)
                    plain = metrics(q, qp, g, gp)
                    o = rerank_orders(q, g, top_n=100, k1=k1, k2=3, lam=0.3, device=dev)
                    ds.append(metrics(q, qp, g, gp, boost_idx=o) - plain)
                row.append(f"k1={k1}:{min(ds):+.3f}")
            print(f"  per_id_g={per:2d}  " + "  ".join(row), flush=True)
        return None

    difficulties = dict(DIFFICULTIES)
    if args.quick:
        grid_k1, grid_k2, grid_lam, grid_topn = [10, 20], [3, 6], [0.3, 0.5], [100]
        difficulties = {"mid": difficulties["mid"]}
    else:
        grid_k1, grid_k2, grid_lam, grid_topn = [10, 15, 20, 30], [1, 3, 6, 9], \
            [0.1, 0.3, 0.5, 0.7], [50, 100]

    results = []
    for dname, dkw in difficulties.items():
        # two seeds per difficulty: a combination must win on both to matter
        sets = [make_clustered(seed=s, **dkw) for s in (0, 1)]
        plains = [metrics(q, qp, g, gp) for (q, qp, g, gp) in sets]
        print(f"[{dname}] plain cosine mAP: " + ", ".join(f"{p:.4f}" for p in plains), flush=True)
        results.append({"difficulty": dname, "plain_mAP": [round(p, 4) for p in plains]})
        for k1, k2, lam, top_n in itertools.product(grid_k1, grid_k2, grid_lam, grid_topn):
            if k2 > k1:
                continue
            deltas = []
            for (q, qp, g, gp), plain in zip(sets, plains):
                orders = rerank_orders(q, g, top_n=top_n, k1=k1, k2=k2, lam=lam, device=dev)
                deltas.append(metrics(q, qp, g, gp, boost_idx=orders) - plain)
            results.append({
                "difficulty": dname, "k1": k1, "k2": k2, "lam": lam, "top_n": top_n,
                "delta_seed0": round(deltas[0], 4),
                "delta_seed1": round(deltas[1], 4) if len(deltas) > 1 else None,
                "delta_min": round(min(deltas), 4),
            })
            print(f"[{dname}] k1={k1:2d} k2={k2} lam={lam} top_n={top_n:3d} "
                  f"dmAP={min(deltas):+.4f}", flush=True)

    for dname in difficulties:
        rows = [r for r in results if r["difficulty"] == dname and "k1" in r]
        best = max(rows, key=lambda r: r["delta_min"])
        default = [r for r in rows if r["k1"] == 20 and r["k2"] == 6 and r["lam"] == 0.3
                   and r["top_n"] == 100]
        print(f"[{dname}] BEST {best}")
        if default:
            print(f"[{dname}] DEFAULT {default[0]}")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
