#!/usr/bin/env python3
"""Where re-ranking on the card leaves the CPU's order, and why.

    python3 tools_torch/rerank_agreement.py [--sigmas 1.1,1.2 2.2,2.4] [--queries 256]

For each (sigma_g, sigma_q) pair it builds the clustered gallery of
``chip_smoke.py`` phase 4e (f) (``tune_rerank.make_clustered``: 1,000 ids x
45 items and 113 distractors = 45,113 x 512, each query excluding one of
its id's items), re-ranks the first ``--queries`` queries with the defaults
on the card and on the CPU, and prints plain and re-ranked mAP, the share of
rows in the same order, and for each row that differs: how many places
moved, whether the head holds the same items, and the largest difference
between the two devices' fused distances at the moved places.  Then the
same with the local solve's products in f64 on both devices (a diagnostic:
the port, as JAX, computes them in f32).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.engine import resolve_device
    from prcv2025reid_tpu_torch.evaluation import protocol, rerank

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sigmas", nargs="+", default=["1.1,1.2", "2.2,2.4"])
    ap.add_argument("--queries", type=int, default=256)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "tools_torch_tune_rerank", os.path.join(REPO, "tools_torch", "tune_rerank.py"))
    tune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tune)
    n = args.queries
    bmm = torch.bmm

    for pair in args.sigmas:
        sg, sq = (float(v) for v in pair.split(","))
        q, qp, g, gp = tune.make_clustered(n_ids=1000, per_id_g=45, n_distract=3, n_q=n,
                                           dim=512, sigma_g=sg, sigma_q=sq)
        g, gp = g[:45113], gp[:45113]
        excl = (qp * 45).astype(np.int32)
        qd, gd = torch.from_numpy(q).to(dev), torch.from_numpy(g).to(dev)
        for local in ("f32", "f64"):
            if local == "f64":
                rerank.torch.bmm = lambda a, b: bmm(a.double(), b.double()).float()
            try:
                card = rerank.rerank_orders(qd, gd, excl_idx=excl, device=dev)
                cpu = rerank.rerank_orders(q, g, excl_idx=excl, device="cpu")
                differ = np.nonzero((card != cpu).any(axis=1))[0]
                plain = protocol.compute_retrieval_metrics(q, qp, g, gp, excl, device=dev)["mAP"]
                boosted = protocol.compute_retrieval_metrics(q, qp, g, gp, excl, boost_idx=card,
                                                             device=dev)["mAP"]
                print(f"sigma {sg}/{sq}, local products in {local}: plain mAP {plain:.4f}, "
                      f"re-ranked {boosted:.4f}; rows in the CPU's order "
                      f"{1 - len(differ) / n:.4f} ({len(differ)} of {n} differ)")
                for i in differ:
                    at = card[i] != cpu[i]
                    fused = {}
                    for name, qq, gg in (("card", qd[i:i + 1], gd),
                                         ("cpu", torch.from_numpy(q[i:i + 1]), torch.from_numpy(g))):
                        ex = torch.as_tensor(excl[i:i + 1], device=gg.device).long()
                        _, f = rerank._rerank_full(qq, gg, ex, None, 0.3, 20, 6, card.shape[1])
                        fused[name] = f[0].cpu().numpy()
                    gap = np.abs(fused["card"] - fused["cpu"])[at].max()
                    print(f"  row {i}: {int(at.sum())} places moved, first at {int(np.argmax(at))}, "
                          f"same head items {set(card[i]) == set(cpu[i])}; fused distances "
                          f"differ by up to {gap:.2e} there")
            finally:
                rerank.torch.bmm = bmm


if __name__ == "__main__":
    main()
