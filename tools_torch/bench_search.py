#!/usr/bin/env python3
"""Retrieval-side benchmark: ranking and re-ranking at the competition's
scale (the PyTorch port's counterpart of ``tools/bench_search.py``, with
its paths and flags).

What happens after embedding: ranking queries against a gallery (the MM
protocol's one-product cosine rule) and the optional k-reciprocal
re-ranking head (``evaluation/rerank.py``).  The defaults are the
competition's scale: a ~45k-image gallery of 512-d unit features.  Every
path runs on synthetic unit features (the cost depends on the shapes, not
the values):

- ``rank``        the f32 product with TF32 off (``protocol.similarity``)
                  plus ``stable_topk``: queries/s from a host clock around
                  ``--iters`` calls closed by a synchronize, the median of
                  three rounds, and the device ms of one call (CUDA
                  events behind a spin kernel; null on the CPU).
- ``rerank``      ``rerank_orders`` wall time, every chunk fetched to the
                  host, on a gallery already on the device (the eval CLI
                  uploads it once a protocol; serving keeps it enrolled);
                  the upload is reported apart.
- ``search_e2e``  ``serve_embed.GalleryStore.search`` latency a request
                  (what a serving client pays), plain and re-ranked, at
                  batch 1 and 16: the best and the median of ``--iters``.

Prints one JSON line a path and a summary line.

    python3 tools_torch/bench_search.py                  # competition defaults
    python3 tools_torch/bench_search.py --gallery 1024 --queries 64 --iters 2

``main(argv, device="cpu")`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_serve_embed():
    """tools_torch/serve_embed.py, loaded by path (tools/ holds a module of
    the same name)."""
    spec = importlib.util.spec_from_file_location(
        "tools_torch_serve_embed",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "serve_embed.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gallery", type=int, default=45056,
                    help="gallery size (default ~ the competition's 45k)")
    ap.add_argument("--dim", type=int, default=512, help="feature dim (default = fusion_dim)")
    ap.add_argument("--queries", type=int, default=1024,
                    help="query batch for the rank / rerank paths")
    ap.add_argument("--top_k", type=int, default=100,
                    help="ranking depth (the submission writes top-100)")
    ap.add_argument("--rerank_top_n", type=int, default=100)
    ap.add_argument("--rerank_k1", type=int, default=20)
    ap.add_argument("--rerank_k2", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10, help="calls a timed round / repeats")
    ap.add_argument("--paths", default="rank,rerank,search_e2e",
                    help="comma list of: rank, rerank, search_e2e")
    return ap


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.engine import resolve_device
    from prcv2025reid_tpu_torch.evaluation.protocol import similarity
    from prcv2025reid_tpu_torch.evaluation.rerank import rerank_orders, stable_topk
    from prcv2025reid_tpu_torch.utils.timing import device_ms

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    G, D, Q = args.gallery, args.dim, args.queries
    K = min(args.top_k, G)
    rng = np.random.default_rng(0)

    def unit(n):
        f = rng.normal(size=(n, D)).astype(np.float32)
        return f / np.linalg.norm(f, axis=1, keepdims=True)

    g_np, q_np = unit(G), unit(Q)
    sync()
    t0 = time.perf_counter()
    g_dev = torch.from_numpy(g_np).to(dev)
    sync()
    upload_s = time.perf_counter() - t0
    q_dev = torch.from_numpy(q_np).to(dev)
    results = {}
    paths = [p for p in args.paths.split(",") if p]
    unknown = set(paths) - {"rank", "rerank", "search_e2e"}
    if unknown:
        raise SystemExit(f"unknown paths {sorted(unknown)}; choices: rank, rerank, search_e2e")

    if "rank" in paths:
        def rank():
            return stable_topk(similarity(q_dev, g_dev), K)

        rank()  # warm
        rates = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                scores, _ = rank()
            sync()
            rates.append(Q * args.iters / (time.perf_counter() - t0))
        if not torch.isfinite(scores).all():
            raise RuntimeError("rank: non-finite scores")
        dms = device_ms(rank) if on_card else None
        results["rank"] = {"queries_per_sec": round(statistics.median(rates), 1),
                           "device_ms": dms, "rounds": [round(r, 1) for r in rates],
                           "gallery": G, "top_k": K, "batch": Q}
        print(json.dumps({"path": "rank", **results["rank"]}), flush=True)

    if "rerank" in paths:
        rr = dict(top_n=args.rerank_top_n, k1=args.rerank_k1, k2=args.rerank_k2)
        rerank_orders(q_np, g_dev, device=dev, **rr)  # warm
        rates = []
        for _ in range(max(3, args.iters // 3)):
            t0 = time.perf_counter()
            out = rerank_orders(q_np, g_dev, device=dev, **rr)  # returns host arrays
            rates.append(Q / (time.perf_counter() - t0))
        if out.shape[0] != Q:
            raise RuntimeError(f"rerank: {out.shape[0]} rows for {Q} queries")
        results["rerank"] = {"queries_per_sec": round(statistics.median(rates), 1),
                             "rounds": [round(r, 1) for r in rates],
                             "gallery_upload_s": round(upload_s, 4), "gallery": G, **rr,
                             "batch": Q}
        print(json.dumps({"path": "rerank", **results["rerank"]}), flush=True)

    if "search_e2e" in paths:
        serve_embed = _load_serve_embed()
        store = serve_embed.GalleryStore(D, g_np, [str(i) for i in range(G)], device=dev)
        rr_params = {"top_n": args.rerank_top_n, "k1": args.rerank_k1, "k2": args.rerank_k2,
                     "lam": 0.3}
        e2e = {}
        for nb in sorted({1, min(16, Q)}):
            qb = q_np[:nb]
            for label, rrp in (("plain", None), ("rerank", rr_params)):
                store.search(qb, 10, rerank=rrp)  # warm
                times = []
                for _ in range(max(3, args.iters)):
                    t0 = time.perf_counter()
                    res = store.search(qb, 10, rerank=rrp)
                    times.append(time.perf_counter() - t0)
                if len(res) != nb or not res[0]:
                    raise RuntimeError(f"search_e2e: {len(res)} rows for {nb} queries")
                e2e[f"b{nb}_{label}_ms"] = round(min(times) * 1e3, 3)
                e2e[f"b{nb}_{label}_p50_ms"] = round(statistics.median(times) * 1e3, 3)
        results["search_e2e"] = {**e2e, "gallery": G, "top_k": 10}
        print(json.dumps({"path": "search_e2e", **results["search_e2e"]}), flush=True)

    summary = {"summary": True, "paths": results}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
