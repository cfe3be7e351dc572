#!/usr/bin/env python3
"""One-command validation harness for a real ORBench-layout dataset (the
PyTorch port's counterpart of ``tools/dryrun_real_data.py``).

Runs the product path against the tree, each step through the port's own
command line: train (``tools_torch/train.py``) -> MM-protocol evaluation of
the trained model on the val split (``tools_torch/eval_mm_protocol.py``)
-> submission CSV (``tools_torch/generate_submission.py``), and checks every
output artifact's schema.

    python3 tools_torch/dryrun_real_data.py --data_root /data/orbench \\
        [--json_file .../text_annos.json] [--work_dir ./dryrun_out] \\
        [--epochs 1] [--full-size] [--clip_weights_path ...] [--cpu]

By default the model is shrunk (a fast smoke of the DATA path); pass
--full-size for the real ViT-B/16.  It runs on the CUDA card; ``--cpu`` (or
``main(argv, device="cpu")``) on the CPU.  Exit code 0 = every check
passed; ``<work_dir>/dryrun_report.json`` holds the checks and metrics.
"""
import argparse
import importlib.util
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SMALL = dict(
    vision_hidden_dim=64, vision_layers=2, vision_heads=4, vision_mlp_dim=128,
    text_hidden_dim=32, text_layers=2, text_heads=4, text_mlp_dim=64,
    fusion_dim=32, sdm_semantic_dim=32, sdm_num_heads=4, fusion_num_heads=4,
    drop_path=0.0,
)
METRIC_KEYS = ("map_single", "map_quad", "map_avg2", "mm1_map", "mm4_map", "cmc1", "cmc5",
               "cmc10")


def _tool(name):
    # by path, under a name of its own: the JAX package's tools/ holds
    # modules of the same names
    spec = importlib.util.spec_from_file_location(
        f"tools_torch_{name}", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--json_file", default=None)
    ap.add_argument("--work_dir", default="./dryrun_out")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps_per_epoch", type=int, default=None,
                    help="cap steps for a quick pass; None = full epoch")
    ap.add_argument("--full-size", action="store_true",
                    help="real ViT-B/16 dims instead of the smoke model")
    ap.add_argument("--clip_weights_path", default=None)
    ap.add_argument("--eval_sample_ratio", type=float, default=0.3)
    ap.add_argument(
        "--set", dest="extra", action="append", default=[], metavar="KEY=VALUE",
        help="extra TrainingConfig override, repeatable (e.g. "
        "--set use_native_decode=true --set use_fused_resln=true)",
    )
    ap.add_argument(
        "--rerank", action="store_true",
        help="also run phase 3/4 with k-reciprocal re-ranking (the mAP "
        "booster the submission would actually ship with)",
    )
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"

    from prcv2025reid_tpu_torch.configs import TrainingConfig, apply_cli_overrides
    from prcv2025reid_tpu_torch.data.dataset import analyze_sampling_capability
    from prcv2025reid_tpu_torch.data.split import create_split_datasets
    from prcv2025reid_tpu_torch.evaluation.protocol import _query_indices, build_query_plans

    checks = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))
        print(f"  [{'OK' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""))
        return ok

    work = os.path.abspath(args.work_dir)
    if os.path.exists(work):
        shutil.rmtree(work)
    os.makedirs(work)

    overrides = dict(
        data_root=args.data_root,
        json_file=args.json_file or os.path.join(args.data_root, "text_annos.json"),
        num_epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch,
        save_dir=os.path.join(work, "ckpt"),
        log_dir=os.path.join(work, "logs"),
        eval_cache_dir=os.path.join(work, "cache"),
        eval_sample_ratio=args.eval_sample_ratio,
        clip_weights_path=args.clip_weights_path,
        num_workers=min(2, os.cpu_count() or 1),
    )
    if not args.full_size:
        overrides.update(SMALL)
    flags = [f"--{k}={v}" for k, v in overrides.items() if v is not None]
    flags += [f"--{kv}" for kv in args.extra]
    # the train command line's own parser, so types and validation agree
    config = apply_cli_overrides(TrainingConfig(), flags)

    print("== phase 1: data preflight ==")
    train_ds, val_ds, _ = create_split_datasets(config)
    rep = analyze_sampling_capability(train_ds)
    check("dataset pairable", rep["pairable"], str(rep))
    check("val split non-empty", len(val_ds.records) > 0, f"{len(val_ds.records)} records")
    if not rep["pairable"]:
        raise RuntimeError(f"no pairable identities — training cannot proceed: {rep}")

    print("== phase 2: train (tools_torch/train.py) ==")
    result = _tool("train").main(flags, device=device)
    check("fit returned best_map", "best_map" in result, str(result.get("best_map")))
    hist = os.path.join(config.log_dir, "train_history.csv")
    ok_hist = os.path.exists(hist) and len(open(hist).readlines()) >= args.epochs + 1
    check("train_history.csv rows", ok_hist, hist)
    latest = os.path.join(config.save_dir, "latest")
    check("latest checkpoint", os.path.isdir(latest))

    print("== phase 3: MM-1..4 eval (tools_torch/eval_mm_protocol.py, full protocol) ==")
    eval_flags = [f"--dataset_root={config.data_root}", f"--json_file={config.json_file}",
                  f"--model_path={latest}", "--eval_split=val",
                  f"--sample_ratio={args.eval_sample_ratio}", f"--batch_size={config.eval_batch_size}",
                  f"--cache_dir={os.path.join(work, 'eval_cache')}"]
    if args.rerank:
        eval_flags += ["--rerank", "--rerank_top_n=100", "--rerank_k1=20", "--rerank_k2=6",
                       "--rerank_lambda=0.3"]
    metrics = _tool("eval_mm_protocol").main(eval_flags, device=device)
    for key in METRIC_KEYS:
        check(f"metric {key} in [0,1]",
              key in metrics and 0.0 <= metrics[key] <= 1.0, f"{metrics.get(key)}")
    check("all 15 MM combos evaluated", len(metrics["detail"]) == 15,
          f"{sorted(metrics['detail'])}")
    if args.rerank:
        check("re-ranked detail carries mAP_plain",
              all("mAP_plain" in d for d in metrics["detail"].values()))

    print("== phase 4: submission export (tools_torch/generate_submission.py) ==")
    sub = os.path.join(work, "submission.csv")
    _tool("generate_submission").main(
        eval_flags + [f"--out={sub}"],
        device=device)
    lines = open(sub).read().strip().split("\n")
    n = len(lines) - 1
    # one row a query of every plan: the whole split, never sampled
    n_queries = sum(len(_query_indices(val_ds, mods)) for _, mods in build_query_plans())
    check("submission row count", n == n_queries > 0, f"{n} rows, {n_queries} queries")
    check("submission header", lines[0] == "query_key,ranked_gallery_ids")
    ok_rows = all(
        "," in ln and len(ln.split(",")[0].split("|")) == 3 for ln in lines[1:3]
    )
    check("query_key schema pid|mods|stem", ok_rows, lines[1][:60] if n else "")
    n_gallery = sum(1 for r in val_ds.records if r.vis)
    depth = len(lines[1].split(",")[1].split()) if n else 0
    check("ranking depth == min(rank_topk, gallery)",
          depth == min(config.rank_topk, n_gallery), f"{depth}")

    with open(os.path.join(work, "dryrun_report.json"), "w") as f:
        json.dump(
            {
                "checks": [{"name": c, "ok": o, "detail": d} for c, o, d in checks],
                "metrics": {k: v for k, v in metrics.items() if k != "detail"},
                "detail": metrics["detail"],
                "best_map": result.get("best_map"),
            },
            f, indent=2, default=float,
        )
    failed = [c for c, o, _ in checks if not o]
    print(f"== {'ALL CHECKS PASSED' if not failed else 'FAILED: ' + ', '.join(failed)} ==")
    print(f"report: {work}/dryrun_report.json")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
