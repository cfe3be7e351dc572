#!/usr/bin/env python3
"""Standalone MM-1..4 evaluation of a saved checkpoint (the PyTorch port's
counterpart of ``tools/eval_mm_protocol.py``, with its flags and defaults).
Prints one JSON blob with per-combo mAP / CMC and the MM-k aggregates.

    python3 tools_torch/eval_mm_protocol.py --dataset_root /data/orbench \\
        --model_path ./checkpoints/best [--cache_dir .eval_cache] \\
        [--submission out.csv] [--sample_ratio 1.0] [--eval_split val] \\
        [--fusion_mode weighted] [--rerank] [--token_keep 0] \\
        [--block_impl fused] [--attn_backend splash] [--gelu_impl tanh]

``--model_path`` is a checkpoint directory written by the port's trainer
(``state.pt`` + ``host_state.json``); the config and the class count come
from its ``host_state.json``.  It runs on the CUDA card; ``main(argv,
device="cpu")`` runs the plain versions on the CPU.

Two choices differ from the JAX tool on purpose.  The queries are sampled
with the checkpoint config's ``seed``, as the trainer's evaluation samples
them (the JAX tool passes none, so its ``--eval_split val`` numbers are
not the trainer's).  A compute-path override that the checkpoint's config
cannot run raises ``ValueError`` (``use_fused_resln`` with ``--block_impl
fused`` or ``--token_keep``; JAX runs the fused-stream trunk without the
override while the cache tag names it).

Data parallel over N processes, one device each: launch N copies with
``--distributed=on --num_processes=N --process_id=R
--coordinator_address=host:port`` (``--dist_backend=gloo`` for processes
sharing one card).  The embedding splits each batch over the processes and
the ranking splits the queries (``--batch_size`` rounds up to a multiple of
N); every process prints the same JSON, process 0 writes the gallery cache
and the submission CSV.  ``--mesh_shape=d,m --mesh_axis_names=data,model``
lays the N = d x m processes out as a (data, model) mesh: the model is
sharded over the model axis (tensor parallelism, ``parallel/tp.py``) and
the data axis splits the batches and queries as above.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--json_file", default=None)
    ap.add_argument("--model_path", required=True,
                    help="checkpoint dir (contains host_state.json)")
    ap.add_argument("--cache_dir", default="./.eval_cache")
    ap.add_argument("--cache_tag", default="standalone")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--sample_ratio", type=float, default=1.0)
    ap.add_argument("--submission", default=None, help="also export a submission CSV here")
    ap.add_argument("--topk", type=int, default=None,
                    help="submission ranking depth; default = checkpoint config.rank_topk")
    ap.add_argument("--fusion_mode", choices=("model", "weighted"), default="model",
                    help="query fusion: the model's attention fusion, or the fixed weighted "
                         "sum of the per-modality embeddings (text x1.2)")
    ap.add_argument("--block_impl", default=None, choices=("xla", "fused", "fused_int8"),
                    help="override the trunk compute path for embedding (default = "
                         "checkpoint config)")
    ap.add_argument("--attn_backend", default=None, choices=("xla", "splash", "onesaug"),
                    help="override the attention core for embedding")
    ap.add_argument("--gelu_impl", default=None, choices=("erf", "tanh", "poly"),
                    help="override the GELU formulation for embedding")
    ap.add_argument("--token_keep", type=int, default=None,
                    help="override eval-path token reduction (0 disables; >0 keeps that many "
                         "patch tokens after the checkpoint's token_reduce_layer); cache tags "
                         "separate the paths")
    ap.add_argument("--rerank", action=argparse.BooleanOptionalAction, default=False,
                    help="k-reciprocal re-ranking of each query's cosine top-N head, for the "
                         "metrics and the submission CSV; per-combo detail gains mAP_plain")
    ap.add_argument("--rerank_top_n", type=int, default=100,
                    help="candidate depth re-ranked per query")
    ap.add_argument("--rerank_k1", type=int, default=20, help="reciprocal-neighbourhood size k1")
    ap.add_argument("--rerank_k2", type=int, default=6, help="local query-expansion size k2")
    ap.add_argument("--rerank_lambda", type=float, default=0.3,
                    help="weight of the cosine distance (1-lambda on the Jaccard term); "
                         "1.0 = plain cosine")
    ap.add_argument("--exclude_same_image", action=argparse.BooleanOptionalAction, default=True,
                    help="--no-exclude_same_image disables the anchor-exclusion protocol")
    ap.add_argument("--distributed", choices=("off", "auto", "on"), default="off",
                    help="multi-process evaluation over a torch.distributed group")
    ap.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                    help="the group's backend (default: NCCL with CUDA, else gloo; gloo for "
                         "processes that share one card)")
    ap.add_argument("--coordinator_address", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--mesh_shape", type=lambda s: tuple(int(v) for v in s.split(",") if v),
                    default=(), help="d,m with --mesh_axis_names=data,model: a (data, model) "
                                     "mesh of d x m processes (tensor parallelism over m); "
                                     "default: the 1-D data mesh over every process")
    ap.add_argument("--mesh_axis_names", type=lambda s: tuple(s.split(",")), default=("data",),
                    help="'data' (default) or 'data,model'")
    ap.add_argument("--eval_split", choices=("all", "val", "train"), default="all",
                    help="'all' evaluates every identity under dataset_root; 'val'/'train' "
                         "rebuild the trainer's ID-disjoint split from the checkpoint config "
                         "(val_ratio + seed)")
    return ap


def main(argv=None, device="cuda"):
    from prcv2025reid_tpu_torch import engine
    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.split import create_split_datasets
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.evaluation.protocol import (
        GalleryCache,
        checkpoint_cache_tag,
        evaluate_protocol,
        export_submission_csv,
    )

    from prcv2025reid_tpu_torch.parallel.mesh import create_mesh
    from prcv2025reid_tpu_torch.parallel.tp import shard_variables
    from prcv2025reid_tpu_torch.utils.distributed import initialize_from_config

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # the process group before any device use; the argparse namespace has
    # the fields the helper reads
    initialize_from_config(args, backend=args.dist_backend)
    mesh = create_mesh(args)  # the namespace has the config's two mesh fields
    batch_size = -(-args.batch_size // mesh.size) * mesh.size
    dev = engine.resolve_device(device)

    # compute-path overrides (the same parameters); checkpoint_cache_tag keys
    # on every NUMERICS_PATH_FIELDS value, so another path never shares cached
    # gallery features
    overrides = {k: v for k, v in (("block_impl", args.block_impl),
                                   ("attn_backend", args.attn_backend),
                                   ("gelu_impl", args.gelu_impl),
                                   ("token_keep", args.token_keep)) if v is not None}
    if args.token_keep == 0:
        # a checkpoint trained with token reduction carries token_reduce_train,
        # which the config refuses at token_keep=0; evaluation never trains
        overrides["token_reduce_train"] = False
    # the config comes from the checkpoint's sidecar, so the model matches it;
    # every parameter and statistic comes from the checkpoint
    config, model, state, host = engine.load_checkpoint_model(
        args.model_path, dev, data_root=args.dataset_root,
        json_file=args.json_file or os.path.join(args.dataset_root, "text_annos.json"),
        **overrides)
    shard_variables(model, mesh)  # a model axis: each process its Megatron shards

    if args.eval_split == "all":
        dataset = MultiModalDataset(config, split="val")
    else:
        train_ds, val_ds, _ = create_split_datasets(config)
        dataset = val_ds if args.eval_split == "val" else train_ds
        logging.info("eval_split=%s: %d of the root's records (ID-disjoint split from the "
                     "checkpoint config val_ratio=%s seed=%s)", args.eval_split,
                     len(dataset.records), config.val_ratio, config.seed)
    tokenizer = build_tokenizer(config.tokenizer_vocab_path, config.text_vocab_size,
                                config.text_context_length)

    embed_fns = {}

    def embed_factory(mods):
        mods = tuple(mods)
        if mods not in embed_fns:
            if args.fusion_mode == "weighted" and len(mods) > 1:
                embed_fns[mods] = engine.make_weighted_embed_step(model, mods)
            else:
                embed_fns[mods] = engine.make_combo_embed_step(model, mods)
        return embed_fns[mods]

    tag = checkpoint_cache_tag(model, f"{args.cache_tag}_ep{host.get('epoch', 0)}",
                               step=int(state.step), config=config,
                               weighted=args.fusion_mode == "weighted")
    rerank = None
    if args.rerank:
        rerank = {"top_n": args.rerank_top_n, "k1": args.rerank_k1, "k2": args.rerank_k2,
                  "lam": args.rerank_lambda}
    result = evaluate_protocol(
        None, dataset, tokenizer, batch_size=batch_size,
        include_patterns=None,  # the full MM-1..4 protocol
        exclude_same_image=args.exclude_same_image, cache=GalleryCache(args.cache_dir, tag),
        sample_ratio=args.sample_ratio, seed=config.seed, embed_factory=embed_factory,
        sharding=mesh, mesh=mesh, rerank=rerank, device=dev)
    print(json.dumps(result, indent=2, default=float))

    if args.submission:
        n = export_submission_csv(
            None, dataset, tokenizer, args.submission, batch_size=batch_size,
            top_k=args.topk if args.topk is not None else config.rank_topk, seed=config.seed,
            embed_factory=embed_factory, mesh=mesh, sharding=mesh, rerank=rerank, device=dev)
        logging.info("submission: %d rows -> %s", n, args.submission)
    return result


if __name__ == "__main__":
    main()
