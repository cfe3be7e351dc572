#!/usr/bin/env python3
"""Ahead-of-time serving artifact: ``torch.export`` graph bundles (the
PyTorch port's counterpart of ``tools/export_serving.py``, with its
functions, graph names, errors, ``fusion_mode`` and manifest keys).

The serving CLI (``tools_torch/serve_embed.py``) is a live-Python server;
this tool produces the deployment shape: each serving graph (gallery embed,
text embed, single-modality and full-combo query embeds) exported by
``torch.export.export`` of the port's ``make_combo_embed_step`` /
``make_weighted_embed_step`` (under ``torch.no_grad()``, eval mode) and
saved by ``torch.export.save`` with every parameter of the model lifted into
the file.  The port's kernels enter the graph as the ``prcv_reid::*`` ops of
``prcv2025reid_tpu_torch/ops/library.py``: a bundle exported on the card
runs the hand-written kernels, one exported on the CPU their plain versions.
A consumer needs ``torch.export.load`` and that op library (to register the
ops), no model code, checkpoint loader or config: see
``tools_torch/serve_artifact.py``.

Each graph takes a batch dict (the serving batch schema) and returns
L2-normalised f32 ``[B, fusion_dim]`` features:

    {"images":      uint8 [B, n_mods, S, S, 3],
     "image_mask":  f32 [B, n_mods],
     "text_tokens": i32 [B, context_length],
     "text_mask":   f32 [B]}

The images are uint8, as the port's serving and evaluation feed them (the
model normalises them on the device); JAX's schema has float32 pixels.

Layout of ``--out_dir``:
    manifest.json      {"graphs": {name: {"file", "modalities", "batch",
                        "device", "fusion_dim", "sha256", "bytes"}},
                        "config": {...}}
    <name>.pt2         torch.export.save of the graph
    tokenizer/         the checkpoint's BPE vocab, where it has one

The manifest's ``device`` ("cuda" or "cpu", where the graph was exported
and runs) stands where JAX's has ``platforms``, and ``--cpu`` where JAX's
CLI has ``--platforms``.

Usage:
    python3 tools_torch/export_serving.py --model_path ckpt/best --out_dir art/
    python3 tools_torch/export_serving.py --model_path ... --out_dir art/ --verify
    # consumer side (no model code):
    #   import prcv2025reid_tpu_torch.ops.library  # registers the kernels' ops
    #   ep = torch.export.load("art/gallery_vis.pt2")
    #   feats = ep.module()(batch)
"""
import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _graph_module(model, step):
    """``step`` as an ``nn.Module`` that takes the batch dict; ``model`` is
    a submodule, so every parameter and buffer is lifted into the graph."""
    import torch

    class ServingGraph(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, batch):
            return step(batch["images"], batch["image_mask"], batch["text_tokens"],
                        batch["text_mask"])

    return ServingGraph()


def batch_spec(config, batch_size, device):
    """Zeros in the serving batch schema on ``device`` (the export's example
    inputs; the graphs' shapes are static)."""
    import torch

    B, Mv, S = batch_size, len(config.vision_modalities), config.image_size
    return {
        "images": torch.zeros((B, Mv, S, S, 3), dtype=torch.uint8, device=device),
        "image_mask": torch.zeros((B, Mv), dtype=torch.float32, device=device),
        "text_tokens": torch.zeros((B, config.text_context_length), dtype=torch.int32,
                                   device=device),
        "text_mask": torch.zeros((B,), dtype=torch.float32, device=device),
    }


def resolve_graphs(config, graphs=None):
    """-> {name: modalities tuple} of the requested graphs (default:
    ``gallery_vis``, every single non-vis modality, ``text``, ``quad``);
    ``combo_<mod+mod+...>`` names any other combo; an unknown name exits."""
    mods_by_name = {"gallery_vis": ("vis",), "text": ("text",),
                    "quad": tuple(config.vision_modalities) + ("text",)}
    for m in config.vision_modalities:
        if m != "vis":
            mods_by_name[f"single_{m}"] = (m,)
    names = list(mods_by_name) if graphs is None else list(graphs)
    valid = tuple(config.vision_modalities) + ("text",)
    for n in names:
        # arbitrary combos export as e.g. combo_nir+text (MM-2/3 queries)
        if n.startswith("combo_") and n not in mods_by_name:
            mods = tuple(m for m in valid if m in n[len("combo_"):].split("+"))
            if mods:
                mods_by_name[n] = mods
    unknown = [n for n in names if n not in mods_by_name]
    if unknown:
        raise SystemExit(
            f"unknown graphs {unknown}; available: {sorted(mods_by_name)} "
            "or combo_<mod+mod+...>"
        )
    return {n: mods_by_name[n] for n in names}


def export_graphs(config, model, batch_size, graphs=None, fusion_mode="model"):
    """-> {name: (ExportedProgram, modalities tuple)} for the requested graphs.

    Default graph set: ``gallery_vis`` (the 45k-image volume path), every
    single non-vis modality, ``text``, and ``quad`` (every vision modality
    + text: the MM-4 query).  The graphs run on ``model``'s device and hold
    its weights.  ``fusion_mode="weighted"`` exports multi-modal combos
    through the weighted sum of the per-modality embeddings (text 1.2)
    instead of the model's fusion module (the live server's and the eval
    CLI's rule: single-modality graphs are identical either way)."""
    import torch

    from prcv2025reid_tpu_torch.engine import make_combo_embed_step, make_weighted_embed_step

    if fusion_mode not in ("model", "weighted"):
        raise SystemExit(f"unknown fusion_mode {fusion_mode!r}")
    chosen = resolve_graphs(config, graphs)
    model.eval()
    spec = batch_spec(config, batch_size, model.null_tokens.device)
    out = {}
    for name, mods in chosen.items():
        if fusion_mode == "weighted" and len(mods) > 1:
            step = make_weighted_embed_step(model, mods)
        else:
            step = make_combo_embed_step(model, mods)
        with torch.no_grad():
            out[name] = (torch.export.export(_graph_module(model, step), (spec,)), mods)
    return out


def graph_ops(exported):
    """{op name: count} of the ``prcv_reid::*`` calls in an ExportedProgram."""
    counts = {}
    for node in exported.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("prcv_reid."):
            name = target.split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def write_bundle(out_dir, config, model, batch_size, graphs=None, fusion_mode="model"):
    """Export + write the artifact bundle (manifest.json + *.pt2 + the
    tokenizer vocab when the checkpoint has one); -> the manifest dict.
    The consumer contract is the manifest plus ``torch.export.load`` with
    the op library registered: see tools_torch/serve_artifact.py for a
    full HTTP server running from a bundle alone."""
    import shutil

    import torch

    if fusion_mode not in ("model", "weighted"):
        raise SystemExit(f"unknown fusion_mode {fusion_mode!r}")
    os.makedirs(out_dir, exist_ok=True)
    # self-contained text path: a trained model's captions MUST go through
    # the same BPE vocab it trained with; ship it in the bundle so the
    # consumer cannot silently hash-tokenize (data/tokenizer.py invariant)
    tok_rel = None
    vocab_dir = getattr(config, "tokenizer_vocab_path", None)
    if vocab_dir:
        if os.path.isfile(vocab_dir):
            vocab_dir = os.path.dirname(vocab_dir)
        tok_dir = os.path.join(out_dir, "tokenizer")
        os.makedirs(tok_dir, exist_ok=True)
        for fname in ("vocab.json", "merges.txt"):
            src = os.path.join(vocab_dir, fname)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(tok_dir, fname))
                tok_rel = "tokenizer"
    device = model.null_tokens.device.type
    manifest = {"graphs": {}, "config": {
        "fusion_dim": config.fusion_dim,
        "image_size": config.image_size,
        "vision_modalities": list(config.vision_modalities),
        "text_context_length": config.text_context_length,
        "text_vocab_size": config.text_vocab_size,
        "block_impl": config.block_impl,
        "attn_backend": config.attn_backend,
        "gelu_impl": config.gelu_impl,
        "fusion_mode": fusion_mode,
        "tokenizer": tok_rel,
    }}
    for name in resolve_graphs(config, graphs):  # one at a time: one graph in memory
        t0 = time.perf_counter()
        (ex, mods), = export_graphs(config, model, batch_size, graphs=[name],
                                    fusion_mode=fusion_mode).values()
        fname = f"{name}.pt2"
        path = os.path.join(out_dir, fname)
        torch.export.save(ex, path)
        seconds = time.perf_counter() - t0
        with open(path, "rb") as f:
            blob = f.read()
        manifest["graphs"][name] = {
            "file": fname,
            "modalities": list(mods),
            "batch": batch_size,
            "device": device,
            "fusion_dim": config.fusion_dim,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob),
        }
        print(json.dumps({"exported": name, "bytes": len(blob), "seconds": round(seconds, 3),
                          "ops": graph_ops(ex)}))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def verify_bundle(out_dir, manifest, config, model, fusion_mode="model", seed=0):
    """Load every graph of a written bundle from disk, run it on random
    inputs and hold it to the live step (atol 1e-6); -> {name: max abs err}."""
    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.engine import make_combo_embed_step, make_weighted_embed_step

    rng = np.random.default_rng(seed)
    dev = model.null_tokens.device
    errs = {}
    for name, meta in manifest["graphs"].items():
        B, Mv, S = meta["batch"], len(config.vision_modalities), config.image_size
        batch = {
            "images": torch.from_numpy(
                rng.integers(0, 256, size=(B, Mv, S, S, 3), dtype=np.uint8)).to(dev),
            "image_mask": torch.from_numpy(
                (rng.random((B, Mv)) > 0.5).astype(np.float32)).to(dev),
            "text_tokens": torch.from_numpy(rng.integers(
                0, config.text_vocab_size, size=(B, config.text_context_length),
                dtype=np.int32)).to(dev),
            "text_mask": torch.ones((B,), dtype=torch.float32, device=dev),
        }
        ep = torch.export.load(os.path.join(out_dir, meta["file"]))
        with torch.no_grad():
            got = ep.module()(batch).cpu().numpy()
        mods = tuple(meta["modalities"])
        if fusion_mode == "weighted" and len(mods) > 1:
            step = make_weighted_embed_step(model, mods)
        else:
            step = make_combo_embed_step(model, mods)
        want = step(*batch.values()).cpu().numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
        errs[name] = float(np.abs(got - want).max())
        print(json.dumps({"verified": name, "max_abs_err": errs[name]}))
    print(json.dumps({"verify": "ok", "graphs": len(manifest["graphs"])}))
    return errs


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_path", required=True, help="checkpoint dir")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument(
        "--batch_size", type=int, default=None,
        help="static batch of the exported graphs (default = checkpoint "
        "config.inference_batch_size)",
    )
    ap.add_argument(
        "--graphs", default=None,
        help="comma list (default: gallery_vis, every single non-vis "
        "modality, text, quad)",
    )
    ap.add_argument(
        "--block_impl", default=None, choices=("xla", "fused", "fused_int8"),
    )
    ap.add_argument(
        "--attn_backend", default=None, choices=("xla", "splash", "onesaug"),
        help="serving-path override",
    )
    ap.add_argument(
        "--gelu_impl", default=None, choices=("erf", "tanh", "poly"),
    )
    ap.add_argument(
        "--fusion_mode", default="model", choices=("model", "weighted"),
        help="multi-modal combo fusion: the model's fusion module (default) "
        "or the weighted sum of the per-modality embeddings (text 1.2), as "
        "the live server's --fusion_mode",
    )
    ap.add_argument(
        "--verify", action="store_true",
        help="after writing: load every artifact from disk, run it on random "
        "inputs, and require agreement with the live model (atol 1e-6)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="export on the CPU (the graphs then run the kernels' plain "
                    "versions); default: the CUDA card")
    args = ap.parse_args(argv)

    import importlib.util

    from prcv2025reid_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else device)
    spec = importlib.util.spec_from_file_location(
        "serve_embed",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "serve_embed.py"),
    )
    serve_embed = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_embed)

    config, model = serve_embed._load_model(
        args.model_path, args.block_impl, args.attn_backend, args.gelu_impl, device=dev
    )
    B = args.batch_size or config.inference_batch_size
    graphs = args.graphs.split(",") if args.graphs else None
    manifest = write_bundle(args.out_dir, config, model, B, graphs=graphs,
                            fusion_mode=args.fusion_mode)
    if args.verify:
        verify_bundle(args.out_dir, manifest, config, model, args.fusion_mode)
    return manifest


if __name__ == "__main__":
    main()
