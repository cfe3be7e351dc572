#!/usr/bin/env python3
"""Serve from an AOT artifact bundle: no model code, config or checkpoint
(the PyTorch port's counterpart of ``tools/serve_artifact.py``).

``tools_torch/export_serving.py`` writes serving graphs as
``torch.export.save`` files holding their weights; this tool is the consumer
side: it stands up the SAME HTTP API as ``tools_torch/serve_embed.py
--serve`` (micro-batched /embed, /search with optional re-ranking, gallery
enrollment, /metrics) from the bundle alone.  The loaded
``ExportedProgram`` graphs ARE the model: the process imports the port's op
library (``ops/library.py``, which registers the kernels' ``prcv_reid::*``
ops the graphs call), its host data modules and the HTTP layer, and none of
``prcv2025reid_tpu_torch.models``, ``.engine``, ``.params`` or
``.training``, so it cannot drift from the graphs that were exported and
verified.  Host-side preprocessing (PIL resize, CLIP BPE tokenization) is
shared with the live server.  The graphs run on the device they were
exported on (the manifest's ``device``): a card bundle needs the card.

Routing: texts -> the ``text`` graph; single-modality images ->
``gallery_vis`` / ``single_<mod>``; MM combo queries -> the graph whose
modality set matches exactly (``quad`` by default; export others with
``--graphs combo_nir+text,...``).  A combo without a matching graph is a
clean client error listing what the bundle provides.

Usage:
    python3 tools_torch/export_serving.py --model_path ckpt/best --out_dir art/
    python3 tools_torch/serve_artifact.py --artifact_dir art/ --serve 8787 \\
        --tokenizer_vocab /ckpts/clip-vit-base-patch16 \\
        [--serve_gallery feats.npz] [--search_rerank ...]
"""
import argparse
import importlib.util
import json
import logging
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_serve_embed():
    spec = importlib.util.spec_from_file_location(
        "serve_embed",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "serve_embed.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph_call(exported, device):
    """The loaded graph as ``call(batch) -> f32 [B, fusion_dim]`` tensor on
    ``device``; ``batch`` holds numpy arrays or tensors of the schema."""
    import numpy as np
    import torch

    module = exported.module()

    def call(batch):
        inputs = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                     device=device) for k, v in batch.items()}
        with torch.no_grad():
            return module(inputs)

    return call


def load_bundle(artifact_dir):
    """-> (config shim, {name: {"call", "modalities", "batch"}}).

    The shim carries only what the HTTP layer and preprocessing need
    (modalities, dims, batch): there is deliberately no TrainingConfig
    here: the bundle is the whole contract."""
    import torch

    import prcv2025reid_tpu_torch.ops.library  # noqa: F401 (registers the graphs' ops)
    from prcv2025reid_tpu_torch.utils.device import resolve_device

    with open(os.path.join(artifact_dir, "manifest.json")) as f:
        manifest = json.load(f)
    cfg = manifest["config"]
    graphs = {}
    for name, meta in manifest["graphs"].items():
        device = resolve_device(meta["device"])
        ep = torch.export.load(os.path.join(artifact_dir, meta["file"]))
        graphs[name] = {"call": _graph_call(ep, device), "modalities": tuple(meta["modalities"]),
                        "batch": int(meta["batch"]), "device": device}
    tok_rel = cfg.get("tokenizer")
    config = types.SimpleNamespace(
        vision_modalities=tuple(cfg["vision_modalities"]),
        fusion_dim=int(cfg["fusion_dim"]),
        image_size=int(cfg["image_size"]),
        text_context_length=int(cfg["text_context_length"]),
        text_vocab_size=int(cfg.get("text_vocab_size", 49408)),
        inference_batch_size=min(g["batch"] for g in graphs.values()),
        tokenizer_vocab_path=(
            os.path.join(artifact_dir, tok_rel) if tok_rel else None
        ),
    )
    return config, graphs


def make_artifact_engine(config, graphs, tokenizer_vocab=None):
    """An ``Engine`` (serve_embed namedtuple) whose embed functions run the
    loaded graphs on uint8 batches padded to each graph's batch, as the live
    engine's.  ``reload`` raises: swap the bundle, not the weights (the
    artifact is immutable by design)."""
    import numpy as np

    from prcv2025reid_tpu_torch.data.augment import ImageTransform
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer

    serve_embed = _load_serve_embed()
    Mv, S = len(config.vision_modalities), config.image_size
    tf = ImageTransform(image_size=S, train=False)
    by_mods = {g["modalities"]: name for name, g in graphs.items()}

    def _graph_for(mods):
        name = by_mods.get(tuple(mods))
        if name is None:
            raise ValueError(
                f"no exported graph for modality set {tuple(mods)}; bundle "
                f"provides {sorted(by_mods)}: re-export with "
                f"--graphs combo_{'+'.join(mods)}"
            )
        return graphs[name]

    tokenizer_box = []

    def _tokenizer():
        if not tokenizer_box:
            vocab = tokenizer_vocab or getattr(config, "tokenizer_vocab_path", None)
            if vocab is None:
                logging.getLogger(__name__).warning(
                    "no tokenizer vocab in the bundle or --tokenizer_vocab: text "
                    "requests will HASH-tokenize, which is only valid for models "
                    "trained the same way"
                )
            tokenizer_box.append(build_tokenizer(
                vocab, config.text_vocab_size, config.text_context_length,
            ))
        return tokenizer_box[0]

    def _empty():
        return np.zeros((0, config.fusion_dim), np.float32)

    def _run(g, images, image_mask, tokens, text_mask):
        batch = {"images": images, "image_mask": image_mask,
                 "text_tokens": tokens, "text_mask": text_mask}
        return g["call"](batch).cpu().numpy()

    def embed_pils(pil_images, modality):
        slot = list(config.vision_modalities).index(modality)
        g = _graph_for((modality,))
        B = g["batch"]
        feats = []
        for start in range(0, len(pil_images), B):
            chunk = pil_images[start:start + B]
            n = len(chunk)
            imgs = np.zeros((B, Mv, S, S, 3), np.uint8)
            mask = np.zeros((B, Mv), np.float32)
            for i, im in enumerate(chunk):
                imgs[i, slot] = tf(im.convert("RGB"))
                mask[i, slot] = 1.0
            feats.append(_run(
                g, imgs, mask,
                np.zeros((B, config.text_context_length), np.int32),
                np.zeros((B,), np.float32),
            )[:n])
        return np.concatenate(feats) if feats else _empty()

    def embed_paths(paths, modality):
        from PIL import Image

        g = _graph_for((modality,))
        feats = []
        for start in range(0, len(paths), g["batch"]):
            chunk = [Image.open(p) for p in paths[start:start + g["batch"]]]
            feats.append(embed_pils(chunk, modality))
            for im in chunk:
                im.close()
        return np.concatenate(feats) if feats else _empty()

    def embed_texts(captions):
        tokenizer = _tokenizer()
        g = _graph_for(("text",))
        B = g["batch"]
        feats = []
        for start in range(0, len(captions), B):
            chunk = list(captions[start:start + B])
            n = len(chunk)
            padded = chunk + [""] * (B - n)
            feats.append(_run(
                g,
                np.zeros((B, Mv, S, S, 3), np.uint8),
                np.zeros((B, Mv), np.float32),
                tokenizer(padded).astype(np.int32),
                np.asarray([1.0] * n + [0.0] * (B - n), np.float32),
            )[:n])
        return np.concatenate(feats) if feats else _empty()

    def embed_queries(query_dicts):
        out = np.zeros((len(query_dicts), config.fusion_dim), np.float32)
        by_combo = {}
        for i, q in enumerate(query_dicts):
            mods = tuple(m for m in (*config.vision_modalities, "text") if m in q)
            if not mods:
                raise ValueError("query dict has no known modality keys")
            by_combo.setdefault(mods, []).append(i)
        tokenizer = _tokenizer()
        for mods, rows in by_combo.items():
            g = _graph_for(mods)
            B = g["batch"]
            for start in range(0, len(rows), B):
                chunk = rows[start:start + B]
                imgs = np.zeros((B, Mv, S, S, 3), np.uint8)
                imask = np.zeros((B, Mv), np.float32)
                texts = [""] * B
                tmask = np.zeros((B,), np.float32)
                for bi, ri in enumerate(chunk):
                    q = query_dicts[ri]
                    for mi, mod in enumerate(config.vision_modalities):
                        if mod in q:
                            imgs[bi, mi] = tf(q[mod].convert("RGB"))
                            imask[bi, mi] = 1.0
                    if "text" in q:
                        texts[bi] = str(q["text"])
                        tmask[bi] = 1.0
                out[np.asarray(chunk)] = _run(
                    g, imgs, imask, tokenizer(texts).astype(np.int32), tmask,
                )[:len(chunk)]
        return out

    def reload(_new_model):
        raise RuntimeError(
            "an artifact bundle is immutable: re-export and restart "
            "(or use the live server, tools_torch/serve_embed.py, for hot reload)"
        )

    return serve_embed.Engine(embed_pils, embed_texts, embed_paths, embed_queries, reload)


def warm_graphs(config, graphs):
    """One call of every graph the bundle has (run_server's warm-up assumes
    the live server's full graph set: a partial bundle is legitimate)."""
    import numpy as np

    Mv, S = len(config.vision_modalities), config.image_size
    for name, g in graphs.items():
        B = g["batch"]
        logging.info("warming %s (batch %d)...", name, B)
        g["call"]({
            "images": np.zeros((B, Mv, S, S, 3), np.uint8),
            "image_mask": np.zeros((B, Mv), np.float32),
            "text_tokens": np.zeros((B, config.text_context_length), np.int32),
            "text_mask": np.zeros((B,), np.float32),
        })


# the port's modules of model code: a consumer loads none of them
MODEL_CODE = ("models", "engine", "params", "training")


def consumer_check(artifact_dir, inputs_json, out_npz, latency_n=0):
    """The consumer path end to end in this process (the tests and the
    card's smoke run start it in a fresh one with ``python -c``):
    ``load_bundle`` and ``warm_graphs``; the engine's embeddings of the
    images and captions that ``inputs_json`` lists (``{"vis": [paths],
    "nir": [paths], "captions": [...]}``, as many of each) saved to
    ``out_npz`` as ``vis``, ``text`` and, where the bundle has their graphs,
    ``nir_text`` and ``quad`` (the nir image standing in for sk and cp); the kernels
    that one vis batch launched; a ``GalleryStore`` of the vis features,
    searched plain and re-ranked; its HTTP server: one /embed, one /search,
    then ``latency_n`` sequential one-image /embed requests.  Prints and
    returns a JSON summary, which lists the port's modules loaded (none of
    ``MODEL_CODE``, by the bundle's contract)."""
    import base64
    import threading
    import time
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from prcv2025reid_tpu_torch.ops import library

    t0 = time.perf_counter()
    config, graphs = load_bundle(artifact_dir)
    engine = make_artifact_engine(config, graphs)
    warm_graphs(config, graphs)
    device = next(iter(graphs.values()))["device"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with open(inputs_json) as f:
        inputs = json.load(f)

    def pil(path):
        with Image.open(path) as im:
            im.load()
            return im.copy()

    vis, nir, captions = ([pil(p) for p in inputs["vis"]], [pil(p) for p in inputs["nir"]],
                          inputs["captions"])
    before = library.launch_counts()
    engine.embed_pils(vis[:graphs["gallery_vis"]["batch"]], "vis")
    if device.type == "cuda":
        torch.cuda.synchronize()
    one_batch = {k: v - before[k] for k, v in library.launch_counts().items() if v != before[k]}
    feats = {"vis": engine.embed_pils(vis, "vis"), "text": engine.embed_texts(captions)}
    provided = {g["modalities"] for g in graphs.values()}
    for key, mods in (("nir_text", ("nir", "text")),
                      ("quad", (*config.vision_modalities, "text"))):
        if mods in provided:
            feats[key] = engine.embed_queries([
                {**{m: vis[i] if m == "vis" else nir[i] for m in mods if m != "text"},
                 "text": captions[i]} for i in range(len(vis))])
    np.savez(out_npz, **feats)

    serve_embed = _load_serve_embed()
    store = serve_embed.GalleryStore(config.fusion_dim, feats["vis"],
                                     [str(i) for i in range(len(vis))], device=device)
    k = min(5, len(vis))
    plain = store.search(feats["text"][:1], k)
    reranked = store.search(feats["text"][:1], k, rerank={"top_n": k, "k1": 1, "k2": 1})
    srv = serve_embed.make_server(0, "127.0.0.1", config, engine, gallery=store)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(route, obj):
        req = urllib.request.Request(url + route, data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    images_b64 = []
    for path in inputs["vis"]:
        with open(path, "rb") as f:
            images_b64.append(base64.b64encode(f.read()).decode())
    emb = post("/embed", {"images_b64": [images_b64[0]], "modality": "vis"})["embeddings"][0]
    hits = post("/search", {"texts": [captions[0]], "top_k": k})["results"][0]
    ms = []
    for i in range(latency_n):
        t = time.perf_counter()
        post("/embed", {"images_b64": [images_b64[i % len(images_b64)]], "modality": "vis"})
        ms.append((time.perf_counter() - t) * 1e3)
    srv.shutdown()
    srv.server_close()
    loaded = sorted(m for m in sys.modules if m.startswith("prcv2025reid_tpu"))
    summary = {
        "load_s": load_s, "graphs": sorted(graphs), "one_vis_batch": one_batch,
        "modules": loaded,
        "model_modules": [m for m in loaded if m.split(".")[1:2] and m.split(".")[1] in MODEL_CODE],
        "embed_dim": len(emb), "search_hits": len(hits),
        "store_hits": [len(plain[0]), len(reranked[0])],
        "embed_equals_engine": bool(np.array_equal(np.asarray(emb, np.float32), feats["vis"][0])),
        "p50_ms": float(np.percentile(ms, 50)) if ms else None,
        "p90_ms": float(np.percentile(ms, 90)) if ms else None, "n": len(ms)}
    print(json.dumps({"bundle_consumer": summary}))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact_dir", required=True,
                    help="bundle from tools_torch/export_serving.py")
    ap.add_argument("--serve", type=int, required=True, metavar="PORT",
                    help="0 = ephemeral port")
    ap.add_argument("--serve_host", default="127.0.0.1")
    ap.add_argument("--tokenizer_vocab", default=None,
                    help="CLIP vocab dir: overrides the vocab shipped "
                    "inside the bundle (export_serving copies the "
                    "checkpoint's vocab in); with neither, text requests "
                    "hash-tokenize (smoke models only, warned loudly)")
    ap.add_argument("--serve_gallery", default=None, metavar="FEATS_NPZ")
    ap.add_argument("--search_rerank", action="store_true")
    ap.add_argument("--search_rerank_top_n", type=int, default=100)
    ap.add_argument("--search_rerank_k1", type=int, default=20)
    ap.add_argument("--search_rerank_k2", type=int, default=6)
    ap.add_argument("--search_rerank_lambda", type=float, default=0.3)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    serve_embed = _load_serve_embed()
    config, graphs = load_bundle(args.artifact_dir)
    logging.info("bundle: %d graphs %s", len(graphs), sorted(graphs))
    engine = make_artifact_engine(config, graphs, tokenizer_vocab=args.tokenizer_vocab)
    rerank = {
        "top_n": args.search_rerank_top_n, "k1": args.search_rerank_k1,
        "k2": args.search_rerank_k2, "lam": args.search_rerank_lambda,
        "default": args.search_rerank,
    }
    warm_graphs(config, graphs)
    device = next(iter(graphs.values()))["device"]
    serve_embed.run_server(
        args.serve, args.serve_host, config, engine,
        warmup="none", gallery_path=args.serve_gallery, rerank=rerank, device=device,
    )


if __name__ == "__main__":
    main()
