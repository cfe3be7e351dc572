#!/usr/bin/env python3
"""Serving mode: a frozen-weight embedding server over a checkpoint of the
port's trainer (the PyTorch port's counterpart of ``tools/serve_embed.py``,
with its functions, routes and flags).

One checkpoint load, one embed step per modality combo built once and
reused, batches of ``--batch_size`` (default the checkpoint config's
``inference_batch_size``), L2-normalised f32 output.

    python3 tools_torch/serve_embed.py --model_path ./checkpoints/best \\
        --images 'gallery/*.jpg' --modality vis --out feats.npz
    python3 tools_torch/serve_embed.py --model_path ... --text captions.txt --out t.npz
    python3 tools_torch/serve_embed.py --model_path ... --benchmark   # embeds/s
    python3 tools_torch/serve_embed.py --model_path ... --serve 8787  # HTTP server
    python3 tools_torch/serve_embed.py --model_path ... --serve 8787 \\
        --serve_gallery feats.npz  # + retrieval over that gallery

HTTP API (``--serve PORT``):
    GET  /healthz             -> {"status": "ok", "fusion_dim": ..., ...}
    POST /embed               -> {"embeddings": [[...]], "count": N}
        body {"texts": ["caption", ...]}                       (text tower)
        body {"images_b64": ["<base64 jpeg/png>", ...],
              "modality": "vis"|"nir"|"sk"|"cp"}               (vision)
        body {"queries": [{"nir": "<b64>", "sk": "<b64>",
              "text": "caption"}, ...]}          (MM-2/3/4 combo queries,
              each fused through the embed step of its own modality set)
    POST /search              -> {"results": [[{"id", "score"}, ...]], ...}
        same body as /embed + optional "top_k" (default 10): ranks the
        queries against the gallery by cosine on the device; optional
        "rerank": true re-scores the top-N head by k-reciprocal re-ranking
        (--search_rerank_* parameters; the score is then the fused
        similarity)
    POST /gallery/add         -> {"added": N, "gallery_size": G}
        same body as /embed + "ids": [str, ...]: embeds and enrolls the rows
        (a missing --serve_gallery path starts an empty gallery)
    POST /gallery/remove      -> {"removed": N, "gallery_size": G}
        body {"ids": [str, ...]}: drops every row with a matching id
    POST /gallery/save        -> {"saved": path, "gallery_size": G}
        atomically rewrites the --serve_gallery npz (the path is server-side)
    POST /admin/reload        -> {"reloaded": true, "weights_fingerprint": f}
        re-reads the --model_path checkpoint and swaps the served weights;
        in-flight requests finish on the weights they started on, and no
        kernel is built again (the kernels take the weights as arguments)
    GET  /metrics             -> Prometheus text exposition
        request counts and latency sums by route and status code, batcher
        dispatch and request totals, gallery size, reload count

Choices that differ from the JAX tool on purpose:

- Image batches reach the model as **uint8**, so the model normalises them
  as the dataset evaluation's batches; the JAX engine writes the uint8
  pixels into a float32 buffer, which its model takes as already
  normalised.
- A search neither pads the query batch nor rounds ``top_k`` up to a power
  of two (JAX buckets them against XLA recompiles; rows are independent and
  an eager product needs no static shape).  Embed batches are still padded
  to the batch size: every batch has one shape, so an image's feature does
  not depend on the requests it was coalesced with.

Every thread of the server (the batcher's and the request threads) runs on
the card's default stream, so the kernels of an embed, a search and a
gallery write run in the order they are issued.  The entry points run on the
CUDA card; ``main(argv, device="cpu")`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import collections
import glob as globlib
import json
import logging
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OVERRIDE_FIELDS = ("block_impl", "attn_backend", "gelu_impl")


def _load_model(model_path, block_impl=None, attn_backend=None, gelu_impl=None,
                device="cuda"):
    """-> (config, model): the checkpoint's config with the serving-only
    compute-path overrides applied (each changes the path, never the weights;
    one the checkpoint's trunk cannot run raises ValueError) and its eval
    model with every weight restored."""
    from prcv2025reid_tpu_torch import engine

    overrides = {k: v for k, v in zip(OVERRIDE_FIELDS, (block_impl, attn_backend, gelu_impl))
                 if v is not None}
    config, model, _, _ = engine.load_checkpoint_model(model_path, device, **overrides)
    return config, model


Engine = collections.namedtuple(
    "Engine",
    ["embed_pils", "embed_texts", "embed_paths", "embed_queries", "reload"],
)


def make_engine(config, model, batch_size, fusion_mode="model"):
    """Batch embedding callables over a loaded model (an ``Engine``):
    ``embed_pils(images, modality)``, ``embed_texts(captions)``,
    ``embed_paths(paths, modality)`` and ``embed_queries(query_dicts)`` for
    MM-2/3/4 combo queries; each returns L2-normalised f32 [N, fusion_dim]
    as numpy.  One embed step per modality combo, built on first use and
    reused.  ``fusion_mode="weighted"`` fuses multi-modal queries by the
    weighted sum of the per-modality embeddings (text 1.2), as the eval
    CLI's ``--fusion_mode``.  ``reload(new_model)`` swaps the served model."""
    import numpy as np
    import torch

    from prcv2025reid_tpu_torch import engine as port_engine
    from prcv2025reid_tpu_torch.data.augment import ImageTransform

    if fusion_mode not in ("model", "weighted"):
        raise ValueError(f"unknown fusion_mode {fusion_mode!r}")
    B = batch_size
    vis_mods = tuple(config.vision_modalities)
    Mv, S = len(vis_mods), config.image_size
    tf = ImageTransform(image_size=S, train=False)
    # hot reload swaps this one entry, (model, its embed steps).  Each embed_*
    # call reads it once, so its batches never mix two sets of weights, and
    # a call in flight keeps the old model alive until it returns.
    box = [(model, {})]

    def _step(snap, mods):
        model, steps = snap
        if mods not in steps:
            # weighted sum only changes a true multi-modal combo (a single
            # modality is the same step either way), as the eval CLI
            if fusion_mode == "weighted" and len(mods) > 1:
                steps[mods] = port_engine.make_weighted_embed_step(model, mods)
            else:
                steps[mods] = port_engine.make_combo_embed_step(model, mods)
        return steps[mods]

    def _empty():
        return np.zeros((0, config.fusion_dim), np.float32)

    def _run(snap, mods, pixels, image_mask, texts=None, text_mask=None):
        """One padded batch: ``pixels`` {slot: uint8 [B, S, S, 3]} (only the
        slots in use cross to the device), ``image_mask`` [B, Mv]."""
        dev = snap[0].null_tokens.device
        images = torch.zeros((B, Mv, S, S, 3), dtype=torch.uint8, device=dev)
        for slot, x in pixels.items():
            images[:, slot] = torch.from_numpy(x).to(dev)
        args = [images, torch.from_numpy(image_mask).to(dev)]
        if "text" in mods:
            args += [torch.from_numpy(_tokenizer()(texts).astype(np.int32)).to(dev),
                     torch.from_numpy(text_mask).to(dev)]
        return _step(snap, mods)(*args).cpu().numpy()

    def embed_pils(pil_images, modality):
        slot = vis_mods.index(modality)
        snap = box[0]
        feats = []
        for start in range(0, len(pil_images), B):
            chunk = pil_images[start:start + B]
            x = np.zeros((B, S, S, 3), np.uint8)
            mask = np.zeros((B, Mv), np.float32)
            for i, im in enumerate(chunk):
                x[i] = tf(im.convert("RGB"))
                mask[i, slot] = 1.0
            feats.append(_run(snap, (modality,), {slot: x}, mask)[:len(chunk)])
        return np.concatenate(feats) if feats else _empty()

    def embed_paths(paths, modality):
        """Chunked file embedding: at most one batch of images is open at a
        time (a gallery can exceed the open-file limit)."""
        from PIL import Image

        feats = []
        for start in range(0, len(paths), B):
            chunk = [Image.open(p) for p in paths[start:start + B]]
            feats.append(embed_pils(chunk, modality))
            for im in chunk:
                im.close()
        return np.concatenate(feats) if feats else _empty()

    tokenizer_box = []

    def _tokenizer():
        from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer

        if not tokenizer_box:
            tokenizer_box.append(build_tokenizer(config.tokenizer_vocab_path,
                                                 config.text_vocab_size,
                                                 config.text_context_length))
        return tokenizer_box[0]

    def embed_texts(captions):
        snap = box[0]
        feats = []
        for start in range(0, len(captions), B):
            chunk = list(captions[start:start + B])
            n = len(chunk)
            tmask = np.zeros((B,), np.float32)
            tmask[:n] = 1.0
            feats.append(_run(snap, ("text",), {}, np.zeros((B, Mv), np.float32),
                              chunk + [""] * (B - n), tmask)[:n])
        return np.concatenate(feats) if feats else _empty()

    def embed_queries(query_dicts):
        """Multi-modal combo queries, each ``{"vis"/"nir"/"sk"/"cp":
        PIL.Image, "text": str}`` (the MM-2/3/4 query shape).  Each row goes
        through the step of its OWN modality set; -> [N, fusion_dim] in
        input order."""
        out = np.zeros((len(query_dicts), config.fusion_dim), np.float32)
        snap = box[0]
        by_combo = {}
        for i, q in enumerate(query_dicts):
            mods = tuple(m for m in (*vis_mods, "text") if m in q)
            if not mods:
                raise ValueError("query dict has no known modality keys")
            by_combo.setdefault(mods, []).append(i)
        for mods, rows in by_combo.items():
            slots = [vis_mods.index(m) for m in mods if m != "text"]
            for start in range(0, len(rows), B):
                chunk = rows[start:start + B]
                pixels = {s: np.zeros((B, S, S, 3), np.uint8) for s in slots}
                imask = np.zeros((B, Mv), np.float32)
                texts, tmask = [""] * B, np.zeros((B,), np.float32)
                for bi, ri in enumerate(chunk):
                    q = query_dicts[ri]
                    for s in slots:
                        pixels[s][bi] = tf(q[vis_mods[s]].convert("RGB"))
                        imask[bi, s] = 1.0
                    if "text" in q:
                        texts[bi], tmask[bi] = str(q["text"]), 1.0
                out[np.asarray(chunk)] = _run(snap, mods, pixels, imask, texts,
                                              tmask)[:len(chunk)]
        return out

    def reload(new_model):
        """Serve ``new_model`` from the next call on; calls in flight finish
        on the model they started with, which is freed after the last one."""
        box[0] = (new_model, {})

    return Engine(embed_pils, embed_texts, embed_paths, embed_queries, reload)


class MicroBatcher:
    """Coalesces concurrent embed requests into shared device batches.

    Every request enqueues ``(group_key, items)`` and ONE dispatcher thread
    drains the queue: while a batch is on the device, newly arrived
    same-group requests pile up and the next drain embeds them together
    (no added latency when idle, batch-sized coalescing under load).
    Groups: ``("texts",)``, ``("images", modality)`` and ``("queries",)``;
    different groups never mix."""

    def __init__(self, engine, max_items):
        import queue as queuelib
        import threading
        from concurrent.futures import Future

        self._Future = Future
        self._embed_pils = engine[0]
        self._embed_texts = engine[1]
        self._embed_queries = engine[3] if len(engine) > 3 else None
        self._q = queuelib.Queue()
        self._empty = queuelib.Empty
        self._max = max(1, max_items)
        self.dispatches = 0  # batches sent to the device
        self.requests = 0  # requests served (>= dispatches under load)
        t = threading.Thread(target=self._run, daemon=True, name="serve-embed-batcher")
        t.start()

    def submit(self, key, items):
        """-> Future resolving to the [len(items), fusion_dim] features."""
        fut = self._Future()
        self._q.put((key, items, fut))
        return fut

    def _call(self, key, items):
        if key[0] == "texts":
            return self._embed_texts(items)
        if key[0] == "queries":
            # mixed combos coalesce fine: embed_queries groups by combo
            return self._embed_queries(items)
        return self._embed_pils(items, key[1])

    def _run(self):
        while True:
            key, items, fut = self._q.get()
            group = [(items, fut)]
            n = len(items)
            requeue = []
            # coalesce same-group requests that queued up meanwhile, up to
            # one device batch; the others go back in arrival order
            while n < self._max:
                try:
                    k2, it2, f2 = self._q.get_nowait()
                except self._empty:
                    break
                if k2 == key and n + len(it2) <= self._max:
                    group.append((it2, f2))
                    n += len(it2)
                else:
                    requeue.append((k2, it2, f2))
            for entry in requeue:
                self._q.put(entry)
            try:
                feats = self._call(key, [x for it, _ in group for x in it])
            except BaseException as e:  # noqa: BLE001 (delivered per request)
                for _, f in group:
                    f.set_exception(e)
                if not isinstance(e, Exception):  # an exit or interrupt ends the thread
                    raise
                continue
            self.dispatches += 1
            self.requests += len(group)
            off = 0
            for it, f in group:
                f.set_result(feats[off:off + len(it)])
                off += len(it)


def load_gallery(path):
    """A features .npz as written by --out -> (feats [G, D] f32, ids [G]).

    The features are renormalised: ranking takes unit rows (cosine = dot),
    and a file made elsewhere may not hold them."""
    import numpy as np

    z = np.load(path, allow_pickle=False)
    feats = np.asarray(z["features"], np.float32)
    ids = [str(x) for x in z["ids"]]
    if feats.ndim != 2 or feats.shape[0] != len(ids):
        raise ValueError(f"gallery npz malformed: features {feats.shape} vs {len(ids)} ids")
    feats /= np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    return feats, ids


class GalleryStore:
    """Mutable serving gallery on the device.

    Identities can be added and removed while serving.  The features live in
    an f32 ``[C, D]`` device buffer whose capacity C doubles from
    ``min_capacity``; the rows past the live size are zeros.  Mutations
    serialise under a lock and publish an immutable snapshot ``(buffer, ids,
    size)``; a search reads the snapshot and takes no lock.

    An append that fits the capacity writes only the new rows, in place,
    into the buffer's dead region.  A search in flight cannot see them: it
    ranks only the first ``size`` rows of its own snapshot, except a
    re-ranking whose head is wider than the gallery, which masks every
    column at or past its size at -inf (such a row never ranks and never
    enters a neighbourhood, whatever it holds).  The write is issued on the
    same stream as the searches (the default stream), and no live row is
    ever written in place.  Removal and growth build a new buffer."""

    def __init__(self, dim, feats=None, ids=(), path=None, min_capacity=128, device="cuda"):
        import threading

        import numpy as np

        from prcv2025reid_tpu_torch.engine import resolve_device

        self.dim = int(dim)
        self.path = path
        self.device = resolve_device(device)
        self._min_capacity = max(1, int(min_capacity))
        self._lock = threading.Lock()
        self._feats = np.zeros((0, self.dim), np.float32)
        self._ids = []
        self._snap = None  # (buffer [C, D] on the device, ids tuple, size)
        if feats is not None:
            self.add(feats, ids)
        else:
            self._publish()

    @property
    def size(self):
        return self._snap[2]

    @property
    def capacity(self):
        return int(self._snap[0].shape[0])

    def _publish(self, new_rows=0):
        """Publish a new snapshot (the caller holds the lock, or is the
        constructor).  ``new_rows``: the count of rows just appended; at an
        unchanged capacity only they move to the device."""
        import numpy as np
        import torch

        n = len(self._ids)
        cap = self._min_capacity
        while cap < n:
            cap *= 2
        if new_rows and self._snap is not None and cap == self.capacity:
            buf = self._snap[0]
            buf[n - new_rows:n] = torch.from_numpy(self._feats[n - new_rows:]).to(self.device)
            self._snap = (buf, tuple(self._ids), n)
            return
        padded = np.zeros((cap, self.dim), np.float32)
        padded[:n] = self._feats
        self._snap = (torch.from_numpy(padded).to(self.device), tuple(self._ids), n)

    def add(self, feats, ids):
        """Append rows (an id may repeat: a person may have many gallery
        images); returns the new size."""
        import numpy as np

        feats = np.asarray(feats, np.float32)
        ids = [str(i) for i in ids]
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"features must be [N, {self.dim}], got {feats.shape}")
        if feats.shape[0] != len(ids):
            raise ValueError(f"{feats.shape[0]} features vs {len(ids)} ids")
        # ranking takes unit rows
        feats = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
        with self._lock:
            self._feats = np.concatenate([self._feats, feats])
            self._ids.extend(ids)
            self._publish(new_rows=feats.shape[0])
            return len(self._ids)

    def remove(self, ids):
        """Remove EVERY row whose id is in ``ids``; returns the removed count."""
        import numpy as np

        drop = {str(i) for i in ids}
        with self._lock:
            keep = [j for j, i in enumerate(self._ids) if i not in drop]
            removed = len(self._ids) - len(keep)
            if removed:
                self._feats = self._feats[np.asarray(keep, np.int64)] if keep \
                    else np.zeros((0, self.dim), np.float32)
                self._ids = [self._ids[j] for j in keep]
                self._publish()
            return removed

    def save(self, path=None):
        """Atomic npz write (the schema of --out and load_gallery)."""
        import numpy as np

        path = path or self.path
        if not path:
            raise ValueError("no save path: construct with path= or pass one")
        with self._lock:
            feats, ids = self._feats.copy(), list(self._ids)
        # np.savez appends .npz to a name without it: keep the suffix
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, features=feats, ids=np.asarray(ids, dtype=str))
        os.replace(tmp, path)
        return path

    def search(self, query_feats, top_k, rerank=None):
        """-> [N] lists of {"id", "score"}, best first.

        Plain: the f32 cosine (TF32 off) against the live rows, then
        ``stable_topk`` (ties to the lower gallery position).  ``rerank`` (a
        dict of top_n / k1 / k2 / lam): k-reciprocal re-ranking of each
        query's cosine top-N head, the score then being the fused similarity
        ``1 - final_dist``.  While the gallery is smaller than ``top_n`` the
        head is the live size's ceiling power of two (at most the capacity):
        every live row is reachable, and the padded slots ride along as
        invalid candidates that rank last."""
        import numpy as np
        import torch

        from prcv2025reid_tpu_torch.evaluation.protocol import similarity
        from prcv2025reid_tpu_torch.evaluation.rerank import _rerank_full, stable_topk

        g, ids, n = self._snap  # a consistent snapshot, no lock
        nq = int(np.asarray(query_feats).shape[0])
        if n == 0:
            return [[] for _ in range(nq)]
        k = max(1, min(int(top_k), n))
        q = torch.as_tensor(np.asarray(query_feats, np.float32), device=g.device)
        if rerank and n >= 2:
            top_n = int(rerank.get("top_n", 100))
            if n >= top_n:
                cand = top_n
            else:
                cand = 1
                while cand < n:
                    cand *= 2
                cand = min(cand, int(g.shape[0]))
            k = min(k, cand)  # the re-ranked head is the result set
            k1 = min(int(rerank.get("k1", 20)), cand)
            k2 = min(int(rerank.get("k2", 6)), k1 + 1)
            lam = float(rerank.get("lam", 0.3))
            if cand <= n:  # the live rows alone, as rerank_orders ranks a gallery
                ranked, fused = _rerank_full(q, g[:n], None, None, lam, k1, k2, cand)
            else:  # columns past the live size score -inf: invalid candidates
                ranked, fused = _rerank_full(q, g, None, n, lam, k1, k2, cand)
            idx = ranked[:, :k].cpu().numpy()
            scores = (1.0 - fused[:, :k]).cpu().numpy()
        else:
            scores, idx = stable_topk(similarity(q, g[:n]), k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return [[{"id": ids[int(j)], "score": float(s)} for j, s in zip(row_i, row_s)]
                for row_i, row_s in zip(idx, scores)]


def make_server(port, host, config, engine, batch_items=None, gallery=None, rerank=None,
                reloader=None):
    """Build (without starting) the HTTP embedding server; see the module
    docstring for the API.  Concurrent requests coalesce into shared device
    batches through :class:`MicroBatcher`.

    ``rerank``: {"top_n", "k1", "k2", "lam", "default": bool}, the server's
    k-reciprocal parameters for /search; a request toggles them with
    ``"rerank": true/false`` (else ``default``).

    ``reloader``: a callable of no arguments that returns a freshly loaded
    model (a server-side closure over the checkpoint path: a client never
    supplies a path); it enables ``POST /admin/reload``."""
    import base64
    import hashlib
    import io
    import threading
    import time as timelib
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import torch
    from PIL import Image

    # the search's f32 products switch TF32 off in a scope (protocol.
    # similarity); the switch is process-wide, so it stays off here and no
    # two request threads can race on restoring it
    torch.backends.cuda.matmul.allow_tf32 = False
    valid_mods = tuple(config.vision_modalities)
    MAX_BODY = 64 * 1024 * 1024  # a batch of b64 images
    batcher = MicroBatcher(engine, batch_items or config.inference_batch_size)
    # /metrics: (route, status) -> [count, total seconds]; unknown client
    # paths count under "other", so a scanner cannot grow the label set
    metrics_lock = threading.Lock()
    route_stats = {}
    reload_count = [0]
    KNOWN_ROUTES = ("/embed", "/search", "/gallery/add", "/gallery/remove", "/gallery/save",
                    "/admin/reload", "/healthz", "/metrics")

    class BadRequest(ValueError):
        pass

    def _parse(req):
        """Validate the payload into a (group_key, items) pair for the
        batcher (raises BadRequest on any client error)."""
        if "texts" in req:
            if not isinstance(req["texts"], list):
                raise BadRequest("'texts' must be a JSON list of strings")
            return ("texts",), [str(t) for t in req["texts"]]
        if "images_b64" in req:
            if not isinstance(req["images_b64"], list):
                raise BadRequest("'images_b64' must be a JSON list")
            mod = req.get("modality", "vis")
            if mod not in valid_mods:
                raise BadRequest(f"modality {mod!r} not in {valid_mods}")
            try:
                imgs = [Image.open(io.BytesIO(base64.b64decode(s, validate=True)))
                        for s in req["images_b64"]]
                for im in imgs:
                    im.load()  # decode errors surface as 400 here
            except Exception as e:
                raise BadRequest(f"undecodable image: {e}") from e
            return ("images", mod), imgs
        if "queries" in req:
            # multi-modal combo queries (MM-2/3/4): each entry is
            # {"nir": "<b64>", "sk": "<b64>", ..., "text": "caption"}
            if not isinstance(req["queries"], list):
                raise BadRequest("'queries' must be a JSON list of objects")
            parsed = []
            for q in req["queries"]:
                if not isinstance(q, dict) or not q:
                    raise BadRequest(
                        "each query must be a non-empty object of "
                        f"modality->payload; modalities: {valid_mods + ('text',)}")
                d = {}
                for k, v in q.items():
                    if k == "text":
                        d["text"] = str(v)
                    elif k in valid_mods:
                        try:
                            im = Image.open(io.BytesIO(base64.b64decode(v, validate=True)))
                            im.load()
                        except Exception as e:
                            raise BadRequest(f"undecodable {k} image: {e}") from e
                        d[k] = im
                    else:
                        raise BadRequest(f"unknown query modality {k!r}; valid: "
                                         f"{valid_mods + ('text',)}")
                parsed.append(d)
            return ("queries",), parsed
        raise BadRequest("body needs 'texts', 'images_b64' or 'queries'")

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            self._last_code = code
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code, text):
            self._last_code = code
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _record(self, t0):
            route = self.path if self.path in KNOWN_ROUTES else "other"
            key = (route, getattr(self, "_last_code", 0))
            with metrics_lock:
                st = route_stats.setdefault(key, [0, 0.0])
                st[0] += 1
                st[1] += timelib.perf_counter() - t0

        def _metrics_text(self):
            with metrics_lock:
                snap = {k: list(v) for k, v in route_stats.items()}
            lines = ["# TYPE reid_requests_total counter"]
            for (route, code), (cnt, _) in sorted(snap.items()):
                lines.append(f'reid_requests_total{{route="{route}",code="{code}"}} {cnt}')
            agg = {}
            for (route, _), (_, secs) in snap.items():
                agg[route] = agg.get(route, 0.0) + secs
            lines.append("# TYPE reid_request_seconds_sum counter")
            for route, secs in sorted(agg.items()):
                lines.append(f'reid_request_seconds_sum{{route="{route}"}} {secs:.6f}')
            lines += [
                "# TYPE reid_batch_dispatches_total counter",
                f"reid_batch_dispatches_total {batcher.dispatches}",
                "# TYPE reid_batch_requests_total counter",
                f"reid_batch_requests_total {batcher.requests}",
                "# TYPE reid_gallery_size gauge",
                f"reid_gallery_size {gallery.size if gallery else 0}",
                "# TYPE reid_weights_reloads_total counter",
                f"reid_weights_reloads_total {reload_count[0]}",
            ]
            return "\n".join(lines) + "\n"

        def do_GET(self):
            t0 = timelib.perf_counter()
            try:
                self._get_inner()
            finally:
                self._record(t0)

        def _get_inner(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "fusion_dim": config.fusion_dim,
                    "modalities": list(valid_mods) + ["text"],
                    "image_size": config.image_size,
                    "batch_dispatches": batcher.dispatches,
                    "batch_requests": batcher.requests,
                    "gallery_size": gallery.size if gallery else 0,
                    "weights_reloads": reload_count[0],
                })
            elif self.path == "/metrics":
                self._send_text(200, self._metrics_text())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            t0 = timelib.perf_counter()
            try:
                self._post_inner()
            finally:
                self._record(t0)

        def _reload(self):
            # a server-side closure over the checkpoint path: a client never
            # supplies a filesystem path
            if reloader is None:
                self._send(404, {"error": "hot reload is not enabled "
                                 "(server started without a reloader)"})
                return
            try:
                new_model = reloader()
            except Exception as e:  # a bad checkpoint is not a crash
                logging.exception("reload failed")
                self._send(500, {"error": f"reload failed: {type(e).__name__}: {e}"})
                return
            engine.reload(new_model)
            kern = new_model.bn_neck.classifier.kernel.detach().float().cpu().numpy()
            with metrics_lock:
                reload_count[0] += 1
            self._send(200, {"reloaded": True,
                             "weights_fingerprint": hashlib.md5(kern.tobytes()).hexdigest()[:10]})

        def _post_inner(self):
            routes = ("/embed", "/search", "/gallery/add", "/gallery/remove", "/gallery/save",
                      "/admin/reload")
            if self.path not in routes:
                self._send(404, {"error": "unknown path"})
                return
            if self.path == "/admin/reload":
                self._reload()
                return
            if self.path != "/embed" and gallery is None:
                self._send(404, {"error": "no gallery loaded — start the server with "
                                 "--serve_gallery feats.npz (a new path starts empty for "
                                 "enrollment)"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY:
                    self._send(413, {"error": f"body exceeds {MAX_BODY} bytes"})
                    return
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(req, dict):
                        raise BadRequest("body must be a JSON object")
                    if self.path == "/gallery/remove":
                        if not isinstance(req.get("ids"), list):
                            raise BadRequest("'ids' must be a JSON list")
                        removed = gallery.remove(req["ids"])
                        self._send(200, {"removed": removed, "gallery_size": gallery.size})
                        return
                    if self.path == "/gallery/save":
                        # a client never chooses the filesystem path (an
                        # arbitrary write on an exposed host): saves go to
                        # the --serve_gallery path only
                        if "path" in req:
                            raise BadRequest("'path' is server-side (--serve_gallery)")
                        try:
                            saved = gallery.save()
                        except ValueError as e:
                            raise BadRequest(str(e)) from e
                        self._send(200, {"saved": saved, "gallery_size": gallery.size})
                        return
                    key, items = _parse(req)
                    if self.path == "/gallery/add":
                        row_ids = req.get("ids")
                        if not isinstance(row_ids, list):
                            raise BadRequest("'ids' must be a JSON list (one per row)")
                        if len(row_ids) != len(items):
                            raise BadRequest(f"{len(items)} rows vs {len(row_ids)} ids")
                    top_k = req.get("top_k", 10)
                    if self.path == "/search" and not (
                            isinstance(top_k, int)
                            and not isinstance(top_k, bool)  # JSON true is int 1
                            and top_k >= 1):
                        raise BadRequest("'top_k' must be a positive integer")
                    want_rr = False
                    if self.path == "/search":
                        want_rr = req.get("rerank", bool(rerank and rerank.get("default")))
                        if not isinstance(want_rr, bool):
                            raise BadRequest("'rerank' must be a JSON boolean")
                        if want_rr and rerank is None:
                            raise BadRequest("re-ranking is not enabled on this server "
                                             "(start with --search_rerank)")
                except (BadRequest, json.JSONDecodeError, UnicodeDecodeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                feats = batcher.submit(key, items).result()
                if self.path == "/gallery/add":
                    size = gallery.add(feats, row_ids)
                    self._send(200, {"added": int(feats.shape[0]), "gallery_size": size})
                    return
                if self.path == "/search":
                    res = gallery.search(feats, top_k, rerank=rerank if want_rr else None)
                    self._send(200, {"results": res, "reranked": want_rr,
                                     "count": int(feats.shape[0])})
                    return
                self._send(200, {"embeddings": feats.tolist(), "count": int(feats.shape[0])})
            except BrokenPipeError:
                pass
            except Exception as e:
                # device and server faults are 500s, not the client's fault
                logging.exception("%s failed", self.path)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *args):
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's listen backlog of 5 resets the connections of a
        # burst of concurrent clients
        request_queue_size = 128

    srv = Server((host, port), Handler)
    srv.batcher = batcher  # for tests and observability
    return srv


def warmup_engine(config, engine, modalities=None):
    """One call of every serving step before the server announces itself, so
    the first requests pay no kernel build (nvcc on first use) and no
    tokenizer load."""
    import numpy as np
    from PIL import Image

    S = config.image_size
    dummy = Image.fromarray(np.zeros((S, S, 3), np.uint8))
    mods = tuple(modalities if modalities is not None else config.vision_modalities)
    for mod in mods:
        engine.embed_pils([dummy], mod)
    engine.embed_texts([""])
    # the full combo (every vision modality + text): the MM-4 query shape
    engine.embed_queries([{**{m: dummy for m in mods}, "text": ""}])


def open_gallery(config, gallery_path, device="cuda"):
    """The --serve_gallery store: the npz's rows, or an empty enrollable
    gallery where the path does not exist yet."""
    if os.path.exists(gallery_path):
        feats, ids = load_gallery(gallery_path)
        if feats.shape[1] != config.fusion_dim:
            raise SystemExit(f"gallery feature dim {feats.shape[1]} != checkpoint fusion_dim "
                             f"{config.fusion_dim}: wrong gallery / checkpoint pairing")
        logging.info("gallery loaded: %d x %d features", *feats.shape)
        return GalleryStore(config.fusion_dim, feats, ids, path=gallery_path, device=device)
    logging.info("gallery path %s does not exist: starting EMPTY for enrollment "
                 "(/gallery/add; /gallery/save writes it)", gallery_path)
    return GalleryStore(config.fusion_dim, path=gallery_path, device=device)


def run_server(port, host, config, engine, warmup="all", gallery_path=None, rerank=None,
               reloader=None, device="cuda"):
    gallery = open_gallery(config, gallery_path, device) if gallery_path else None
    if warmup != "none":
        logging.info("warming the serving steps (all modalities + text)...")
        warmup_engine(config, engine)
    srv = make_server(port, host, config, engine, gallery=gallery, rerank=rerank,
                      reloader=reloader)
    print(json.dumps({"serving": True, "host": host, "port": srv.server_address[1],
                      "gallery_size": gallery.size if gallery else 0}), flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


def benchmark(config, model, B, device):
    """{"embeds_per_sec": the device rate, "embeds_per_sec_serving": one
    host call a batch}, over resident uint8 batches of the gallery modality.
    The device rate is the median of ``iters`` calls' device times
    (``utils.timing.device_ms``: CUDA events, each call queued behind a
    spin kernel; one spin before all the calls would not do, as the host
    stalls once the CUDA queue of pending launches is full and the
    events then read the host's rate); on the CPU both rates are host
    clocks."""
    import numpy as np
    import torch

    from prcv2025reid_tpu_torch.engine import make_combo_embed_step
    from prcv2025reid_tpu_torch.utils.timing import device_ms

    bench_mod = "vis" if "vis" in config.vision_modalities else config.vision_modalities[0]
    slot = list(config.vision_modalities).index(bench_mod)
    Mv, S = len(config.vision_modalities), config.image_size
    iters = 10
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.zeros((B, Mv, S, S, 3), dtype=torch.uint8, device=device)
    images[:, slot] = torch.randint(0, 256, (B, S, S, 3), generator=gen, device=device,
                                    dtype=torch.uint8)
    mask = torch.zeros((B, Mv), device=device)
    mask[:, slot] = 1.0
    step = make_combo_embed_step(model, (bench_mod,))
    cuda = device.type == "cuda"
    for _ in range(2):  # warm: the kernels' build, the allocator
        float(step(images, mask).sum())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(images, mask)
    checksum = float(out.sum())  # the host fetch is the barrier
    serving_rate = B * iters / (time.perf_counter() - t0)
    if cuda:
        device_rate = B / (statistics.median(device_ms(lambda: step(images, mask))
                                             for _ in range(iters)) / 1e3)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(images, mask)
        device_rate = B * iters / (time.perf_counter() - t0)
    if not np.isfinite(checksum):
        raise RuntimeError(f"non-finite benchmark features (checksum {checksum})")
    return {"embeds_per_sec": round(device_rate, 2),
            "embeds_per_sec_serving": round(serving_rate, 2), "batch": B,
            "modality": bench_mod}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_path", required=True, help="checkpoint dir")
    ap.add_argument("--images", default=None, help="glob of image files")
    ap.add_argument("--text", default=None, help="file with one caption per line")
    ap.add_argument("--modality", default="vis",
                    help="one of the checkpoint's config.vision_modalities (checked after the "
                         "checkpoint loads; default 'vis')")
    ap.add_argument("--out", default=None, help="output .npz (features, ids)")
    ap.add_argument("--batch_size", type=int, default=None,
                    help="default = the checkpoint config's inference_batch_size")
    ap.add_argument("--benchmark", action="store_true", help="print embeds/s and exit")
    ap.add_argument("--block_impl", default=None, choices=("xla", "fused", "fused_int8"),
                    help="override the block compute path for serving (default = checkpoint "
                         "config)")
    ap.add_argument("--attn_backend", default=None, choices=("xla", "splash", "onesaug"),
                    help="override the attention core")
    ap.add_argument("--gelu_impl", default=None, choices=("erf", "tanh", "poly"),
                    help="override the GELU formulation")
    ap.add_argument("--fusion_mode", default="model", choices=("model", "weighted"),
                    help="how multi-modal combo queries fuse: the model's fusion module "
                         "(default) or the weighted sum of the per-modality embeddings "
                         "(text 1.2), as the eval CLI's --fusion_mode")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="run the HTTP embedding server (0 = an ephemeral port)")
    ap.add_argument("--serve_host", default="127.0.0.1",
                    help="bind address for --serve (loopback by default)")
    ap.add_argument("--serve_gallery", default=None, metavar="FEATS_NPZ",
                    help="features .npz (from an --images/--out run) to rank against; "
                         "enables POST /search")
    ap.add_argument("--search_rerank", action="store_true",
                    help="re-rank every /search by default (requests override with "
                         "'rerank': false); without it a request may opt in with "
                         "'rerank': true, using the --search_rerank_* parameters")
    ap.add_argument("--search_rerank_top_n", type=int, default=100)
    ap.add_argument("--search_rerank_k1", type=int, default=20)
    ap.add_argument("--search_rerank_k2", type=int, default=6)
    ap.add_argument("--search_rerank_lambda", type=float, default=0.3)
    ap.add_argument("--warmup", default="all", choices=("all", "none"),
                    help="run every serving step once before announcing readiness "
                         "(--serve only)")
    return ap


def main(argv=None, device="cuda"):
    import numpy as np

    from prcv2025reid_tpu_torch.engine import resolve_device

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(device)
    overrides = (args.block_impl, args.attn_backend, args.gelu_impl)
    config, model = _load_model(args.model_path, *overrides, device=dev)
    B = args.batch_size or config.inference_batch_size
    if args.images and args.modality not in config.vision_modalities:
        raise SystemExit(f"--modality {args.modality!r} is not in this checkpoint's "
                         f"vision_modalities {tuple(config.vision_modalities)}")

    if args.benchmark:
        result = benchmark(config, model, B, dev)
        print(json.dumps(result))
        return result

    engine = make_engine(config, model, B, fusion_mode=args.fusion_mode)
    if args.serve is not None:
        rerank = {"top_n": args.search_rerank_top_n, "k1": args.search_rerank_k1,
                  "k2": args.search_rerank_k2, "lam": args.search_rerank_lambda,
                  "default": args.search_rerank}
        del model  # the engine holds it; a reload frees it
        run_server(args.serve, args.serve_host, config, engine, warmup=args.warmup,
                   gallery_path=args.serve_gallery, rerank=rerank,
                   # POST /admin/reload re-reads the --model_path checkpoint
                   # (the same serving-path overrides) and swaps the weights
                   reloader=lambda: _load_model(args.model_path, *overrides, device=dev)[1],
                   device=dev)
        return None

    if args.images:
        paths = sorted(globlib.glob(args.images))
        if not paths:
            raise SystemExit(f"no files match {args.images!r}")
        feats = engine.embed_paths(paths, args.modality)
        ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    elif args.text:
        with open(args.text) as f:
            captions = [line.rstrip("\n") for line in f if line.strip()]
        feats = engine.embed_texts(captions)
        ids = [str(i) for i in range(len(captions))]
    else:
        raise SystemExit("one of --images / --text / --benchmark / --serve is required")

    out = args.out or "embeddings.npz"
    np.savez(out, features=feats, ids=np.asarray(ids))
    logging.info("%d embeddings (%s) -> %s", len(ids), args.modality, out)
    return feats, ids


if __name__ == "__main__":
    main()
