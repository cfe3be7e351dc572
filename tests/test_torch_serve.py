"""The port's serving path (``tools_torch/serve_embed.py``) on the CPU: the
engine, the micro-batcher, the gallery store and the HTTP server.

The cases of the JAX package's ``tests/test_serve_server.py`` (all but the
artifact bundle, which is not ported, and the bucketing spy: the port's
search buckets nothing), over a checkpoint written by the port's
``save_checkpoint`` that holds the flat parameters of one JAX init at the
tiny f32 widths of ``TINY_BASE`` (``inference_batch_size`` 4; lora_B,
biases and BN statistics perturbed).  Against the JAX package on the same
weights and the same uint8 pixels: the engine's ``embed_pils``,
``embed_texts`` and ``embed_queries`` (model and weighted fusion) against
JAX's ``make_combo_embed_step`` / ``make_weighted_embed_step`` to 2e-4; the
gallery's search, plain and re-ranked, against JAX's ``GalleryStore.search``
(ids equal, scores to 1e-6); the gallery files read both ways; and the JAX
serving engine's fault (float32 pixels taken as normalised) against the
port's uint8 batches.  Features that go through JSON are compared bit for
bit: a JSON float round trip of an f32 is exact."""
import base64
import dataclasses
import importlib.util
import io
import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.data.augment import ImageTransform as JaxTransform  # noqa: E402
from prcv2025reid_tpu.data.tokenizer import build_tokenizer as jax_build_tokenizer  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu.training import train_step as jax_train_step  # noqa: E402
from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = {**TINY_BASE, "inference_batch_size": 4}
NUM_CLASSES = 3
FEAT_TOL = 2e-4
SCORE_TOL = 1e-6
VIS = ("vis", "nir", "sk", "cp")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


serve_embed = _load("port_serve_embed", "tools_torch/serve_embed.py")
jax_serve = _load("jax_serve_embed", "tools/serve_embed.py")  # imports jax on first use only


def port_config(jcfg, **over):
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


@pytest.fixture(scope="module")
def jax_side():
    """(JAX config, model, variables, the flat parameters) of one JAX init."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
    S, ctx = jcfg.image_size, jcfg.text_context_length
    variables = jax.jit(lambda *a: jmodel.init({"params": jax.random.PRNGKey(0)}, *a,
                                               train=False))(
        jnp.zeros((2, 4, S, S, 3), jnp.float32), jnp.ones((2, 4)),
        jnp.zeros((2, ctx), jnp.int32), jnp.ones((2,)))
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        if k.endswith("lora_B"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/bias") or k.endswith("bn/mean"):
            flat[k] = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
        elif k.endswith("bn/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return jcfg, jmodel, variables, flat


def _checkpoint(directory, model, name="best"):
    state = init_train_state(model, model.config, steps_per_epoch=3, seed=1)
    save_checkpoint(str(directory), model, state,
                    {"epoch": 1, "best_map": 0.0, "num_classes": NUM_CLASSES,
                     "config": model.config.to_json()}, name=name)
    return str(Path(directory) / name)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, jax_side):
    model = build_model(port_config(jax_side[0]), jax_side[3], device="cpu")
    return _checkpoint(tmp_path_factory.mktemp("ckpt"), model)


@pytest.fixture(scope="module")
def served(checkpoint):
    config, model = serve_embed._load_model(checkpoint, device="cpu")
    engine = serve_embed.make_engine(config, model, 4)
    serve_embed.warmup_engine(config, engine)
    srv = serve_embed.make_server(0, "127.0.0.1", config, engine)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", engine, config
    srv.shutdown()
    srv.server_close()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pixels(seed, shape=(48, 32, 3)):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def _jpeg_b64(seed=0):
    buf = io.BytesIO()
    Image.fromarray(_pixels(seed)).save(buf, "JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def _png_b64(img):
    buf = io.BytesIO()
    img.save(buf, "PNG")  # lossless: identical pixels, identical features
    return base64.b64encode(buf.getvalue()).decode()


def _open(b64):
    return Image.open(io.BytesIO(base64.b64decode(b64)))


# ---- the cases of the JAX package's tests/test_serve_server.py


def test_healthz(served):
    url, _, config = served
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["fusion_dim"] == config.fusion_dim
    assert body["modalities"] == list(VIS) + ["text"]


def test_embed_images_matches_engine(served):
    url, engine, config = served
    b64s = [_jpeg_b64(0), _jpeg_b64(1), _jpeg_b64(2)]
    code, body = _post(url + "/embed", {"images_b64": b64s, "modality": "nir"})
    assert code == 200 and body["count"] == 3
    feats = np.asarray(body["embeddings"], np.float32)
    assert feats.shape == (3, config.fusion_dim)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(feats, engine.embed_pils([_open(s) for s in b64s], "nir"))


def test_embed_texts(served):
    url, engine, _ = served
    code, body = _post(url + "/embed", {"texts": ["a person", "red coat"]})
    assert code == 200 and body["count"] == 2
    np.testing.assert_array_equal(np.asarray(body["embeddings"], np.float32),
                                  engine.embed_texts(["a person", "red coat"]))


def test_embed_queries_matches_singles_and_direct_model(served, checkpoint):
    """Single-modality query dicts equal the dedicated entry points; a
    multi-modal dict equals encode_subset on a hand-built one-row uint8
    batch; mixed combos in one call come back in input order."""
    from prcv2025reid_tpu_torch.data.augment import ImageTransform
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer

    _, engine, config = served
    img = _open(_jpeg_b64(7))
    caption = "a person in a red coat"
    feats = engine.embed_queries([{"nir": img, "text": caption}, {"nir": img},
                                  {"text": caption}])
    assert feats.shape == (3, config.fusion_dim)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(feats[1], engine.embed_pils([img], "nir")[0])
    np.testing.assert_array_equal(feats[2], engine.embed_texts([caption])[0])
    # the combo is a fusion, not either single
    assert np.abs(feats[0] - feats[1]).max() > 1e-3
    assert np.abs(feats[0] - feats[2]).max() > 1e-3

    _, model = serve_embed._load_model(checkpoint, device="cpu")
    S = config.image_size
    images = np.zeros((1, 4, S, S, 3), np.uint8)
    images[0, 1] = ImageTransform(image_size=S)(img.convert("RGB"))
    mask = np.zeros((1, 4), np.float32)
    mask[0, 1] = 1.0
    tok = build_tokenizer(None, config.text_vocab_size, config.text_context_length)
    with torch.no_grad():
        raw = model.encode_subset(torch.from_numpy(images), torch.from_numpy(mask),
                                  torch.from_numpy(tok([caption]).astype(np.int32)),
                                  torch.ones(1), ("nir", "text")).numpy()
    np.testing.assert_allclose(feats[0], raw[0] / np.linalg.norm(raw[0]), rtol=0, atol=1e-5)


def test_weighted_fusion_engine_matches_hand_sum(served, checkpoint):
    """fusion_mode='weighted': a combo query is the unit per-modality
    embeddings summed with text weight 1.2 and renormalised; singles are
    unchanged."""
    _, engine, config = served
    _, model = serve_embed._load_model(checkpoint, device="cpu")
    wengine = serve_embed.make_engine(config, model, 4, fusion_mode="weighted")
    img = _open(_jpeg_b64(9))
    caption = "a tall person"
    np.testing.assert_array_equal(wengine.embed_pils([img], "nir"),
                                  engine.embed_pils([img], "nir"))
    combo = wengine.embed_queries([{"nir": img, "text": caption}])[0]
    expect = engine.embed_pils([img], "nir")[0] + 1.2 * engine.embed_texts([caption])[0]
    np.testing.assert_allclose(combo, expect / np.linalg.norm(expect), rtol=0, atol=1e-5)
    model_combo = engine.embed_queries([{"nir": img, "text": caption}])[0]
    assert np.abs(combo - model_combo).max() > 1e-3
    with pytest.raises(ValueError, match="fusion_mode"):
        serve_embed.make_engine(config, model, 4, fusion_mode="bogus")


def test_embed_queries_http(served):
    url, engine, config = served
    code, body = _post(url + "/embed", {"queries": [{"nir": _jpeg_b64(3), "text": "blue jacket"},
                                                    {"sk": _jpeg_b64(4)}]})
    assert code == 200 and body["count"] == 2
    feats = np.asarray(body["embeddings"], np.float32)
    assert feats.shape == (2, config.fusion_dim)
    direct = engine.embed_queries([{"nir": _open(_jpeg_b64(3)), "text": "blue jacket"},
                                   {"sk": _open(_jpeg_b64(4))}])
    np.testing.assert_array_equal(feats, direct)
    # malformed combo queries are clean 400s
    code, body = _post(url + "/embed", {"queries": [{"bogus": _jpeg_b64()}]})
    assert code == 400 and "bogus" in body["error"]
    code, body = _post(url + "/embed", {"queries": [{}]})
    assert code == 400
    code, body = _post(url + "/embed", {"queries": "not-a-list"})
    assert code == 400 and "list" in body["error"]
    code, body = _post(url + "/embed", {"queries": [{"nir": "!!notb64"}]})
    assert code == 400 and "nir" in body["error"]


def test_microbatcher_coalesces_deterministically():
    """While one batch occupies the device, queued same-group requests are
    served by ONE coalesced dispatch; another group never mixes in."""
    calls = []
    release = threading.Event()
    first_entered = threading.Event()

    def fake_texts(items):
        if not calls:
            first_entered.set()
            release.wait(timeout=30)  # hold the device busy
        calls.append(("texts", list(items)))
        return np.arange(len(items), dtype=np.float32)[:, None]

    def fake_pils(items, mod):
        calls.append((("images", mod), list(items)))
        return np.zeros((len(items), 1), np.float32)

    b = serve_embed.MicroBatcher((fake_pils, fake_texts, None), max_items=8)
    f0 = b.submit(("texts",), ["t0"])
    assert first_entered.wait(timeout=30)
    f1 = b.submit(("texts",), ["t1", "t2"])
    f2 = b.submit(("images", "nir"), ["i0"])
    f3 = b.submit(("texts",), ["t3"])
    release.set()
    r0, r1, r2, r3 = (f.result(timeout=30) for f in (f0, f1, f2, f3))
    assert r0.shape == (1, 1) and r1.shape == (2, 1) and r3.shape == (1, 1)
    assert r2.shape == (1, 1)
    text_calls = [c for c in calls if c[0] == "texts"]
    assert text_calls[0][1] == ["t0"]
    assert text_calls[1][1] == ["t1", "t2", "t3"]
    assert (r1[:, 0] == [0.0, 1.0]).all() and r3[0, 0] == 2.0
    assert b.dispatches == 3 and b.requests == 4

    def boom(items):
        raise RuntimeError("device fault")

    b2 = serve_embed.MicroBatcher((fake_pils, boom, None), max_items=8)
    with pytest.raises(RuntimeError, match="device fault"):
        b2.submit(("texts",), ["x"]).result(timeout=30)


def test_concurrent_requests_match_sequential(served):
    url, engine, _ = served
    texts = [f"person number {i}" for i in range(6)]
    results = {}

    def post_one(i):
        results[i] = _post(url + "/embed", {"texts": [texts[i]]})

    threads = [threading.Thread(target=post_one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    # every batch is padded to one shape: a row does not depend on its batch
    direct = engine.embed_texts(texts)
    for i in range(6):
        code, body = results[i]
        assert code == 200 and body["count"] == 1
        np.testing.assert_array_equal(np.asarray(body["embeddings"], np.float32)[0], direct[i])


def test_bad_requests(served):
    url, _, _ = served
    code, body = _post(url + "/embed", {"images_b64": ["xx"], "modality": "bogus"})
    assert code == 400 and "modality" in body["error"]
    code, body = _post(url + "/embed", {"nonsense": 1})
    assert code == 400
    # a bare string for 'texts' must not be embedded character by character
    code, body = _post(url + "/embed", {"texts": "a red coat"})
    assert code == 400 and "list" in body["error"]
    code, body = _post(url + "/embed", {"images_b64": ["!!notbase64"]})
    assert code == 400
    code, body = _post(url + "/search", {"texts": ["x"]})
    assert code == 404 and "serve_gallery" in body["error"]
    code, body = _post(url + "/gallery/add", {"texts": ["x"], "ids": ["a"]})
    assert code == 404 and "serve_gallery" in body["error"]
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


@pytest.fixture(scope="module")
def search_served(served, tmp_path_factory):
    """A second server over the same engine with a gallery of 5 known nir
    embeddings."""
    _, engine, config = served
    imgs = [Image.fromarray(_pixels(i)) for i in range(5)]
    feats = engine.embed_pils(imgs, "nir")
    gpath = tmp_path_factory.mktemp("gallery") / "g.npz"
    np.savez(gpath, features=feats, ids=np.asarray([f"g{i}" for i in range(5)]))
    gfeats, gids = serve_embed.load_gallery(str(gpath))
    gallery = serve_embed.GalleryStore(config.fusion_dim, gfeats, gids, path=str(gpath),
                                       device="cpu")
    srv = serve_embed.make_server(
        0, "127.0.0.1", config, engine, gallery=gallery,
        rerank={"top_n": 4, "k1": 3, "k2": 2, "lam": 0.3, "default": False})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", imgs, feats
    srv.shutdown()
    srv.server_close()


def test_search_returns_self_as_top1(search_served):
    surl, imgs, _ = search_served
    b64s = [_png_b64(imgs[i]) for i in (2, 0)]
    code, body = _post(surl + "/search", {"images_b64": b64s, "modality": "nir", "top_k": 3})
    assert code == 200 and body["count"] == 2
    assert [r[0]["id"] for r in body["results"]] == ["g2", "g0"]
    for row in body["results"]:
        assert len(row) == 3
        assert row[0]["score"] == pytest.approx(1.0, abs=1e-5)
        scores = [e["score"] for e in row]
        assert scores == sorted(scores, reverse=True)
    # top_k clamps to the gallery size
    code, body = _post(surl + "/search", {"texts": ["a person"], "top_k": 100})
    assert code == 200 and len(body["results"][0]) == 5
    with urllib.request.urlopen(surl + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["gallery_size"] == 5
    code, body = _post(surl + "/search", {"texts": ["x"], "top_k": "ten"})
    assert code == 400 and "top_k" in body["error"]


def test_search_rerank(search_served):
    surl, imgs, _ = search_served
    b64 = _png_b64(imgs[1])
    code, body = _post(surl + "/search", {"images_b64": [b64], "modality": "nir", "top_k": 3,
                                          "rerank": True})
    assert code == 200 and body["reranked"] is True
    row = body["results"][0]
    assert row[0]["id"] == "g1"
    assert row[0]["score"] == pytest.approx(1.0, abs=2e-2)
    scores = [e["score"] for e in row]
    assert scores == sorted(scores, reverse=True) and len(row) == 3
    code, plain = _post(surl + "/search", {"images_b64": [b64], "modality": "nir", "top_k": 3})
    assert code == 200 and plain["reranked"] is False
    assert plain["results"][0][0]["id"] == "g1"
    # top_k past the re-ranked head clamps to the candidate count (top_n=4)
    code, body = _post(surl + "/search", {"texts": ["a person"], "top_k": 100, "rerank": True})
    assert code == 200 and len(body["results"][0]) == 4
    code, body = _post(surl + "/search", {"texts": ["x"], "rerank": "yes"})
    assert code == 400 and "rerank" in body["error"]


def _unit(rng, n, d=8):
    f = rng.standard_normal((n, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def test_gallery_store_semantics(tmp_path):
    """Capacity doubles, the padding never surfaces, remove drops every row
    of an id, save -> load_gallery round-trips, shape errors are loud."""
    rng = np.random.default_rng(0)
    store = serve_embed.GalleryStore(8, min_capacity=4, device="cpu")
    assert store.size == 0 and store.capacity == 4
    assert store.search(rng.random((2, 8)).astype(np.float32), 5) == [[], []]
    f = _unit(rng, 5)
    store.add(f[:3], ["a", "b", "a"])
    assert store.size == 3 and store.capacity == 4
    store.add(f[3:], ["c", "d"])
    assert store.size == 5 and store.capacity == 8  # doubled once
    res = store.search(f[[1]], 100)
    assert len(res[0]) == 5 and res[0][0]["id"] == "b"
    assert res[0][0]["score"] == pytest.approx(1.0, abs=1e-6)
    assert all(np.isfinite(e["score"]) for e in res[0])
    assert store.remove(["a", "nope"]) == 2
    assert store.size == 3
    assert "a" not in [e["id"] for e in store.search(f[[0]], 3)[0]]
    p = tmp_path / "g.npz"
    store.save(str(p))
    feats2, ids2 = serve_embed.load_gallery(str(p))
    assert ids2 == ["b", "c", "d"]
    np.testing.assert_allclose(feats2, f[[1, 3, 4]], atol=1e-6)
    with pytest.raises(ValueError, match="features"):
        store.add(np.zeros((1, 9), np.float32), ["x"])
    with pytest.raises(ValueError, match="ids"):
        store.add(np.zeros((2, 8), np.float32), ["x"])
    with pytest.raises(ValueError, match="path"):
        serve_embed.GalleryStore(8, device="cpu").save()


def _scaled_model(checkpoint, scale):
    """The fixture's model with every parameter (not the BN statistics)
    scaled by ``scale``."""
    _, model = serve_embed._load_model(checkpoint, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(scale)
    return model


def test_admin_reload_hot_swaps_weights(served, checkpoint):
    """POST /admin/reload goes through the server-side reloader: a raise is
    a clean 500 with the weights untouched; success swaps the served
    weights, reports a new fingerprint and counts in /healthz.  A server
    built without a reloader answers 404."""
    url, engine, config = served
    code, body = _post(url + "/admin/reload", {})
    assert code == 404 and "reload" in body["error"]
    texts = ["a person in red"]
    before = engine.embed_texts(texts)
    scaled, original = _scaled_model(checkpoint, 1.5), _scaled_model(checkpoint, 1.0)
    calls = {"n": 0}

    def reloader():
        calls["n"] += 1
        if calls["n"] == 1:
            raise FileNotFoundError("checkpoint not ready yet")
        return scaled if calls["n"] == 2 else original

    srv = serve_embed.make_server(0, "127.0.0.1", config, engine, reloader=reloader)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    rurl = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _post(rurl + "/admin/reload", {})
        assert code == 500 and "reload failed" in body["error"]
        np.testing.assert_array_equal(engine.embed_texts(texts), before)
        code, body = _post(rurl + "/admin/reload", {})
        assert code == 200 and body["reloaded"] is True
        fp_scaled = body["weights_fingerprint"]
        after = engine.embed_texts(texts)
        assert not np.allclose(before, after)
        with urllib.request.urlopen(rurl + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["weights_reloads"] == 1
        code, body = _post(rurl + "/admin/reload", {})
        assert code == 200 and body["weights_fingerprint"] != fp_scaled
        np.testing.assert_array_equal(engine.embed_texts(texts), before)
    finally:
        engine.reload(original)  # leave the module's engine on the checkpoint's weights
        srv.shutdown()
        srv.server_close()


def test_reload_fingerprint_is_jaxs(served, jax_side, checkpoint):
    """The fingerprint is JAX's: the md5 of the [in, out] f32 classifier
    kernel, the same bytes in both packages."""
    import hashlib

    _, engine, config = served
    _, _, variables, _ = jax_side
    kern = np.asarray(variables["params"]["bn_neck"]["classifier"]["kernel"])
    srv = serve_embed.make_server(0, "127.0.0.1", config, engine,
                                  reloader=lambda: _scaled_model(checkpoint, 1.0))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, body = _post(f"http://127.0.0.1:{srv.server_address[1]}/admin/reload", {})
    finally:
        srv.shutdown()
        srv.server_close()
    assert code == 200
    assert body["weights_fingerprint"] == hashlib.md5(kern.tobytes()).hexdigest()[:10]


def test_metrics_endpoint(served):
    url, _, _ = served
    _post(url + "/embed", {"texts": ["x"]})
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        assert r.status == 200 and "text/plain" in r.headers["Content-Type"]
        text = r.read().decode()
    assert 'reid_requests_total{route="/embed",code="200"}' in text
    assert 'reid_request_seconds_sum{route="/embed"}' in text
    assert "reid_batch_dispatches_total" in text and "reid_batch_requests_total" in text
    assert "reid_gallery_size 0" in text and "reid_weights_reloads_total" in text
    _post(url + "/does/not/exist", {})
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        assert 'route="other",code="404"' in r.read().decode()


def test_search_rerank_reaches_every_row_small_gallery():
    """A gallery smaller than top_n re-ranks over the live size's ceiling
    power of two: every live row is reachable, padded slots never surface."""
    rng = np.random.default_rng(3)
    f = _unit(rng, 5)
    store = serve_embed.GalleryStore(8, f, [f"g{i}" for i in range(5)], min_capacity=4,
                                     device="cpu")
    res = store.search(f, 5, rerank={"top_n": 100, "k1": 3, "k2": 2, "lam": 0.3})
    assert all(len(r) == 5 for r in res)
    for i, r in enumerate(res):
        assert r[0]["id"] == f"g{i}"
        assert {e["id"] for e in r} == {f"g{j}" for j in range(5)}
        assert all(np.isfinite(e["score"]) for e in r)


def test_gallery_incremental_publish_matches_rebuild():
    """Appends at a constant capacity write only the new rows into the
    buffer in place; the buffer equals a rebuild from scratch bit for bit,
    across appends, growth and removal."""
    rng = np.random.default_rng(7)
    f = _unit(rng, 13)
    store = serve_embed.GalleryStore(8, min_capacity=8, device="cpu")
    for chunk in (f[:3], f[3:4], f[4:8], f[8:]):  # 3 + 1 + 4 stay at capacity 8
        start = store.size
        before = store._snap[0]
        store.add(chunk, [f"g{start + j}" for j in range(len(chunk))])
        ref = serve_embed.GalleryStore(8, f[:store.size], [f"g{j}" for j in range(store.size)],
                                       min_capacity=8, device="cpu")
        assert store.capacity == ref.capacity
        assert (store._snap[0] is before) == (store.size <= 8)  # in place below growth
        torch.testing.assert_close(store._snap[0], ref._snap[0], rtol=0, atol=0)
    assert store.remove(["g0"]) == 1  # removal builds a new buffer
    res = store.search(f[[12]], 12, rerank={"top_n": 100, "k1": 4, "k2": 2, "lam": 0.3})
    assert res[0][0]["id"] == "g12" and len(res[0]) == 12


def test_inflight_snapshot_ignores_rows_appended_in_place():
    """A search that holds the snapshot from before an in-place append
    answers as before the append: the new rows sit past its size, at -inf."""
    rng = np.random.default_rng(11)
    f = _unit(rng, 6)
    store = serve_embed.GalleryStore(8, f[:3], ["a", "b", "c"], min_capacity=8, device="cpu")
    old = store._snap
    want_plain = store.search(f, 3)
    want_rr = store.search(f, 3, rerank={"top_n": 100, "k1": 2, "k2": 2, "lam": 0.3})
    store.add(f[3:], ["d", "e", "f"])
    assert store._snap[0] is old[0]  # written in place
    now = store._snap
    store._snap = old
    try:
        assert store.search(f, 3) == want_plain
        assert store.search(f, 3, rerank={"top_n": 100, "k1": 2, "k2": 2, "lam": 0.3}) == want_rr
    finally:
        store._snap = now
    assert store.search(f[[4]], 1)[0][0]["id"] == "e"


def test_concurrent_enrollment_and_search_stress():
    """16 threads append 4 rows each while 4 threads search, with a short
    switch interval: no append is lost, every search sees a consistent
    snapshot (ids that were enrolled, k rows, finite scores, its own top-1
    among the rows enrolled before it), and the final buffer equals a
    rebuild of the same rows."""
    import time

    rng = np.random.default_rng(13)
    base = _unit(rng, 8)
    rows = {f"t{t}_{i}": r for t in range(16) for i, r in enumerate(_unit(rng, 4))}
    store = serve_embed.GalleryStore(8, base, [f"b{i}" for i in range(8)], min_capacity=8,
                                     device="cpu")
    errors = []

    def adder(t):
        for i in range(4):
            key = f"t{t}_{i}"
            store.add(rows[key][None], [key])

    def searcher():
        deadline = time.time() + 2.0
        while time.time() < deadline:
            for res in store.search(base[:2], 5), store.search(
                    base[:2], 5, rerank={"top_n": 6, "k1": 3, "k2": 2, "lam": 0.3}):
                ok = all(len(r) == 5 and r[0]["id"] == f"b{i}" and all(
                    np.isfinite(e["score"]) and (e["id"] in rows or e["id"].startswith("b"))
                    for e in r) for i, r in enumerate(res))
                if not ok:
                    errors.append(res)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=adder, args=(t,)) for t in range(16)]
        threads += [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:2]
    assert store.size == 8 + 64 and set(store._ids) == {f"b{i}" for i in range(8)} | set(rows)
    ref = serve_embed.GalleryStore(8, np.concatenate([base, np.stack(
        [rows[k] for k in store._ids[8:]])]), list(store._ids), min_capacity=8, device="cpu")
    torch.testing.assert_close(store._snap[0], ref._snap[0], rtol=0, atol=0)


def test_search_rejects_boolean_top_k(search_served):
    surl, _, _ = search_served
    code, body = _post(surl + "/search", {"texts": ["x"], "top_k": True})
    assert code == 400 and "top_k" in body["error"]


def test_gallery_enrollment_http(served, tmp_path_factory):
    """Start EMPTY, /gallery/add through the engine, /search finds the
    enrolled ids, /gallery/remove, /gallery/save to the server-side path."""
    _, engine, config = served
    gpath = tmp_path_factory.mktemp("enroll") / "enrolled.npz"
    gallery = serve_embed.GalleryStore(config.fusion_dim, path=str(gpath), device="cpu")
    srv = serve_embed.make_server(0, "127.0.0.1", config, engine, gallery=gallery)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    surl = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _post(surl + "/search", {"texts": ["x"], "top_k": 3})
        assert code == 200 and body["results"] == [[]]
        pngs = [_png_b64(Image.fromarray(_pixels(100 + i))) for i in range(3)]
        code, body = _post(surl + "/gallery/add", {"images_b64": pngs, "modality": "nir",
                                                   "ids": ["p0", "p1", "p2"]})
        assert code == 200 and body == {"added": 3, "gallery_size": 3}
        code, body = _post(surl + "/search", {"images_b64": [pngs[1]], "modality": "nir",
                                              "top_k": 2})
        assert code == 200 and body["results"][0][0]["id"] == "p1"
        assert body["results"][0][0]["score"] == pytest.approx(1.0, abs=1e-5)
        code, body = _post(surl + "/gallery/remove", {"ids": ["p1"]})
        assert code == 200 and body == {"removed": 1, "gallery_size": 2}
        code, body = _post(surl + "/search", {"images_b64": [pngs[1]], "modality": "nir",
                                              "top_k": 2})
        assert "p1" not in [e["id"] for e in body["results"][0]]
        code, body = _post(surl + "/gallery/add", {"images_b64": pngs, "modality": "nir",
                                                   "ids": ["onlyone"]})
        assert code == 400 and "ids" in body["error"]
        code, body = _post(surl + "/gallery/remove", {"ids": "p0"})
        assert code == 400 and "list" in body["error"]
        code, body = _post(surl + "/gallery/save", {"path": "/tmp/evil"})
        assert code == 400 and "server-side" in body["error"]
        code, body = _post(surl + "/search", {"texts": ["x"], "rerank": True})
        assert code == 400 and "search_rerank" in body["error"]
        code, body = _post(surl + "/gallery/save", {})
        assert code == 200 and body["gallery_size"] == 2
        feats, ids = serve_embed.load_gallery(str(gpath))
        assert sorted(ids) == ["p0", "p2"] and feats.shape == (2, config.fusion_dim)
        with urllib.request.urlopen(surl + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["gallery_size"] == 2
    finally:
        srv.shutdown()
        srv.server_close()


def test_search_accepts_combo_queries(search_served):
    surl, imgs, _ = search_served
    b64 = _png_b64(imgs[1])
    code, body = _post(surl + "/search", {"queries": [{"nir": b64},
                                                      {"nir": b64, "text": "a person"}],
                                          "top_k": 2})
    assert code == 200 and body["count"] == 2
    assert body["results"][0][0]["id"] == "g1"
    assert body["results"][0][0]["score"] == pytest.approx(1.0, abs=1e-5)
    for row in body["results"]:
        scores = [e["score"] for e in row]
        assert scores == sorted(scores, reverse=True) and len(row) == 2


# ---- against the JAX package on the same weights


def _jax_batch(images, image_mask, tokens, text_mask):
    return {"images": jnp.asarray(images), "image_mask": jnp.asarray(image_mask),
            "text_tokens": jnp.asarray(tokens), "text_mask": jnp.asarray(text_mask)}


@pytest.fixture(scope="module")
def queries():
    """Four MM queries of mixed combos as PIL images and captions, and the
    uint8 pixels the eval transform makes of them."""
    rows = [{"nir": 11, "text": "a man in a grey coat"}, {"sk": 12, "cp": 13},
            {"nir": 14, "sk": 15, "cp": 16, "text": "red shoes"}, {"nir": 17, "text": "hat"},
            {"sk": 18, "cp": 19}]
    return [{k: (v if k == "text" else Image.fromarray(_pixels(v))) for k, v in r.items()}
            for r in rows]


def _jax_rows(jcfg, query_dicts):
    """The uint8 batch JAX's eval steps take for ``query_dicts`` (all of one
    combo), padded to the serving batch with mask 0."""
    B, S = TINY["inference_batch_size"], jcfg.image_size
    tf = JaxTransform(image_size=S, train=False)
    tok = jax_build_tokenizer(None, jcfg.text_vocab_size, jcfg.text_context_length)
    images = np.zeros((B, 4, S, S, 3), np.uint8)
    mask = np.zeros((B, 4), np.float32)
    texts, tmask = [""] * B, np.zeros((B,), np.float32)
    for i, q in enumerate(query_dicts):
        for mi, m in enumerate(VIS):
            if m in q:
                images[i, mi] = tf(q[m].convert("RGB"))
                mask[i, mi] = 1.0
        if "text" in q:
            texts[i], tmask[i] = q["text"], 1.0
    return _jax_batch(images, mask, tok(texts).astype(np.int32), tmask)


@pytest.mark.parametrize("fusion_mode", ["model", "weighted"])
def test_engine_matches_jax_eval_steps(fusion_mode, served, checkpoint, jax_side, queries):
    """embed_pils, embed_texts and embed_queries against JAX's eval steps on
    the same uint8 pixels and the same weights, to 2e-4."""
    jcfg, jmodel, variables, _ = jax_side
    config, model = serve_embed._load_model(checkpoint, device="cpu")
    engine = serve_embed.make_engine(config, model, 4, fusion_mode=fusion_mode)

    def jax_step(mods):
        if fusion_mode == "weighted" and len(mods) > 1:
            return jax_train_step.make_weighted_embed_step(jmodel, mods)
        return jax_train_step.make_combo_embed_step(jmodel, mods)

    imgs = [Image.fromarray(_pixels(20 + i)) for i in range(3)]
    for mod in ("vis", "cp"):
        want = np.asarray(jax_step((mod,))(variables, _jax_rows(
            jcfg, [{mod: im} for im in imgs])))[:3]
        np.testing.assert_allclose(engine.embed_pils(imgs, mod), want, rtol=0, atol=FEAT_TOL)
    captions = ["a person", "a red coat and blue jeans", "x"]
    want = np.asarray(jax_step(("text",))(variables, _jax_rows(
        jcfg, [{"text": c} for c in captions])))[:3]
    np.testing.assert_allclose(engine.embed_texts(captions), want, rtol=0, atol=FEAT_TOL)

    got = engine.embed_queries(queries)
    for mods in {tuple(m for m in (*VIS, "text") if m in q) for q in queries}:
        rows = [i for i, q in enumerate(queries) if tuple(
            m for m in (*VIS, "text") if m in q) == mods]
        want = np.asarray(jax_step(mods)(variables, _jax_rows(
            jcfg, [queries[i] for i in rows])))[:len(rows)]
        np.testing.assert_allclose(got[rows], want, rtol=0, atol=FEAT_TOL)


def test_served_features_are_the_eval_features_jax_fault(checkpoint, jax_side):
    """JAX's serving engine writes the uint8 pixels into a float32 buffer,
    which its model takes as already normalised, so its /embed of an image
    is not the feature its uint8 eval step gives the same image; the port's
    serving batches are uint8 and match that eval step."""
    jcfg, jmodel, variables, _ = jax_side
    imgs = [Image.fromarray(_pixels(30 + i)) for i in range(2)]
    eval_feats = np.asarray(jax_train_step.make_combo_embed_step(jmodel, ("vis",))(
        variables, _jax_rows(jcfg, [{"vis": im} for im in imgs])))[:2]
    jax_served = jax_serve.make_engine(jcfg, jmodel, variables, 4).embed_pils(imgs, "vis")
    config, model = serve_embed._load_model(checkpoint, device="cpu")
    port_served = serve_embed.make_engine(config, model, 4).embed_pils(imgs, "vis")
    assert np.abs(jax_served - eval_feats).max() > 1e-2
    np.testing.assert_allclose(port_served, eval_feats, rtol=0, atol=FEAT_TOL)


def _clustered(seed, n_ids, per_id, d=32, sigma=0.35):
    rng = np.random.default_rng(seed)
    base = _unit(rng, n_ids, d)
    g = base[np.repeat(np.arange(n_ids), per_id)] + sigma * rng.standard_normal(
        (n_ids * per_id, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = base + sigma * rng.standard_normal((n_ids, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g[3] = g[1]  # an exact tie: the lower position first in both packages
    return q.astype(np.float32), g.astype(np.float32)


def _build(module, kwargs, steps):
    """A store of each package driven through the same adds and removes."""
    store = module.GalleryStore(32, min_capacity=8, **kwargs)
    for op, arg in steps:
        if op == "add":
            feats, ids = arg
            store.add(feats, ids)
        else:
            store.remove(arg)
    return store


def _cases():
    q, g = _clustered(5, 7, 4)
    ids = [f"p{i // 4}_{i}" for i in range(len(g))]
    return {
        "smaller_than_top_n": (q, [("add", (g[:5], ids[:5]))]),
        "capacity_padding": (q, [("add", (g[:19], ids[:19]))]),
        "removal": (q, [("add", (g, ids)), ("remove", ["p2_8", "p2_9", "p5_21", "nope"])]),
        "incremental_appends": (q, [("add", (g[:3], ids[:3])), ("add", (g[3:4], ids[3:4])),
                                    ("add", (g[4:8], ids[4:8])), ("add", (g[8:], ids[8:]))]),
    }


@pytest.mark.parametrize("rerank", [None, {"top_n": 16, "k1": 4, "k2": 3, "lam": 0.3}],
                         ids=["plain", "rerank"])
@pytest.mark.parametrize("case", list(_cases()))
def test_gallery_search_matches_jax(case, rerank):
    """GalleryStore.search against JAX's on the same features and the same
    mutations: ids equal, scores to 1e-6."""
    q, steps = _cases()[case]
    port = _build(serve_embed, {"device": "cpu"}, steps)
    ref = _build(jax_serve, {}, steps)
    assert (port.size, port.capacity) == (ref.size, ref.capacity)
    for top_k in (1, 5, 100):
        got, want = port.search(q, top_k, rerank=rerank), ref.search(q, top_k, rerank=rerank)
        assert [[e["id"] for e in r] for r in got] == [[e["id"] for e in r] for r in want]
        np.testing.assert_allclose([[e["score"] for e in r] for r in got],
                                   [[e["score"] for e in r] for r in want], rtol=0,
                                   atol=SCORE_TOL)


def test_gallery_files_read_both_ways(tmp_path):
    """The npz schema (features, ids) is shared: each package's save reads
    back through the other's load_gallery."""
    rng = np.random.default_rng(2)
    f = _unit(rng, 6, 32)
    ids = [f"id{i}" for i in range(6)]
    port = serve_embed.GalleryStore(32, f, ids, device="cpu")
    ref = jax_serve.GalleryStore(32, f, ids)
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    read = [reader(str(tmp_path / name)) for name in ("port.npz", "jax.npz")
            for reader in (serve_embed.load_gallery, jax_serve.load_gallery)]
    for feats, got_ids in read:
        assert got_ids == ids
        np.testing.assert_array_equal(feats, read[0][0])
    np.testing.assert_allclose(read[0][0], f, rtol=0, atol=1e-6)
