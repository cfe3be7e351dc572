"""The port's serving artifact on the CPU: ``tools_torch/export_serving.py``
(``torch.export`` graphs of the embed steps, the kernels as the
``prcv_reid::*`` ops of ``ops/library.py``) and ``tools_torch/
serve_artifact.py`` (the bundle's consumer, without the model code).

The cases of the JAX package's ``tests/test_tools.py::TestExportServing``
(round trip equal to the live step at 1e-6 with unit norms, weighted
fusion, an unknown graph) and ``tests/test_serve_server.py``'s two bundle
cases (the bundle serves the HTTP API without model code; it ships the
tokenizer vocab), at ``TINY_BASE``'s f32 widths on the flat parameters of
one JAX init (lora_B, biases and BN statistics perturbed).  Against JAX:
the bundle's graphs against JAX's ``export_graphs`` on the same normalised
inputs (JAX's graphs take f32 pixels, the port's uint8) to 2e-4.  The ops:
each equals its plain version on the CPU, and its fake gives the real
output's shape, dtype and strides."""
import dataclasses
import importlib.util
import io
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.data.augment import normalize_images_device as jax_normalize  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu_torch import (  # noqa: E402
    TrainingConfig,
    build_model,
    init_train_state,
    make_combo_embed_step,
    make_weighted_embed_step,
)
from prcv2025reid_tpu_torch.ops import fused_attention as fa  # noqa: E402
from prcv2025reid_tpu_torch.ops import fused_block as fb  # noqa: E402
from prcv2025reid_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from prcv2025reid_tpu_torch.ops import fused_resln as fr  # noqa: E402
from prcv2025reid_tpu_torch.ops import library  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = {**TINY_BASE, "inference_batch_size": 4}
NUM_CLASSES = 3
B = 2
FEAT_TOL = 2e-4
MODEL_MODULES = ("models", "engine", "params", "training")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


export_serving = _load("port_export_serving", "tools_torch/export_serving.py")
serve_artifact = _load("port_serve_artifact", "tools_torch/serve_artifact.py")
serve_embed = _load("port_serve_embed_art", "tools_torch/serve_embed.py")
jax_export = _load("jax_export_serving", "tools/export_serving.py")


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


@pytest.fixture(scope="module")
def port_model(jax_side):
    return build_model(port_config(jax_side[0]), jax_side[3], device="cpu")


def _batch(config, seed, mask_p=None):
    rng = np.random.default_rng(seed)
    Mv, S = len(config.vision_modalities), config.image_size
    mask = np.ones((B, Mv), np.float32) if mask_p is None else \
        (rng.random((B, Mv)) > mask_p).astype(np.float32)
    return {
        "images": rng.integers(0, 256, size=(B, Mv, S, S, 3), dtype=np.uint8),
        "image_mask": mask,
        "text_tokens": rng.integers(0, config.text_vocab_size,
                                    size=(B, config.text_context_length), dtype=np.int32),
        "text_mask": np.ones((B,), np.float32),
    }


def _roundtrip(exported):
    """Save and load a graph, the round trip a bundle makes: -> its module."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    buf.seek(0)
    return torch.export.load(buf).module()


def _run(module, batch):
    with torch.no_grad():
        return module({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()


GRAPHS = ["gallery_vis", "text", "quad", "combo_nir+text"]


@pytest.fixture(scope="module")
def exported(port_model):
    """{name: (loaded module, modalities)} of export_graphs' graphs."""
    graphs = export_serving.export_graphs(port_model.config, port_model, B, graphs=GRAPHS)
    return {name: (_roundtrip(ex), mods) for name, (ex, mods) in graphs.items()}


def test_roundtrip_matches_live_step(port_model, exported):
    """The saved graphs load in a fresh ExportedProgram and agree with the
    live embed steps at JAX's 1e-6; the features are unit rows."""
    config = port_model.config
    assert exported["quad"][1] == tuple(config.vision_modalities) + ("text",)
    assert exported["combo_nir+text"][1] == ("nir", "text")
    batch = _batch(config, 0)
    for name, (ex, mods) in exported.items():
        got = _run(ex, batch)
        want = make_combo_embed_step(port_model, mods)(*batch.values()).numpy()
        assert got.shape == (B, config.fusion_dim)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)


def test_bundle_graphs_match_jax_export(exported, jax_side):
    """The port's graphs against JAX's ``export_graphs`` on the same
    weights and pixels (JAX's schema takes them normalised, the port's as
    uint8), to 2e-4."""
    jcfg, jmodel, variables, _ = jax_side
    theirs = jax_export.export_graphs(jcfg, jmodel, variables, B, graphs=GRAPHS,
                                      platforms=("cpu",))
    batch = _batch(jcfg, 3, mask_p=0.3)
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()},
              "images": jax_normalize(jnp.asarray(batch["images"]))}
    for name in GRAPHS:
        assert exported[name][1] == theirs[name][1]
        want = np.asarray(theirs[name][0].call(jbatch))
        np.testing.assert_allclose(_run(exported[name][0], batch), want, rtol=0, atol=FEAT_TOL,
                                   err_msg=name)


def test_weighted_fusion_mode(port_model):
    """fusion_mode='weighted' exports multi-modal graphs through the
    weighted sum of the per-modality embeddings, as the live server."""
    graphs = export_serving.export_graphs(port_model.config, port_model, B, graphs=["quad"],
                                          fusion_mode="weighted")
    ex, mods = graphs["quad"]
    batch = _batch(port_model.config, 1)
    want = make_weighted_embed_step(port_model, mods)(*batch.values()).numpy()
    np.testing.assert_allclose(_run(_roundtrip(ex), batch), want, atol=1e-6)


def test_unknown_graph_and_fusion_mode_are_loud(port_model):
    with pytest.raises(SystemExit, match="unknown graphs"):
        export_serving.export_graphs(port_model.config, port_model, 2, graphs=["nope"])
    with pytest.raises(SystemExit, match="unknown fusion_mode"):
        export_serving.export_graphs(port_model.config, port_model, 2, fusion_mode="sum")
    # combo_<mods> picks the known modalities in the config's order, as JAX's
    assert export_serving.resolve_graphs(port_model.config, ["combo_text+nir+x"]) == {
        "combo_text+nir+x": ("nir", "text")}


@pytest.mark.parametrize("over,ops", [
    ({"use_pallas_attention": True, "use_fused_mlp": True, "use_fused_resln": True},
     {"fused_mlp": 2, "fused_residual_ln": 4}),
    ({"block_impl": "fused"}, {"fused_ln_qkv": 1, "fused_out_mlp": 1}),
    ({"block_impl": "fused_int8"}, {"fused_ln_qkv_int8": 1, "fused_out_mlp_int8": 1}),
    ({"block_impl": "fused_int8_mlp"}, {"fused_ln_qkv": 1, "fused_out_mlp_int8mlp": 1}),
], ids=["fused_stream", "fused", "fused_int8", "fused_int8_mlp"])
def test_kernel_paths_export_as_ops(jax_side, over, ops):
    """A kernel path's graph holds the ``prcv_reid`` ops (on the CPU the
    attention core of the fused-stream trunk is the einsum one, as the live
    model's), and the loaded graph equals the live step."""
    model = build_model(port_config(jax_side[0], **over), jax_side[3], device="cpu")
    (ex, mods), = export_serving.export_graphs(model.config, model, B,
                                               graphs=["gallery_vis"]).values()
    assert export_serving.graph_ops(ex) == ops
    batch = _batch(model.config, 2)
    want = make_combo_embed_step(model, mods)(*batch.values()).numpy()
    np.testing.assert_allclose(_run(_roundtrip(ex), batch), want, atol=1e-6)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, port_model):
    directory = tmp_path_factory.mktemp("ckpt")
    state = init_train_state(port_model, port_model.config, steps_per_epoch=3, seed=1)
    save_checkpoint(str(directory), port_model, state,
                    {"epoch": 1, "best_map": 0.0, "num_classes": NUM_CLASSES,
                     "config": port_model.config.to_json()}, name="best")
    return str(directory / "best")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, checkpoint):
    """A bundle written by the command line on the CPU, verified on disk."""
    out = tmp_path_factory.mktemp("bundle")
    manifest = export_serving.main([f"--model_path={checkpoint}", f"--out_dir={out}",
                                    "--graphs=gallery_vis,text,combo_nir+text",
                                    "--verify", "--cpu"])
    return str(out), manifest


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_manifest_keys_are_jaxs(bundle, port_model, jax_side, tmp_path):
    out, manifest = bundle
    jcfg, jmodel, variables, _ = jax_side
    jax_manifest = jax_export.write_bundle(str(tmp_path), jcfg, jmodel, variables, 2,
                                           graphs=["text"], platforms=("cpu",))
    assert set(manifest["config"]) == set(jax_manifest["config"])
    ours, theirs = manifest["graphs"]["text"], jax_manifest["graphs"]["text"]
    assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == {"platforms"}
    assert ours["device"] == "cpu" and ours["batch"] == 4 and ours["file"] == "text.pt2"
    with open(Path(out) / "manifest.json") as f:
        assert json.load(f) == manifest
    import hashlib

    blob = (Path(out) / "text.pt2").read_bytes()
    assert manifest["graphs"]["text"]["sha256"] == hashlib.sha256(blob).hexdigest()
    assert manifest["graphs"]["text"]["bytes"] == len(blob)


def test_artifact_bundle_serves_without_model_code(bundle, checkpoint):
    """The bundle's loaded graphs serve the SAME HTTP API and agree with the
    live engine (1e-6)."""
    out, _ = bundle
    config, model = serve_embed._load_model(checkpoint, device="cpu")
    engine = serve_embed.make_engine(config, model, 4)
    shim, graphs = serve_artifact.load_bundle(out)
    assert set(graphs) == {"gallery_vis", "text", "combo_nir+text"}
    assert graphs["combo_nir+text"]["modalities"] == ("nir", "text")
    aengine = serve_artifact.make_artifact_engine(shim, graphs)

    texts = ["a person with a hat", "someone in blue"]
    np.testing.assert_allclose(aengine.embed_texts(texts), engine.embed_texts(texts), atol=1e-6)
    img = Image.fromarray((np.random.default_rng(5).random((40, 30, 3)) * 255).astype(np.uint8))
    np.testing.assert_allclose(aengine.embed_pils([img] * 5, "vis"),
                               engine.embed_pils([img] * 5, "vis"), atol=1e-6)
    q = [{"nir": img, "text": "red coat"}, {"nir": img, "text": "x"}]
    np.testing.assert_allclose(aengine.embed_queries(q), engine.embed_queries(q), atol=1e-6)
    # a combo the bundle does not provide is a clean error, not garbage
    with pytest.raises(ValueError, match="no exported graph"):
        aengine.embed_queries([{"sk": img}])
    with pytest.raises(RuntimeError, match="immutable"):
        aengine.reload(None)

    # the artifact engine drives the SAME HTTP server implementation
    gal = aengine.embed_pils([img], "vis")
    store = serve_embed.GalleryStore(shim.fusion_dim, gal, ["g0"], device="cpu")
    srv = serve_embed.make_server(0, "127.0.0.1", shim, aengine, gallery=store)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    aurl = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _post(aurl + "/embed", {"texts": ["x"]})
        assert code == 200 and len(body["embeddings"][0]) == shim.fusion_dim
        code, body = _post(aurl + "/search", {"texts": ["x"], "top_k": 1})
        assert code == 200 and body["results"][0][0]["id"] == "g0"
    finally:
        srv.shutdown()
        srv.server_close()


CONSUMER = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tools_torch.serve_artifact import consumer_check; "
            "consumer_check(*sys.argv[2:5], latency_n=int(sys.argv[5]))")


def test_consumer_loads_no_model_code(bundle, tmp_path):
    """serve_artifact.consumer_check in a fresh process: load_bundle, the
    engine's embed calls, the gallery's plain and re-ranked search and the
    HTTP server import the op library, the data modules and the HTTP
    layer: no models, engine, params or training."""
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray((rng.random((20, 10, 3)) * 255).astype(np.uint8)).save(paths[-1])
    inputs = tmp_path / "inputs.json"
    inputs.write_text(json.dumps({"vis": paths, "nir": paths[::-1],
                                  "captions": ["a hat", "a blue coat"]}))
    feats = tmp_path / "feats.npz"
    proc = subprocess.run([sys.executable, "-c", CONSUMER, str(ROOT), bundle[0], str(inputs),
                           str(feats), "2"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])["bundle_consumer"]
    loaded = got["modules"]
    assert "prcv2025reid_tpu_torch.ops.library" in loaded
    assert not [m for m in loaded if m.split(".")[0] == "prcv2025reid_tpu"]
    assert not [m for m in loaded if len(m.split(".")) > 1 and m.split(".")[1] in MODEL_MODULES]
    assert got["model_modules"] == []
    assert got["embed_equals_engine"] and got["search_hits"] == 2 and got["store_hits"] == [2, 2]
    assert got["n"] == 2 and got["one_vis_batch"] == {}  # the CPU runs the plain versions
    with np.load(feats) as z:
        assert sorted(z.files) == ["nir_text", "text", "vis"]  # the bundle has no quad graph
        assert all(np.isfinite(z[k]).all() and z[k].shape == (2, TINY["fusion_dim"])
                   for k in z.files)


def test_bundle_ships_tokenizer_vocab(port_model, tmp_path):
    """A checkpoint with a BPE vocab exports it INTO the bundle, and the
    artifact shim resolves it."""
    vdir = tmp_path / "vocab"
    vdir.mkdir()
    (vdir / "vocab.json").write_text(json.dumps({"a": 0}))
    (vdir / "merges.txt").write_text("#version\n")
    config2 = port_model.config.replace(tokenizer_vocab_path=str(vdir))
    bdir = tmp_path / "bundle"
    manifest = export_serving.write_bundle(str(bdir), config2, port_model, 2,
                                           graphs=["text"])
    assert manifest["config"]["tokenizer"] == "tokenizer"
    assert (bdir / "tokenizer" / "vocab.json").exists()
    assert (bdir / "tokenizer" / "merges.txt").exists()
    shim, _ = serve_artifact.load_bundle(str(bdir))
    assert shim.tokenizer_vocab_path == str(bdir / "tokenizer")
    # a vocab-less checkpoint (the smoke/test config) records null
    manifest2 = export_serving.write_bundle(str(tmp_path / "b2"), port_model.config, port_model,
                                            2, graphs=["text"])
    assert manifest2["config"]["tokenizer"] is None


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    G, T, D, F, H, Dh = 2, 5, 16, 32, 2, 8
    x, attn = r(G, T, D), r(G, T, D)
    lns, lnb = r(D), r(D)
    w, b = r(G, D, 3 * D), r(G, 3 * D)
    wo, bo, w1, b1, w2, b2 = r(G, D, D), r(G, D), r(G, D, F), r(G, F), r(G, F, D), r(G, D)
    q8 = [fb.quantize_weight(t) for t in (w, wo, w1, w2)]
    qkv = r(3, 2, 4, H, Dh)
    q, k, v = (qkv[i].permute(0, 2, 1, 3) for i in range(3))  # strided views, as the model's
    return {
        "fused_mha": ((q, k, v, True), fa.mha_plain(q, k, v, True)),
        "fused_ln_qkv": ((x, lns, lnb, w, b), fb.ln_qkv_plain(x, lns, lnb, w, b)),
        "fused_out_mlp": ((attn, x, wo, bo, lns, lnb, w1, b1, w2, b2),
                          fb.out_mlp_plain(attn, x, wo, bo, lns, lnb, w1, b1, w2, b2)),
        "fused_ln_qkv_int8": ((x, lns, lnb, *q8[0], b),
                              fb.ln_qkv_int8_plain(x, lns, lnb, *q8[0], b)),
        "fused_out_mlp_int8": ((attn, x, *q8[1], bo, lns, lnb, *q8[2], b1, *q8[3], b2),
                               fb.out_mlp_int8_plain(attn, x, *q8[1], bo, lns, lnb, *q8[2], b1,
                                                     *q8[3], b2)),
        "fused_out_mlp_int8mlp": ((attn, x, wo, bo, lns, lnb, *q8[2], b1, *q8[3], b2),
                                  fb.out_mlp_int8mlp_plain(attn, x, wo, bo, lns, lnb, *q8[2], b1,
                                                           *q8[3], b2)),
        "fused_mlp": ((x, w1, b1, w2, b2), fm.mlp_plain(x, w1, b1, w2, b2)),
        "fused_residual_ln": ((x[0], attn[0], lns, lnb, 1e-5),
                              fr.resln_plain(x[0], attn[0], lns, lnb, 1e-5)),
    }


@pytest.mark.parametrize("name", library.OPS)
def test_op_equals_its_plain_version_and_its_fake_the_output(name):
    args, want = _op_cases()[name]
    got = getattr(torch.ops.prcv_reid, name)(*args)
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    with FakeTensorMode() as mode:
        fake = getattr(torch.ops.prcv_reid, name)(
            *[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(got) == len(want) == len(fake)
    for g, w, f in zip(got, want, fake):
        assert torch.equal(g, w)
        assert (f.shape, f.dtype, f.stride()) == (g.shape, g.dtype, g.stride())


def test_fused_mha_fake_on_the_card_is_the_kernels_layout():
    """On the card the kernel writes [B, S, H, Dh] and returns the
    [B, H, S, Dh] view: the fake of a CUDA call has those strides."""
    with FakeTensorMode() as mode:
        conv = mode.fake_tensor_converter
        q, k, v = (conv.from_meta_and_device(mode, torch.empty(2, 3, 5, 8, device="meta",
                                                               dtype=torch.bfloat16),
                                             torch.device("cuda")) for _ in range(3))
        out = torch.ops.prcv_reid.fused_mha(q, k, v, False)
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 3, 5, 8)
    assert out.stride() == torch.empty(2, 5, 3, 8).permute(0, 2, 1, 3).stride()


def test_eager_calls_do_not_go_through_the_ops(monkeypatch):
    """The wrappers route through torch.ops.prcv_reid only while exporting."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(str(func))
            return func(*args, **(kwargs or {}))

    args, want = _op_cases()["fused_mlp"]
    with Seen() as eager:
        assert torch.equal(fm.fused_mlp(*args), want)
    assert not [o for o in eager.ops if o.startswith("prcv_reid")]
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    with Seen() as exporting:
        assert torch.equal(fm.fused_mlp(*args), want)
    assert "prcv_reid.fused_mlp.default" in exporting.ops
