"""The serving command line and the two search-side benchmarks of the port
on the CPU: ``tools_torch/serve_embed.py``'s modes (``--images``/``--text``
with ``--out``, ``--benchmark``, ``--serve``) over a checkpoint of the
port's ``save_checkpoint`` at the tiny widths of ``TINY_BASE``
(``inference_batch_size`` 4, random ``init_params``), and
``tools_torch/bench_query.py`` / ``bench_search.py``'s ``main`` at tiny
sizes, as the JAX package's ``tests/test_tools.py`` runs its tools.  The
``--images --out`` features of the conftest ORBench tree's vis files equal
``embed_samples``' features of the same records bit for bit."""
import importlib.util
import io
import json
import os
import sys
import threading
import time
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = {**TINY_BASE, "inference_batch_size": 4}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"port_{name}",
                                                  ROOT / "tools_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


serve_embed = _load("serve_embed")


def _checkpoint(directory, **over):
    config = TrainingConfig(**{**TINY, **over})
    model = build_model(config, device="cpu", num_classes=3, seed=4)
    state = init_train_state(model, config, steps_per_epoch=3, seed=1)
    save_checkpoint(str(directory), model, state,
                    {"epoch": 1, "best_map": 0.0, "num_classes": 3, "config": config.to_json()},
                    name="best")
    return str(Path(directory) / "best")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return _checkpoint(tmp_path_factory.mktemp("ckpt"))


def run(argv):
    """(the result main returned, what it printed)."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = serve_embed.main(argv, device="cpu")
    return result, out.getvalue()


def test_load_model_restores_the_checkpoint_and_applies_the_overrides(checkpoint, tmp_path):
    config, model = serve_embed._load_model(checkpoint, device="cpu")
    want = build_model(TrainingConfig(**TINY), device="cpu", num_classes=3, seed=4)
    for (name, got), (_, ref) in zip(model.state_dict().items(), want.state_dict().items()):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=name)
    config, model = serve_embed._load_model(checkpoint, block_impl="fused", gelu_impl="tanh",
                                            device="cpu")
    assert (config.block_impl, config.gelu_impl) == ("fused", "tanh")
    assert {b.block_impl for b in model.encoder.vision.blocks} == {"fused"}
    # the fused-stream trunk never runs the block kernels: refused, as the eval CLI
    trunk = _checkpoint(tmp_path / "trunk", use_fused_resln=True, use_fused_mlp=True)
    with pytest.raises(ValueError, match="use_fused_resln=True conflicts"):
        serve_embed._load_model(trunk, block_impl="fused", device="cpu")
    with pytest.raises(ValueError, match="use_fused_resln=True conflicts"):
        run([f"--model_path={trunk}", "--block_impl=fused_int8", "--benchmark"])


def test_images_out_equals_embed_samples(checkpoint, orbench_root, tmp_path):
    """--images --out on the tree's vis files at the eval batch: the features
    of embed_samples (the dataset evaluation's gallery embed) bit for bit,
    the ids the files' stems."""
    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.engine import make_combo_embed_step
    from prcv2025reid_tpu_torch.evaluation.protocol import embed_samples

    config, model = serve_embed._load_model(checkpoint, device="cpu")
    ds = MultiModalDataset(config.replace(data_root=orbench_root, json_file=os.path.join(
        orbench_root, "text_annos.json")), split="val")
    idx = [i for i, r in enumerate(ds.records) if r.vis]
    tok = build_tokenizer(None, config.text_vocab_size, config.text_context_length)
    want, _ = embed_samples(make_combo_embed_step(model, ("vis",)), ds, idx, tok, 5)
    stems = [os.path.splitext(os.path.basename(ds.records[i].anchor_vis))[0] for i in idx]
    vis_dir = tmp_path / "vis"
    vis_dir.mkdir()
    for i in idx:  # one directory, so one glob finds them
        src = ds.records[i].anchor_vis
        os.symlink(src, vis_dir / os.path.basename(src))
    out = tmp_path / "gallery.npz"
    (feats, ids), _ = run([f"--model_path={checkpoint}", f"--images={vis_dir}/*",
                           "--modality=vis", f"--out={out}", "--batch_size=5"])
    with np.load(out) as z:
        np.testing.assert_array_equal(z["features"], feats)
        assert list(z["ids"]) == ids == sorted(stems)
    order = [stems.index(s) for s in ids]
    np.testing.assert_array_equal(feats, want[order])
    # the port's gallery loader reads the file back to the same rows
    g, g_ids = serve_embed.load_gallery(str(out))
    assert g_ids == ids and np.abs(g - feats).max() <= 1e-6


def test_text_out_equals_the_text_step(checkpoint, tmp_path):
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.engine import make_combo_embed_step

    captions = ["a person in a red coat", "", "blue jeans", "a hat", "grey shoes and a bag"]
    path = tmp_path / "captions.txt"
    path.write_text("\n".join(captions) + "\n")
    out = tmp_path / "text.npz"
    (feats, ids), _ = run([f"--model_path={checkpoint}", f"--text={path}", f"--out={out}"])
    kept = [c for c in captions if c.strip()]
    assert ids == [str(i) for i in range(len(kept))]
    config, model = serve_embed._load_model(checkpoint, device="cpu")
    tok = build_tokenizer(None, config.text_vocab_size, config.text_context_length)
    step = make_combo_embed_step(model, ("text",))
    B = config.inference_batch_size
    want = []
    for start in range(0, len(kept), B):
        chunk = kept[start:start + B]
        pad = chunk + [""] * (B - len(chunk))
        mask = np.array([1.0] * len(chunk) + [0.0] * (B - len(chunk)), np.float32)
        want.append(step(np.zeros((B, 4, 32, 32, 3), np.uint8), np.zeros((B, 4), np.float32),
                         tok(pad).astype(np.int32), mask).numpy()[:len(chunk)])
    np.testing.assert_array_equal(feats, np.concatenate(want))


def test_modality_outside_the_checkpoint_and_no_mode_exit(checkpoint):
    with pytest.raises(SystemExit, match="vision_modalities"):
        run([f"--model_path={checkpoint}", "--images=*.jpg", "--modality=rgb"])
    with pytest.raises(SystemExit, match="required"):
        run([f"--model_path={checkpoint}"])


def test_benchmark_prints_both_rates(checkpoint):
    result, printed = run([f"--model_path={checkpoint}", "--benchmark", "--batch_size=2"])
    assert json.loads(printed.strip().splitlines()[-1]) == result
    assert result["embeds_per_sec"] > 0 and result["embeds_per_sec_serving"] > 0
    assert (result["batch"], result["modality"]) == (2, "vis")


def test_serve_mode_answers_and_reloads(checkpoint, tmp_path, monkeypatch):
    """--serve 0: the readiness line, then /healthz, enrollment into a new
    gallery path, /search, /gallery/save and /admin/reload (the checkpoint
    re-read: the same weights, the same fingerprint twice)."""
    made = []
    make_server = serve_embed.make_server

    def recording(*a, **kw):
        made.append(make_server(*a, **kw))
        return made[-1]

    monkeypatch.setattr(serve_embed, "make_server", recording)
    gpath = tmp_path / "g.npz"
    out = io.StringIO()

    def serve():
        with redirect_stdout(out):
            serve_embed.main([f"--model_path={checkpoint}", "--serve=0",
                              f"--serve_gallery={gpath}", "--search_rerank",
                              "--search_rerank_top_n=4", "--search_rerank_k1=2",
                              "--search_rerank_k2=2"], device="cpu")

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    deadline = time.time() + 120
    while not out.getvalue() and time.time() < deadline:
        time.sleep(0.05)
    ready = json.loads(out.getvalue().splitlines()[0])
    assert ready["serving"] is True and ready["gallery_size"] == 0
    url = f"http://127.0.0.1:{ready['port']}"

    def post(route, obj):
        req = urllib.request.Request(url + route, data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        texts = ["a person", "a red coat", "blue jeans"]
        assert post("/gallery/add", {"texts": texts, "ids": ["a", "b", "c"]}) == {
            "added": 3, "gallery_size": 3}
        res = post("/search", {"texts": ["a red coat"], "top_k": 2})
        assert res["reranked"] is True and res["results"][0][0]["id"] == "b"
        assert post("/gallery/save", {})["saved"] == str(gpath)
        _, ids = serve_embed.load_gallery(str(gpath))
        assert ids == ["a", "b", "c"]
        first, second = post("/admin/reload", {}), post("/admin/reload", {})
        assert first["reloaded"] and first["weights_fingerprint"] == second["weights_fingerprint"]
        assert post("/search", {"texts": ["a red coat"], "top_k": 2}) == res
    finally:
        made[0].shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def test_entry_points_raise_without_cuda(checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench_query, bench_search = _load("bench_query"), _load("bench_search")
    for fn in (lambda: serve_embed.main([f"--model_path={checkpoint}", "--benchmark"]),
               lambda: serve_embed._load_model(checkpoint),
               lambda: serve_embed.GalleryStore(8),
               lambda: bench_query.main(["--paths=text"]),
               lambda: bench_search.main(["--gallery=8", "--queries=2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_bench_query_all_paths_produce_finite_rates(capsys):
    bench_query = _load("bench_query")
    summary = bench_query.main([f"--set={k}={v}" for k, v in TINY_BASE.items()]
                               + ["--iters=1"], device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert json.loads(lines[-1]) == summary and len(lines) == 5
    assert set(summary["paths"]) == {"text", "single_nir", "quad", "weighted_quad"}
    for row in summary["paths"].values():
        assert row["queries_per_sec"] > 0 and row["device_ms"] is None and row["batch"] == 2
    with pytest.raises(SystemExit, match="unknown path"):
        bench_query.main([f"--set={k}={v}" for k, v in TINY_BASE.items()] + ["--paths=bogus"],
                         device="cpu")


def test_bench_search_all_paths_produce_finite_numbers(capsys):
    bench_search = _load("bench_search")
    summary = bench_search.main(["--gallery=64", "--dim=8", "--queries=16", "--top_k=5",
                                 "--rerank_top_n=16", "--rerank_k1=4", "--rerank_k2=2",
                                 "--iters=1"], device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert json.loads(lines[-1]) == summary and len(lines) == 4
    assert set(summary["paths"]) == {"rank", "rerank", "search_e2e"}
    assert summary["paths"]["rank"]["queries_per_sec"] > 0
    assert summary["paths"]["rerank"]["queries_per_sec"] > 0
    e2e = summary["paths"]["search_e2e"]
    assert e2e["b1_plain_ms"] > 0 and e2e["b16_rerank_ms"] > 0 and e2e["b16_plain_p50_ms"] > 0


def test_bench_tools_run_as_scripts_print_help():
    """The tools run from the root of a checkout as scripts (their own
    sys.path insert), with the JAX tools' flags."""
    import subprocess

    for name, flags in (("serve_embed", ("--serve_gallery", "--search_rerank_lambda",
                                         "--warmup", "--fusion_mode", "--benchmark")),
                        ("bench_query", ("--paths", "--batch", "--iters", "--set")),
                        ("bench_search", ("--gallery", "--queries", "--rerank_top_n"))):
        out = subprocess.run([sys.executable, f"tools_torch/{name}.py", "--help"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120, check=True).stdout
        assert all(f in out for f in flags), (name, out)
