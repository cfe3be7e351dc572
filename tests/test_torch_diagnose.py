"""The training diagnosis tools of the port against the JAX package's, on
the CPU in f32 at ``TINY_BASE`` widths: ``tools/diagnose.py``'s
activation report entry by entry on the same weights and batch, the three
command lines of ``tools_torch/`` (``diagnose_alignment.py``,
``probe_sdm_breaking.py``, ``dryrun_real_data.py``) at tiny sizes with
``--cpu`` (their printed panel, JSON and CSV in JAX's keys), and the
probe's collapse metric against JAX's expression on the same features.

The report's entries are held at rtol 1e-4 / atol 1e-5 (f32 through the
same layers summed in another order), their zero fractions within 1e-3
and their flags equal.
"""
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu.tools import diagnose as jax_diagnose  # noqa: E402
from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.tools import diagnose  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NUM_CLASSES = 7
B = 3
RTOL, ATOL, ZERO_TOL = 1e-4, 1e-5, 1e-3
ENTRY_KEYS = {"shape", "mean_norm", "max_abs", "zero_fraction", "nonfinite", "flagged"}
# tools/probe_sdm_breaking.py's JSON and each of its cells
PROBE_KEYS = {"ln_b", "lrs", "pk", "steps", "cells"}
CELL_KEYS = {"lr", "tau", "weight", "trajectory", "final_sdm", "broke_at_step",
             "vis_offdiag_cos_mean", "vis_offdiag_cos_max", "wall_s"}
# tools/dryrun_real_data.py's report and the submission header
REPORT_KEYS = {"checks", "metrics", "detail", "best_map"}
CSV_HEADER = "query_key,ranked_gallery_ids"


def load_tool(name):
    spec = importlib.util.spec_from_file_location(f"tools_torch_{name}",
                                                  ROOT / "tools_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_config(**over) -> TrainingConfig:
    jcfg = JaxConfig(**TINY_BASE)
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


class JittedCapture:
    """JAX's model with its capturing eval apply jitted (one compile)."""

    def __init__(self, model):
        self._apply = jax.jit(lambda v, *a: model.apply(
            v, *a, train=False, capture_intermediates=True, mutable=["intermediates"]))

    def apply(self, variables, *args, **kwargs):
        return self._apply(variables, *args)


@pytest.fixture(scope="module")
def reports():
    rng = np.random.default_rng(0)
    batch = dict(images=rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8),
                 image_mask=np.ones((B, 4), np.float32),
                 text_tokens=rng.integers(1, 98, (B, 16)).astype(np.int32),
                 text_mask=np.ones((B,), np.float32))
    batch["image_mask"][2, 1] = 0.0
    batch["text_tokens"][:, 9] = 99  # EOT
    model = JaxModel(config=JaxConfig(**TINY_BASE), num_classes=NUM_CLASSES)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r: model.init(
        {"params": r}, jb["images"], jb["image_mask"], jb["text_tokens"], jb["text_mask"],
        train=False))(jax.random.PRNGKey(0))
    flat = {k: np.array(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    for k in flat:  # nonzero lora_B: the folded weights differ by expert
        if k.endswith("lora_B"):
            flat[k] = rng.normal(0.0, 0.05, flat[k].shape).astype(np.float32)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    want = jax_diagnose.activation_report(JittedCapture(model), variables, jb)
    got = diagnose.activation_report(build_model(port_config(), flat, device="cpu"), batch)
    return got, want


def test_activation_report_matches_jax(reports):
    got, want = reports
    shared = sorted(set(got) & set(want))
    vis = "encoder/vision/"
    need = [f"{vis}block_{i}/{ln}/__call__/0/{j}" for i in range(TINY_BASE["vision_layers"])
            for ln in ("ln1", "ln2") for j in (0, 1)]
    need += [f"{vis}block_0/__call__/0", f"{vis}block_0/attn/__call__/0",
             f"{vis}block_0/mlp/__call__/0", f"{vis}ln_final/__call__/0/0",
             f"{vis}proj/__call__/0", f"{vis}patch_embed_nir/__call__/0",
             "encoder/text/block_1/__call__/0", "encoder/text_proj/__call__/0",
             "__call__/0/bn_features", "__call__/0/raw_modality_features"]
    assert set(need) <= set(shared), sorted(set(need) - set(shared))
    for k in shared:
        g, w = got[k], want[k]
        assert set(g) == set(w) == ENTRY_KEYS, k
        assert g["shape"] == w["shape"], k
        for stat in ("mean_norm", "max_abs"):
            np.testing.assert_allclose(g[stat], w[stat], rtol=RTOL, atol=ATOL, err_msg=k)
        assert abs(g["zero_fraction"] - w["zero_fraction"]) <= ZERO_TOL, k
        assert g["nonfinite"] == w["nonfinite"] and g["flagged"] == w["flagged"], k
    # JAX's zero biases read as flagged in both reports
    assert got[f"{vis}block_0/ln1/__call__/0/1"]["flagged"]


def test_summarize_lines(reports):
    got, want = reports
    key = "encoder/vision/proj/__call__/0"
    line = diagnose.summarize({key: got[key]})[0]
    assert line.split(" norm=")[0] == jax_diagnose.summarize({key: want[key]})[0].split(" norm=")[0]
    flagged = diagnose.summarize(got, only_flagged=True)
    assert flagged and all(ln.endswith("<-- FLAGGED") for ln in flagged)


def test_collapse_metric_equals_jax():
    """The probe's off-diagonal cosine against JAX's ``vis_spread``
    expression (tools/probe_sdm_breaking.py) on the same features."""
    probe = load_tool("probe_sdm_breaking")
    rng = np.random.default_rng(2)
    for f in (rng.normal(size=(12, 32)), np.ones((6, 8)) + 1e-3 * rng.normal(size=(6, 8))):
        f = f.astype(np.float32)
        jf = jnp.asarray(f)
        jf = jf / jnp.maximum(jnp.linalg.norm(jf, axis=-1, keepdims=True), 1e-12)
        S = jf @ jf.T
        off = S - jnp.eye(S.shape[0]) * S
        n = S.shape[0]
        want = (float(off.sum() / (n * (n - 1))), float(jnp.abs(off).max()))
        got = probe.offdiag_cosine(torch, torch.from_numpy(f))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tree_and_checkpoint(tmp_path_factory):
    from prcv2025reid_tpu_torch.params import init_params
    from prcv2025reid_tpu_torch.utils.synthetic import make_synthetic_orbench

    work = tmp_path_factory.mktemp("diag_tools")
    root = make_synthetic_orbench(str(work / "orbench"))
    cfg = port_config(data_root=root, json_file=os.path.join(root, "text_annos.json"))
    model = build_model(cfg, init_params(cfg, NUM_CLASSES, seed=1), device="cpu")
    save_checkpoint(str(work / "ckpt"), model, init_train_state(model, cfg, 1),
                    {"epoch": 1, "num_classes": NUM_CLASSES, "config": cfg.to_json()},
                    name="best")
    return root, str(work / "ckpt" / "best"), work


def test_diagnose_cli(tree_and_checkpoint, capsys):
    root, ckpt, _ = tree_and_checkpoint
    report = diagnose.main(["--model_path", ckpt, "--dataset_root", root, "--batch_size", "4",
                            "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(report) > 50
    assert all(set(e) == ENTRY_KEYS and e["nonfinite"] == 0 for e in report.values())
    assert report["__call__/0/bn_features"]["shape"][0] == 4


def test_diagnose_alignment_cli(tree_and_checkpoint, capsys):
    root, ckpt, _ = tree_and_checkpoint
    panel = load_tool("diagnose_alignment").main(
        ["--model_path", ckpt, "--dataset_root", root, "--ids", "4", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("8 samples, 4 ids — cosine panel")
    mods = ("vis", "nir", "sk", "cp", "text")
    assert set(panel) == {f"{a} x {b}" for i, a in enumerate(mods) for b in mods[i:]}
    for entry in panel.values():
        assert entry["gap"] == pytest.approx(entry["same"] - entry["diff"])
    assert len(out) == 1 + len(panel)


def test_probe_cli(tmp_path):
    out = str(tmp_path / "probe.json")
    ret = load_tool("probe_sdm_breaking").main(
        ["--tiny", "--cpu", "--pk", "4x2", "--steps", "4", "--every", "2", "--lrs", "1e-3",
         "--taus", "0.18,0.06", "--out", out])
    with open(out) as f:
        report = json.load(f)
    assert set(report) == PROBE_KEYS and len(report["cells"]) == 2
    assert report["ln_b"] == pytest.approx(np.log(8))
    for cell in report["cells"]:
        assert set(cell) == CELL_KEYS
        assert [s for s, _, _ in cell["trajectory"]] == [1, 2, 4]
        assert np.isfinite(cell["final_sdm"]) and -1 <= cell["vis_offdiag_cos_mean"] <= 1
    assert [list(t) for t in ret["cells"][0]["trajectory"]] == report["cells"][0]["trajectory"]


def test_dryrun_cli(tree_and_checkpoint):
    root, _, work = tree_and_checkpoint
    rc = load_tool("dryrun_real_data").main(
        ["--data_root", root, "--work_dir", str(work / "dryrun"), "--steps_per_epoch", "2",
         "--cpu", "--set", "num_ids_per_batch=2", "--set", "instances_per_id=2",
         "--set", "eval_batch_size=4", "--set", "num_workers=0", "--set", "image_size=32",
         "--set", "text_vocab_size=100", "--set", "text_context_length=16"])
    assert rc == 0
    with open(work / "dryrun" / "dryrun_report.json") as f:
        report = json.load(f)
    assert set(report) == REPORT_KEYS
    assert all(c["ok"] for c in report["checks"]) and len(report["detail"]) == 15
    with open(work / "dryrun" / "submission.csv") as f:
        assert f.readline().strip() == CSV_HEADER
