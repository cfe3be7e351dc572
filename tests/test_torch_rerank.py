"""The port's k-reciprocal re-ranking against the JAX package's, on the CPU.

JAX's own cases (``tests/test_rerank.py``) run through both packages on the
same f32 features: the same int orders on every row.  A row whose order
differs is allowed only where the swapped places are a near-tie: the same
gallery items, fused distances within 1e-6 of each other; the test prints
such rows.  Then ``evaluate_protocol(rerank=)`` and
``export_submission_csv(rerank=)`` against JAX's on the conftest tree
(``tests/test_torch_dataset_eval.py``'s fixtures): metrics to 1e-5, the
CSV equal; and ``tools_torch/tune_rerank.py`` against ``tools/tune_rerank.py``.
"""
import importlib.util
import math
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_dataset_eval import (  # noqa: E402,F401 (fixtures)
    BATCH,
    PLANS,
    _assert_metrics_close,
    datasets,
    flat_params,
    jax_side,
    jcfg,
    port_factory,
    port_model,
    tokenizers,
)

from prcv2025reid_tpu.evaluation import protocol as jax_protocol  # noqa: E402
from prcv2025reid_tpu.evaluation import rerank as jax_rerank  # noqa: E402
from prcv2025reid_tpu_torch.evaluation import protocol  # noqa: E402
from prcv2025reid_tpu_torch.evaluation import rerank  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEAR_TIE = 1e-6


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clustered(rng, n_ids=8, per_id=6, dim=16, sigma=0.05):
    centers = _unit(rng.normal(size=(n_ids, dim))).astype(np.float32)
    g_feats, g_pids = [], []
    for pid in range(n_ids):
        g_feats.append(_unit(centers[pid] + sigma * rng.normal(size=(per_id, dim))))
        g_pids += [pid] * per_id
    return centers, np.concatenate(g_feats).astype(np.float32), np.asarray(g_pids)


def hold_orders(q, g, kw, query_chunk=512):
    """The port's rerank_orders against JAX's on the same features: equal
    rows, or near-ties at the swapped places (printed)."""
    got = rerank.rerank_orders(q, g, device="cpu", query_chunk=query_chunk, **kw)
    want = jax_rerank.rerank_orders(q, g, query_chunk=query_chunk, **kw)
    assert got.shape == want.shape and got.dtype == np.int32
    differ = np.nonzero((got != want).any(axis=1))[0]
    if len(differ):
        excl = kw.get("excl_idx")
        args = {k: v for k, v in kw.items() if k in ("lam", "k1", "k2")}
        n_eff = got.shape[1]
        k1 = min(args.get("k1", 20), n_eff)
        _, fused = rerank._rerank_full(
            torch.from_numpy(q[differ]), torch.from_numpy(g),
            None if excl is None else torch.from_numpy(np.asarray(excl)[differ]).long(), None,
            args.get("lam", 0.3), k1, min(args.get("k2", 6), k1 + 1), n_eff)
        for row, i in enumerate(differ):
            at = got[i] != want[i]
            spread = float(fused[row][torch.from_numpy(at)].max() - fused[row][
                torch.from_numpy(at)].min())
            print(f"row {i}: {int(at.sum())} places swapped, fused distances within {spread:.2e}")
            assert sorted(got[i][at]) == sorted(want[i][at]) and spread <= NEAR_TIE, i
    return got


# ---- JAX's cases on both packages


def test_matches_the_loop_oracles_case(rng):
    q = _unit(rng.normal(size=(7, 16))).astype(np.float32)
    g = _unit(rng.normal(size=(40, 16))).astype(np.float32)
    hold_orders(q, g, dict(top_n=24, k1=8, k2=3, lam=0.3), query_chunk=4)


def test_lambda_one_is_plain_cosine(rng):
    q = _unit(rng.normal(size=(5, 8))).astype(np.float32)
    g = _unit(rng.normal(size=(30, 8))).astype(np.float32)
    got = hold_orders(q, g, dict(top_n=10, k1=5, k2=2, lam=1.0))
    np.testing.assert_array_equal(got, np.argsort(-(q @ g.T), axis=1, kind="stable")[:, :10])


def test_exclusion_never_surfaces(rng):
    q = _unit(rng.normal(size=(6, 8))).astype(np.float32)
    g = np.concatenate([q, _unit(rng.normal(size=(20, 8)))]).astype(np.float32)
    excl = np.arange(6, dtype=np.int32)
    got = hold_orders(q, g, dict(top_n=12, k1=5, k2=2, lam=0.3, excl_idx=excl))
    assert not (got == excl[:, None]).any()
    plain = hold_orders(q, g, dict(top_n=12, k1=5, k2=2, lam=0.3))
    assert (plain[:, 0] == np.arange(6)).all()


def test_exclusion_never_surfaces_small_gallery(rng):
    q = _unit(rng.normal(size=(6, 8))).astype(np.float32)
    g = np.concatenate([q, _unit(rng.normal(size=(10, 8)))]).astype(np.float32)
    got = hold_orders(q, g, dict(top_n=100, k1=5, k2=2, lam=0.3,
                                 excl_idx=np.arange(6, dtype=np.int32)))
    assert got.shape == (6, 15)  # Ng - 1 columns under exclusion
    assert not (got == np.arange(6)[:, None]).any()
    excl2 = np.array([0, -1, 2, -1, 4, -1], np.int32)
    got2 = hold_orders(q, g, dict(top_n=100, k1=5, k2=2, lam=0.3, excl_idx=excl2))
    for i in (0, 2, 4):
        assert excl2[i] not in got2[i]
    for i in (1, 3, 5):
        assert got2[i, 0] == i


def test_invalid_slots_equal_trimmed_gallery(rng):
    """Padded rows past ``nvalid`` carry no influence: the real candidates'
    order and fused distances equal the unpadded gallery's, and JAX's."""
    q = _unit(rng.normal(size=(4, 8))).astype(np.float32)
    g = _unit(rng.normal(size=(11, 8))).astype(np.float32)
    gpad = np.zeros((16, 8), np.float32)
    gpad[:11] = g
    ranked_pad, fused_pad = rerank._rerank_full(torch.from_numpy(q), torch.from_numpy(gpad),
                                                None, 11, 0.3, 5, 2, 16)
    ranked_ref, fused_ref = rerank._rerank_full(torch.from_numpy(q), torch.from_numpy(g),
                                                None, None, 0.3, 5, 2, 11)
    np.testing.assert_array_equal(ranked_pad[:, :11].numpy(), ranked_ref.numpy())
    np.testing.assert_allclose(fused_pad[:, :11].numpy(), fused_ref.numpy(), rtol=1e-5)
    assert (fused_pad[:, 11:] > 1e5).all() and (ranked_pad[:, 11:] >= 11).all()
    want_ranked, want_fused = jax_rerank._rerank_full(
        jnp.asarray(q), jnp.asarray(gpad), None, jnp.int32(11), jnp.float32(0.3), 5, 2, 16)
    np.testing.assert_array_equal(ranked_pad.numpy(), np.asarray(want_ranked))
    np.testing.assert_allclose(fused_pad.numpy(), np.asarray(want_fused), rtol=1e-6, atol=1e-6)


def test_top_n_clamps_to_gallery(rng):
    q = _unit(rng.normal(size=(3, 8))).astype(np.float32)
    g = _unit(rng.normal(size=(9, 8))).astype(np.float32)
    got = hold_orders(q, g, dict(top_n=100, k1=20, k2=6, lam=0.3))
    assert got.shape == (3, 9)
    for row in got:
        assert sorted(row.tolist()) == list(range(9))


@pytest.mark.parametrize("query_chunk", [16, 37])
def test_the_mesh_cases_shapes_in_chunks(rng, query_chunk):
    q = _unit(rng.normal(size=(37, 16))).astype(np.float32)
    g = _unit(rng.normal(size=(50, 16))).astype(np.float32)
    hold_orders(q, g, dict(top_n=16, k1=6, k2=3, lam=0.3), query_chunk=query_chunk)
    with pytest.raises(NotImplementedError, match="Parallel and multi-process"):
        rerank.rerank_orders(q, g, mesh=object(), device="cpu")


def test_improves_map_on_clustered_data():
    rng = np.random.default_rng(7)
    centers, g_feats, g_pids = _clustered(rng)
    n_ids = len(centers)
    q_feats = np.stack([_unit(centers[pid] + 0.8 * centers[(pid + 1) % n_ids]
                              + 0.05 * rng.normal(size=centers.shape[1]))
                        for pid in range(n_ids)]).astype(np.float32)
    q_pids = np.arange(n_ids)
    boost = hold_orders(q_feats, g_feats, dict(top_n=24, k1=6, k2=3, lam=0.3))
    plain = protocol.compute_retrieval_metrics(q_feats, q_pids, g_feats, g_pids, device="cpu")
    reranked = protocol.compute_retrieval_metrics(q_feats, q_pids, g_feats, g_pids,
                                                  boost_idx=boost, device="cpu")
    assert reranked["mAP"] > plain["mAP"] + 0.02


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_defaults_on_a_clustered_gallery_with_exclusion(lam):
    """The shipped defaults (top_n 100, k1 20, k2 6) on 64 queries against
    a 480-item gallery of 40 ids, each query excluding one of its own id's
    items, in two chunks."""
    tr = _load("port_tune_rerank", "tools_torch/tune_rerank.py")
    q, q_pids, g, g_pids = tr.make_clustered(n_ids=32, per_id_g=12, n_distract=8, n_q=64,
                                             dim=32, sigma_g=0.9, sigma_q=1.0)
    excl = np.asarray([np.nonzero(g_pids == p)[0][0] for p in q_pids], np.int32)
    hold_orders(q, g, dict(lam=lam, excl_idx=excl), query_chunk=40)


def test_empty_inputs():
    got = rerank.rerank_orders(np.zeros((0, 8), np.float32), np.zeros((5, 8), np.float32),
                               device="cpu")
    assert got.shape[0] == 0


def test_stable_topk_orders_ties_by_index():
    s = torch.tensor([[1.0, 2.0, 2.0, 0.0, 2.0, -0.0, 0.0, -np.inf, -1.5, 2.0]])
    vals, idx = rerank.stable_topk(s, 10)
    assert idx.tolist() == [[1, 2, 4, 9, 0, 3, 5, 6, 8, 7]]
    assert torch.equal(vals, s[:, idx[0]])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-3, 4, (20, 50)).astype(np.float32) / 4)
    want = torch.argsort(-x, dim=1, stable=True)[:, :17]
    assert torch.equal(rerank.stable_topk(x, 17)[1], want)


# ---- the protocol and the submission


def test_evaluate_protocol_rerank_matches_jax(datasets, tokenizers, jax_side, port_model):
    ds, jds = datasets
    _, variables, factory = jax_side
    kw = dict(batch_size=BATCH, include_patterns=PLANS, seed=2, exclude_same_image=True,
              rerank={"top_n": 6, "k1": 3, "k2": 2, "lam": 0.3})
    got = protocol.evaluate_protocol(None, ds, tokenizers[0], device="cpu",
                                     embed_factory=port_factory(port_model), **kw)
    want = jax_protocol.evaluate_protocol(None, variables, jds, tokenizers[1],
                                          embed_factory=factory, **kw)
    assert all("mAP_plain" in d for d in got["detail"].values())
    _assert_metrics_close(got, want)
    plain = protocol.evaluate_protocol(None, ds, tokenizers[0], device="cpu",
                                       embed_factory=port_factory(port_model),
                                       **{**kw, "rerank": None})
    for name, d in got["detail"].items():
        assert math.isclose(d["mAP_plain"], plain["detail"][name]["mAP"], abs_tol=1e-12)
    # lam = 1 reproduces the plain metrics
    same = protocol.evaluate_protocol(None, ds, tokenizers[0], device="cpu",
                                      embed_factory=port_factory(port_model),
                                      **{**kw, "rerank": {"top_n": 6, "k1": 3, "k2": 2,
                                                          "lam": 1.0}})
    for d in same["detail"].values():
        assert d["mAP"] == pytest.approx(d["mAP_plain"], abs=1e-6)


def test_submission_rerank_matches_jax(tmp_path, datasets, tokenizers, jax_side, port_model):
    ds, jds = datasets
    _, variables, factory = jax_side
    rr = {"top_n": 4, "k1": 3, "k2": 2, "lam": 0.3}
    n = protocol.export_submission_csv(None, ds, tokenizers[0], str(tmp_path / "port.csv"),
                                       batch_size=BATCH, k_values=(1, 4), top_k=6, seed=1,
                                       device="cpu", embed_factory=port_factory(port_model),
                                       rerank=rr)
    jn = jax_protocol.export_submission_csv(None, variables, jds, tokenizers[1],
                                            str(tmp_path / "jax.csv"), batch_size=BATCH,
                                            k_values=(1, 4), top_k=6, seed=1,
                                            embed_factory=factory, rerank=rr)
    port = (tmp_path / "port.csv").read_bytes()
    assert n == jn == 5 * len(ds) and port == (tmp_path / "jax.csv").read_bytes()
    for row in port.decode().splitlines()[1:]:  # re-ranked at least top_k deep
        ranked = row.split(",")[1].split()
        assert len(ranked) == len(set(ranked)) == 6


# ---- the sweep tool


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tune_rerank_matches_jax(tmp_path, capsys):
    port = _load("port_tune_rerank", "tools_torch/tune_rerank.py")
    jax_tool = _load("jax_tune_rerank", "tools/tune_rerank.py")
    for kw in ({}, {"sigma_g": 1.1, "sigma_q": 1.2, "seed": 1},
               {"contam": 0.8, "per_id_g": 5, "n_q": 33, "dim": 16}):
        for a, b in zip(port.make_clustered(**kw), jax_tool.make_clustered(**kw)):
            np.testing.assert_array_equal(a, b)
    out = tmp_path / "sweep.json"
    rows = port.main(["--quick", "--device", "cpu", "--out", str(out)])
    assert "[mid] BEST" in capsys.readouterr().out and out.exists()
    assert rows[0]["difficulty"] == "mid" and len(rows) == 1 + 8
    # one combination against JAX's metrics and re-ranking of the same sets
    row = next(r for r in rows if r.get("k1") == 20 and r.get("k2") == 6 and r["lam"] == 0.3)
    deltas = []
    for s in (0, 1):
        q, qp, g, gp = port.make_clustered(seed=s, **port.DIFFICULTIES["mid"])
        plain = jax_protocol.compute_retrieval_metrics(q, qp, g, gp)["mAP"]
        o = jax_rerank.rerank_orders(q, g, top_n=100, k1=20, k2=6, lam=0.3)
        deltas.append(jax_protocol.compute_retrieval_metrics(q, qp, g, gp, boost_idx=o)["mAP"]
                      - plain)
    assert row["delta_min"] == pytest.approx(round(min(deltas), 4), abs=1e-4)
    assert os.path.getsize(out) > 0
