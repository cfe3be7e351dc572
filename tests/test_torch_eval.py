"""The port's MM-1..4 query plans and ranking metrics against the JAX
package's (``evaluation/protocol.py``), on the CPU.

The features are a structured retrieval set (each id's items share a base
vector, plus noise), L2-normalised f32, so the rankings carry real hits and
misses.  Every metric the port returns must equal JAX's within 1e-6: both
rank by a stable argsort of the same f32 similarities and aggregate on the
host in numpy; only the summation order of the products and of the per-query
sums differs.
"""
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.evaluation import protocol as jax_protocol
from prcv2025reid_tpu_torch.evaluation import protocol

TOL = 1e-6
N_IDS, PER_ID, NQ, DIM = 12, 5, 23, 32


def _normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def retrieval_set():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(N_IDS, DIM))
    g_pids = np.repeat(np.arange(N_IDS), PER_ID)
    g = _normed(base[g_pids] + 0.9 * rng.normal(size=(len(g_pids), DIM)))
    q_pids = rng.integers(0, N_IDS + 2, NQ)  # ids >= N_IDS have no gallery item
    q = _normed(np.concatenate([base, rng.normal(size=(2, DIM))])[q_pids]
                + 0.9 * rng.normal(size=(NQ, DIM)))
    return q, q_pids, g, g_pids


def _cases(g_pids):
    rng = np.random.default_rng(1)
    ng = len(g_pids)
    dense = rng.random((NQ, ng)) < 0.1
    idx = rng.integers(0, ng, NQ).astype(np.int32)
    idx[::3] = -1
    boost = np.stack([rng.permutation(ng)[:4] for _ in range(NQ)]).astype(np.int32)
    return {
        "plain": {},
        "dense_exclude": {"exclude": dense},
        "index_exclude": {"exclude": idx},
        "boost": {"boost_idx": boost},
        "boost_and_exclude": {"boost_idx": boost, "exclude": idx},
        "topk_cmc": {"topk_cmc": (1, 5, 10)},
        "chunked": {"query_chunk": 5, "exclude": dense, "topk_cmc": (1, 3, 100)},
    }


@pytest.mark.parametrize("case", ["plain", "dense_exclude", "index_exclude", "boost",
                                  "boost_and_exclude", "topk_cmc", "chunked"])
def test_compute_retrieval_metrics_matches_jax(case, retrieval_set):
    q, q_pids, g, g_pids = retrieval_set
    kw = _cases(g_pids)[case]
    want = jax_protocol.compute_retrieval_metrics(q, q_pids, g, g_pids, **kw)
    got = protocol.compute_retrieval_metrics(q, q_pids, g, g_pids, device="cpu", **kw)
    assert set(got) == set(want)
    assert got["num_queries"] == want["num_queries"] == NQ
    for key in want:
        assert abs(got[key] - want[key]) <= TOL, (key, got[key], want[key])
    assert 0.0 < got["mAP"] < 1.0  # real hits and misses


def test_retrieval_metrics_take_tensors(retrieval_set):
    """Tensors in (any int dtype for the pids) give the numpy inputs' numbers."""
    q, q_pids, g, g_pids = retrieval_set
    want = protocol.compute_retrieval_metrics(q, q_pids, g, g_pids, device="cpu")
    got = protocol.compute_retrieval_metrics(
        torch.from_numpy(q), torch.from_numpy(q_pids).int(), torch.from_numpy(g),
        torch.from_numpy(g_pids), device="cpu")
    assert got == want


def test_ranking_equivalence_matches_jax(retrieval_set):
    q, q_pids, g, g_pids = retrieval_set
    rng = np.random.default_rng(2)
    # one cache per topk: a cache holds the reference orders of one k
    caches = {topk: ({}, {}) for topk in (10, 100)}
    for noise in (0.0, 0.05, 0.3):
        qt = _normed(q + noise * rng.normal(size=q.shape))
        gt = _normed(g + noise * rng.normal(size=g.shape))
        for topk, (cache_jax, cache_port) in caches.items():  # 100 > Ng: every item
            want = jax_protocol.ranking_equivalence(q, g, qt, gt, q_pids, g_pids, topk=topk,
                                                    ref_cache=cache_jax)
            got = protocol.ranking_equivalence(q, g, qt, gt, q_pids, g_pids, topk=topk,
                                               ref_cache=cache_port, device="cpu")
            assert got["top_overlap"] == want["top_overlap"], (noise, topk)
            for key in ("map_ref", "map_test", "map_delta"):
                assert abs(got[key] - want[key]) <= TOL, (noise, topk, key)
            if noise == 0.0:
                assert got["top_overlap"] == 1.0 and got["map_delta"] == 0.0
            elif topk == 10:
                assert got["top_overlap"] < 1.0  # the path moved some neighbours
    assert all("o_ref" in port and "m_ref" in port for _, port in caches.values())


def test_ties_order_by_gallery_position():
    """Equal similarities rank by gallery position (stable), as jnp.argsort
    and jax.lax.top_k order them: a duplicated gallery row counts once in
    the top-1 and the earlier copy wins."""
    g = _normed(np.eye(4, 8) + 0.01)
    g = np.concatenate([g, g[:1]])  # row 4 duplicates row 0
    g_pids = np.array([0, 1, 2, 3, 9])
    q, q_pids = g[:1].copy(), np.array([9])
    for impl, kw in ((protocol, {"device": "cpu"}), (jax_protocol, {})):
        m = impl.compute_retrieval_metrics(q, q_pids, g, g_pids, topk_cmc=(1, 2), **kw)
        assert m["top1"] == 0.0 and m["cmc2"] == 1.0 and m["mAP"] == 0.5, impl
    eq = protocol.ranking_equivalence(q, g, q, g[[4, 1, 2, 3, 0]], q_pids, g_pids, topk=1,
                                      device="cpu")
    assert eq["top_overlap"] == 1.0  # position 0 in both: the earlier tied copy


@pytest.mark.parametrize("ks", [(1, 2, 3, 4), (1,), (2, 3), (4,)])
def test_query_plans_match_jax(ks):
    assert protocol.build_query_plans(ks) == jax_protocol.build_query_plans(ks)
    assert protocol.NONVIS == jax_protocol.NONVIS
    assert protocol.KIND_NAME == jax_protocol.KIND_NAME


@pytest.mark.parametrize("patterns", [None, [], ["single/*"], ["*text*"],
                                      ["double/nir+sk", "quad/*"], ["nothing"]])
def test_filter_plans_matches_jax(patterns):
    plans = protocol.build_query_plans()
    assert protocol.filter_plans(plans, patterns) == jax_protocol.filter_plans(plans, patterns)


def test_fifteen_plans_eight_with_text():
    plans = protocol.build_query_plans()
    assert len(plans) == 15 and sum("text" in mods for _, mods in plans) == 8


def test_mesh_and_missing_card_raise(retrieval_set, monkeypatch):
    """A one-process mesh ranks as no mesh (tests/test_torch_parallel.py
    ranks over process groups); a mesh of two processes outside a group
    raises rather than rank a share alone."""
    from prcv2025reid_tpu_torch.parallel.mesh import Mesh

    q, q_pids, g, g_pids = retrieval_set
    assert protocol.compute_retrieval_metrics(q, q_pids, g, g_pids, mesh=Mesh(), device="cpu") \
        == protocol.compute_retrieval_metrics(q, q_pids, g, g_pids, device="cpu")
    with pytest.raises(ValueError, match="join the group"):
        protocol.compute_retrieval_metrics(q, q_pids, g, g_pids, mesh=Mesh(size=2),
                                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocol.compute_retrieval_metrics(q, q_pids, g, g_pids)
