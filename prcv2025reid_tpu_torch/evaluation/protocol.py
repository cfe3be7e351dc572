"""The MM-1..4 query plans and the ranking metrics (counterpart of the JAX
package's ``evaluation/protocol.py``: ``build_query_plans``,
``filter_plans``, ``compute_retrieval_metrics``, ``ranking_equivalence``).

- queries = every k-combination of {nir, sk, cp, text}, named
  single/double/triple/quad with '+'-joined modalities; the gallery is vis;
- ranking is one f32 product per query chunk, then a stable argsort and
  vectorised AP / CMC on the device.  mAP counts only queries with at least
  one relevant gallery item; top-1 divides by all queries; CMC@k over the
  queries with one.

The similarities are f32 products at full precision, as JAX's
``Precision.HIGHEST``: TF32 is switched off for the product whatever the
process default.  Ties (and the -inf of excluded pairs) order by gallery
position, as ``jnp.argsort`` and ``jax.lax.top_k`` order them.  Single
device: the JAX ``mesh`` argument (query-sharded ranking) is not ported
(ROADMAP.md §1, the item 'Parallel and multi-process').
"""
from __future__ import annotations

import contextlib
import fnmatch
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.engine import resolve_device

NONVIS = ("nir", "sk", "cp", "text")
KIND_NAME = {1: "single", 2: "double", 3: "triple", 4: "quad"}


def build_query_plans(k_values: Sequence[int] = (1, 2, 3, 4)) -> List[Tuple[str, Tuple[str, ...]]]:
    plans = []
    for k in k_values:
        for combo in itertools.combinations(NONVIS, k):
            plans.append((f"{KIND_NAME[k]}/{'+'.join(combo)}", combo))
    return plans


def filter_plans(
    plans: List[Tuple[str, Tuple[str, ...]]], include_patterns: Optional[Sequence[str]]
) -> List[Tuple[str, Tuple[str, ...]]]:
    if not include_patterns:
        return plans
    return [
        (name, mods)
        for name, mods in plans
        if any(fnmatch.fnmatch(name, pat) for pat in include_patterns)
    ]


@contextlib.contextmanager
def _full_f32():
    """f32 products in full f32 (no TF32) inside the scope."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def similarity(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q [Nq, D] @ g [Ng, D].T in full f32 (no TF32)."""
    with _full_f32():
        return q @ g.T


def _chunk_stats(q, q_pids, g, g_pids, exclude, excl_idx, boost_idx, topk_cmc):
    """Per-query (ap, has_rel, top1_hit, cmc hits) for one query chunk.

    ``exclude``: dense [Nq, Ng] bool (arbitrary pairs).  ``excl_idx``: [Nq]
    gallery position to drop per query (-1 = none); the mask is built per
    chunk on the device.  ``boost_idx``: [Nq, K] gallery positions per query
    that take over the ranking head in the given order (a re-ranked top-N);
    items outside keep their cosine order below the head."""
    if excl_idx is not None:
        exclude = torch.arange(g.shape[0], device=g.device)[None, :] == excl_idx[:, None]
    sim = similarity(q, g)
    if exclude is not None:
        sim = torch.where(exclude, torch.full_like(sim, -torch.inf), sim)
    if boost_idx is not None:
        # cosine sims live in [-1, 1]; scores in (2, 3], descending with the
        # given column order, pin the boosted items to the head in that order
        k_b = boost_idx.shape[1]
        bvals = 2.0 + (k_b - torch.arange(k_b, dtype=torch.float32, device=sim.device)) / k_b
        rows = torch.arange(sim.shape[0], device=sim.device)[:, None]
        sim[rows, boost_idx] = bvals[None, :].expand(sim.shape[0], k_b)

    order = torch.argsort(-sim, dim=1, stable=True)  # [Nq, Ng]
    g_sorted = g_pids[order]
    matches = (g_sorted == q_pids[:, None]).float()
    if exclude is not None:
        matches = matches * (1.0 - torch.gather(exclude, 1, order).float())

    rel = matches.sum(dim=1)
    ranks = torch.arange(1, matches.shape[1] + 1, dtype=torch.float32, device=sim.device)[None]
    precision = torch.cumsum(matches, dim=1) / ranks
    ap = (precision * matches).sum(dim=1) / torch.clamp(rel, min=1.0)
    has_rel = (rel > 0).float()
    hits = torch.cumsum(matches, dim=1) > 0
    cmc_hits = [hits[:, min(k, matches.shape[1]) - 1].float() for k in topk_cmc]
    return ap, has_rel, matches[:, 0], cmc_hits


def _chunk_rows(n_real: int, cap: int) -> int:
    """The next power of two >= n_real, at most cap (at least n_real), as JAX
    pads a ragged trailing chunk: a ranking call sees at most log2(cap) + 1
    query shapes.  The padding rows are dropped."""
    rows = 1
    while rows < n_real:
        rows *= 2
    return max(min(rows, cap), n_real)


def _pad_rows(t: Optional[torch.Tensor], pad: int) -> Optional[torch.Tensor]:
    if t is None or not pad:
        return t
    return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])


Array = Union[np.ndarray, torch.Tensor]


def compute_retrieval_metrics(
    q_feats: Array,
    q_pids: Array,
    g_feats: Array,
    g_pids: Array,
    exclude: Optional[Array] = None,  # [Nq, Ng] bool, True = drop pair;
    # or [Nq] int gallery position per query (-1 = none)
    topk_cmc: Sequence[int] = (1, 5, 10),
    query_chunk: int = 1024,
    mesh=None,
    boost_idx: Optional[Array] = None,  # [Nq, K] re-ranked head
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """mAP / top-1 / CMC, computed on ``device`` in query chunks (device
    memory O(query_chunk x Ng)).  Inputs are numpy arrays or tensors."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: sharded ranking is not ported yet (ROADMAP.md §1, the item "
            "'Parallel and multi-process')")
    dev = resolve_device(device)
    topk_cmc = tuple(topk_cmc)
    q = torch.as_tensor(q_feats, dtype=torch.float32, device=dev)
    g = torch.as_tensor(g_feats, dtype=torch.float32, device=dev)
    g_p = torch.as_tensor(g_pids, device=dev)
    q_p_all = torch.as_tensor(q_pids, device=dev)
    Nq = q.shape[0]
    ex_all = None if exclude is None else torch.as_tensor(exclude, device=dev)
    excl_is_idx = ex_all is not None and ex_all.ndim == 1
    bi_all = None if boost_idx is None else torch.as_tensor(boost_idx, device=dev).long()

    ap_l, hr_l, t1_l = [], [], []
    cmc_l = {k: [] for k in topk_cmc}
    for start in range(0, Nq, query_chunk):
        sl = slice(start, min(start + query_chunk, Nq))
        n_real = sl.stop - sl.start
        pad = _chunk_rows(n_real, query_chunk) - n_real
        qc, qp = _pad_rows(q[sl], pad), _pad_rows(q_p_all[sl], pad)
        ex = None if ex_all is None else _pad_rows(ex_all[sl], pad)
        bi = None if bi_all is None else _pad_rows(bi_all[sl], pad)
        ap, hr, t1, cmc_hits = _chunk_stats(
            qc, qp, g, g_p,
            None if excl_is_idx else ex,
            ex.long() if excl_is_idx else None,
            bi,
            topk_cmc,
        )
        ap_l.append(ap[:n_real].cpu().numpy())
        hr_l.append(hr[:n_real].cpu().numpy())
        t1_l.append(t1[:n_real].cpu().numpy())
        for k, h in zip(topk_cmc, cmc_hits):
            cmc_l[k].append(h[:n_real].cpu().numpy())

    ap = np.concatenate(ap_l)
    has_rel = np.concatenate(hr_l)
    top1 = np.concatenate(t1_l)
    n_valid = max(has_rel.sum(), 1.0)
    out = {
        "mAP": float((ap * has_rel).sum() / n_valid),
        "top1": float(top1.mean()),
        "num_queries": int(Nq),
    }
    for k in topk_cmc:
        hits = np.concatenate(cmc_l[k])
        out[f"cmc{k}"] = float((hits * has_rel).sum() / n_valid)
    return out


def ranking_equivalence(
    q_ref: Array,
    g_ref: Array,
    q_test: Array,
    g_test: Array,
    q_pids: Array,
    g_pids: Array,
    topk: int = 100,
    ref_cache: Optional[Dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Is a non-default compute path retrieval-equivalent to the reference
    path?  ``top_overlap``: the mean per-query overlap of the two paths'
    top-k gallery sets; ``map_delta``: |mAP_test - mAP_ref| with the given
    pid labels.  Features are L2-normalised by the caller.  ``ref_cache``
    (a dict the caller keeps across calls) memoizes the reference path's
    orders and mAP, so N candidate paths rank the reference once."""
    dev = resolve_device(device)
    k_eff = int(min(topk, g_ref.shape[0]))

    def orders(q, g):
        sims = similarity(torch.as_tensor(q, dtype=torch.float32, device=dev),
                           torch.as_tensor(g, dtype=torch.float32, device=dev))
        return torch.argsort(-sims, dim=1, stable=True)[:, :k_eff].cpu().numpy()

    if ref_cache is not None and "o_ref" in ref_cache:
        o_ref, m_ref = ref_cache["o_ref"], ref_cache["m_ref"]
    else:
        o_ref = orders(q_ref, g_ref)
        m_ref = compute_retrieval_metrics(q_ref, q_pids, g_ref, g_pids, device=dev)
        if ref_cache is not None:
            ref_cache["o_ref"] = o_ref
            ref_cache["m_ref"] = m_ref
    o_test = orders(q_test, g_test)
    overlaps = [
        len(set(a.tolist()) & set(b.tolist())) / k_eff
        for a, b in zip(o_ref, o_test)
    ]
    m_test = compute_retrieval_metrics(q_test, q_pids, g_test, g_pids, device=dev)
    return {
        "top_overlap": float(np.mean(overlaps)),
        "map_ref": m_ref["mAP"],
        "map_test": m_test["mAP"],
        "map_delta": abs(m_test["mAP"] - m_ref["mAP"]),
    }
