"""k-reciprocal re-ranking in the top-N local form (counterpart of the JAX
package's ``evaluation/rerank.py``; Zhong et al., CVPR 2017).

Each query is re-ranked against its own cosine top-N candidates only: the
subproblem is a dense [N+1, N+1] neighbourhood graph (row 0 is the query),
batched over a chunk of queries as [B, N+1, N+1] tensors.  A candidate is
trusted when it and the query are in each other's k1-nearest sets; the
reciprocal sets are expanded (the 2/3-overlap rule), weighted by a Gaussian
of the distance, averaged over the k2 nearest (local query expansion), and
the query's Jaccard distance to every candidate is blended with the cosine
distance: (1 - lam) * jaccard + lam * (1 - cos).  The set-intersection
counts are batched f32 products (TF32 off, as JAX's ``Precision.HIGHEST``).

Plain PyTorch on the device (no Pallas kernel in the JAX package either):
one candidate search, gather and local solve per query chunk, and one copy
back to the host.  Ties go to the lower index everywhere, as JAX's
``lax.top_k`` and stable ``argsort`` order them: the neighbour lists and the
final order come from stable sorts, the candidate top-N from
``stable_topk``.  JAX pads a ragged query chunk to a power of two to avoid
recompiles; eager PyTorch has none to avoid, so the chunks are not padded.

One difference from JAX's numerics, on purpose: the cosine term of the
blend is the candidate search's own score, where JAX recomputes it in the
local product.  The two are the same dot product summed in another order
(an ulp apart at most), and with the search's score ``lam=1.0`` reproduces
the plain cosine order exactly, as JAX's docstring promises, on every
device; the local product still builds the neighbourhoods.

Single device: ``mesh`` raises (ROADMAP.md §1, the item 'Parallel and
multi-process').
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.engine import resolve_device
from prcv2025reid_tpu_torch.evaluation.protocol import _full_f32, _single_device, similarity

# distance of a masked-out candidate: exp(-_BIG) is exactly 0.0 in f32 (no
# Gaussian weight) and any lam-blend of it sorts after every real distance
_BIG = 1e6

Array = Union[np.ndarray, torch.Tensor]


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of an f32
    [R, C] tensor, highest first and equal values in index order, as
    ``jax.lax.top_k`` gives them.  ``torch.topk`` defines no order among ties
    on CUDA, so it runs here on unique int64 keys: the f32 bits mapped onto
    an order-preserving int32 in the high word, the complement of the column
    index in the low word."""
    bits = (scores.float() + 0.0).contiguous().view(torch.int32)  # + 0.0: -0.0 -> +0.0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    cols = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.int64)
    keys = ordered * (1 << 32) + ((1 << 32) - 1 - cols)
    idx = (1 << 32) - 1 - (torch.topk(keys, k, dim=-1).values & 0xFFFFFFFF)
    return torch.gather(scores, -1, idx), idx


def _rerank_core(qf: torch.Tensor, cf: torch.Tensor, cos: torch.Tensor, lam: float, k1: int,
                 k2: int, invalid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qf [B, D] unit queries, cf [B, N, D] unit candidates in cosine top-N
    order, cos [B, N] their cosine scores, invalid [B, N] bool (a masked
    slot: it ranks last and enters no neighbourhood) -> (perm [B, N]: the
    re-ranked candidate positions, fused [B, N]: their fused distances)."""
    f = torch.cat([qf[:, None, :], cf], dim=1).float()
    Bq, n = f.shape[:2]
    dev = f.device
    with _full_f32():
        sim = torch.bmm(f, f.transpose(1, 2))
    dist = 1.0 - sim
    if invalid is not None:
        # invalid candidates at _BIG on their whole row and column: out of
        # every k1-neighbourhood, zero Gaussian weight; the result equals
        # re-ranking the candidate set without them
        bad = torch.cat([torch.zeros(Bq, 1, dtype=torch.bool, device=dev), invalid], dim=1)
        dist = torch.where(bad[:, :, None] | bad[:, None, :], torch.full_like(dist, _BIG), dist)

    # neighbour lists: self forced first (the diagonal below any real
    # distance), so topk[:, i, :k+1] always holds i itself
    dist_sel = dist - 2.0 * torch.eye(n, device=dev)[None]
    k_need = min(k1 + 1, n)
    topk = torch.argsort(dist_sel, dim=2, stable=True)[:, :, :k_need]  # [B, n, k1+1]

    def membership(idx):  # [B, n, k] neighbour ids -> [B, n, n] bool
        return torch.zeros(Bq, n, n, dtype=torch.bool, device=dev).scatter_(2, idx, True)

    nbr = membership(topk)  # j in N(i, k1)
    kh = min(max(k1 // 2, 1) + 1, k_need)
    nbr_h = membership(topk[:, :, :kh])  # j in N(i, k1/2)

    # k-reciprocal sets: R(i) = {j : j in N(i, k1) and i in N(j, k1)}
    recip = nbr & nbr.transpose(1, 2)
    recip_h = nbr_h & nbr_h.transpose(1, 2)
    rf, rhf = recip.float(), recip_h.float()
    with _full_f32():
        # expansion (Zhong et al. eq. 3): R_half(j) joins R(i) for j in R(i)
        # when |R_half(j) & R(i)| >= 2/3 |R_half(j)|
        inter = torch.bmm(rf, rhf.transpose(1, 2))  # |R(i) & R_half(j)|
        size_h = rhf.sum(-1)  # [B, n]
        absorb = recip & (inter >= (2.0 / 3.0) * size_h[:, None, :])
        expanded = torch.bmm(absorb.float(), rhf)
        r_star = recip | (expanded > 0.0)

        # Gaussian-weighted neighbourhood vectors, row-normalised
        w = torch.where(r_star, torch.exp(-torch.clamp(dist, min=0.0)), torch.zeros_like(dist))
        v = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)

        # local query expansion: V(i) <- the mean of V over its k2 nearest
        if k2 > 1:
            k2_eff = min(k2, k_need)
            a2 = torch.zeros(Bq, n, n, device=dev).scatter_(2, topk[:, :, :k2_eff],
                                                            1.0 / k2_eff)
            v = torch.bmm(a2, v)

    # the Jaccard distance of the query row to every candidate row
    v0 = v[:, :1, :]
    minsum = torch.minimum(v0, v).sum(-1)
    maxsum = torch.maximum(v0, v).sum(-1)
    jaccard = 1.0 - minsum / torch.clamp(maxsum, min=1e-12)

    lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    final = (1.0 - lam_t) * jaccard[:, 1:] + lam_t * (1.0 - cos.float())
    if invalid is not None:
        # lam-independent: a masked candidate sorts after every real one
        final = torch.where(invalid, torch.full_like(final, _BIG), final)
    perm = torch.argsort(final, dim=1, stable=True)
    return perm, torch.gather(final, 1, perm)


def _masked_sim(q: torch.Tensor, g: torch.Tensor, excl: Optional[torch.Tensor],
                nvalid: Optional[int]) -> torch.Tensor:
    """Cosine scores with one gallery position a query dropped (``excl``,
    -1 = none) and/or only the first ``nvalid`` gallery rows live (padded
    capacity rows score -inf)."""
    sim = similarity(q, g)
    cols = torch.arange(g.shape[0], device=g.device)[None, :]
    if excl is not None:
        sim = torch.where(cols == excl[:, None], torch.full_like(sim, -torch.inf), sim)
    if nvalid is not None:
        sim = torch.where(cols < nvalid, sim, torch.full_like(sim, -torch.inf))
    return sim


def _rerank_full(q: torch.Tensor, g: torch.Tensor, excl: Optional[torch.Tensor],
                 nvalid: Optional[int], lam: float, k1: int, k2: int, n_cand: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate top-``n_cand``, the gather and the local solve of one
    query chunk.  Candidates past a query's valid columns (the excluded
    position, padded rows) score -inf and ride along as invalid: they rank
    last and move no real candidate.  -> (re-ranked gallery positions
    [B, n_cand], fused distances)."""
    scores, cand = stable_topk(_masked_sim(q, g, excl, nvalid), n_cand)
    perm, fused = _rerank_core(q, g[cand], scores, lam, k1, k2, torch.isneginf(scores))
    return torch.gather(cand, 1, perm), fused


def rerank_orders(
    q_feats: Array,
    g_feats: Array,
    *,
    top_n: int = 100,
    k1: int = 20,
    k2: int = 6,
    lam: float = 0.3,
    query_chunk: int = 512,
    excl_idx: Optional[Array] = None,  # [Nq] gallery position, -1 = none
    mesh=None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """-> [Nq, n_eff] int32 gallery positions, re-ranked on ``device``.

    Column j holds the gallery index ranked j-th for that query after
    k-reciprocal re-ranking of its cosine top-N candidates.  ``excl_idx``
    drops one gallery position per query before the candidate search (the
    same-image exclusion), so it never appears: with exclusion the head is
    ``min(top_n, Ng - 1)`` wide.  k1 is clamped to the head's width and k2
    to k1 + 1.  ``lam`` weighs the cosine distance ((1 - lam) the Jaccard
    term); ``lam=1.0`` gives the plain cosine order."""
    _single_device(mesh=mesh)
    dev = resolve_device(device)
    Nq = q_feats.shape[0]
    n_gal = int(g_feats.shape[0])
    n_eff = int(min(top_n, n_gal - 1 if excl_idx is not None else n_gal))
    if Nq == 0 or n_eff <= 0:
        return np.zeros((Nq, max(n_eff, 0)), np.int32)
    k1 = int(min(k1, n_eff))  # the neighbour depth cannot exceed the local set
    k2 = int(min(k2, k1 + 1))

    g = torch.as_tensor(g_feats, dtype=torch.float32, device=dev)
    q_all = torch.as_tensor(q_feats, dtype=torch.float32, device=dev)
    ex_all = None if excl_idx is None else torch.as_tensor(excl_idx, device=dev).long()
    out = np.zeros((Nq, n_eff), np.int32)
    for start in range(0, Nq, query_chunk):
        sl = slice(start, min(start + query_chunk, Nq))
        ranked, _ = _rerank_full(q_all[sl], g, None if ex_all is None else ex_all[sl], None,
                                 lam, k1, k2, n_eff)
        out[sl] = ranked.cpu().numpy()
    return out
