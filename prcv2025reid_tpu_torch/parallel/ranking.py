"""Sharded gallery ranking: Q x G cosine similarity and a distributed top-k
(counterpart of the JAX package's ``parallel/ranking.py``).

The gallery dimension is split over the mesh's data axis: each takes the
top-k of its own shard (k << G / shard), the k x N candidates are gathered
to every process, and one small top-k merges them, ordered by (-score,
gallery index).  The traffic is O(Q * k * N) instead of O(Q * G).

Ties go to the lower gallery index, in each shard and in the merge, so the
result does not depend on the number of processes.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.evaluation.rerank import ordered_topk
from prcv2025reid_tpu_torch.evaluation.similarity import similarity
from prcv2025reid_tpu_torch.parallel.mesh import Mesh, data_axis_size, spanning
from prcv2025reid_tpu_torch.utils import distributed

Array = Union[np.ndarray, torch.Tensor]


def sharded_topk(q_feats: Array, g_feats: Array, k: int, mesh: Optional[Mesh],
                 device: Union[str, torch.device] = "cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery indices per query over a gallery split across ``mesh``'s
    data axis -> (scores [Q, k], indices [Q, k]) on ``device``, the same on
    every process.

    Every process passes the whole query set and gallery (as the ranking
    callers hold them after ``fetch_global``); process r ranks the rows
    [r * S, (r + 1) * S) of the gallery padded to N * S (the padding rows
    score -inf), r being the data index (the model axis holds copies, as
    JAX's ``ranking.py`` shards the gallery over ``'data'``).  ``mesh=None``
    or a data axis of one: one shard."""
    from prcv2025reid_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    q = torch.as_tensor(q_feats, dtype=torch.float32, device=dev)
    g = torch.as_tensor(g_feats, dtype=torch.float32, device=dev)
    mesh = spanning(mesh)
    n = 1 if mesh is None else data_axis_size(mesh)
    rank = 0 if mesh is None else mesh.rank
    G = g.shape[0]
    shard = -(-G // n)
    k_eff = min(k, shard)
    lo, hi = min(rank * shard, G), min((rank + 1) * shard, G)
    sim = similarity(q, g[lo:hi])
    if hi - lo < shard:  # the last shard's padding rows
        sim = torch.cat([sim, torch.full((q.shape[0], shard - (hi - lo)), -torch.inf,
                                         device=dev)], dim=1)
    cols = torch.arange(shard, device=dev) + rank * shard
    scores, idx = ordered_topk(sim, cols.expand_as(sim), k_eff)
    if n > 1:
        # [N, Q, k_eff] candidates on every process, concatenated by shard
        grp = mesh.data_group
        scores = distributed.gather_rows(scores[None], group=grp).movedim(0, 1).reshape(
            q.shape[0], -1)
        idx = distributed.gather_rows(idx[None], group=grp).movedim(0, 1).reshape(q.shape[0], -1)
        scores, idx = ordered_topk(scores, idx, min(k, scores.shape[1]))
    return scores, idx


def topk_reference(q_feats: np.ndarray, g_feats: np.ndarray, k: int):
    """The single-host numpy oracle with the same tie-break rule."""
    sim = q_feats @ g_feats.T
    order = np.lexsort((np.broadcast_to(np.arange(sim.shape[1]), sim.shape), -sim),
                       axis=1)[:, :k]
    scores = np.take_along_axis(sim, order, axis=1)
    return scores, order
