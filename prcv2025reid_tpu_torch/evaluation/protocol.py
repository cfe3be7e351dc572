"""The MM-1..4 retrieval evaluation engine (counterpart of the JAX
package's ``evaluation/protocol.py``): the query plans, the ranking
metrics, the batched embedding of dataset records (``embed_samples``), the
gallery feature cache and its tag, ``evaluate_protocol`` and the
submission CSV.

- gallery = all vis anchors of the split; queries = every k-combination of
  {nir, sk, cp, text} per record, named single/double/triple/quad with
  '+'-joined modalities; whitelist filtering by fnmatch patterns;
- ranking is one f32 product per query chunk, then a stable argsort and
  vectorised AP / CMC on the device.  mAP counts only queries with at least
  one relevant gallery item; top-1 divides by all queries; CMC@k over the
  queries with one.

The similarities are f32 products at full precision, as JAX's
``Precision.HIGHEST``: TF32 is switched off for the product whatever the
process default.  Ties (and the -inf of excluded pairs) order by gallery
position, as ``jnp.argsort`` and ``jax.lax.top_k`` order them.

**The embedding call contract differs from JAX's.**  JAX calls
``embed_fn(variables, batch)``; here an embed step holds its model's
weights and takes ``(images, image_mask, text_tokens, text_mask)`` (the
port's ``make_combo_embed_step`` and ``make_embed_step``), so
``embed_samples``, ``evaluate_protocol`` and ``export_submission_csv`` take
no ``variables``.  ``rerank`` (a dict of ``rerank_orders``' top_n, k1, k2,
lam) re-ranks each query's head with ``evaluation/rerank.py``.

**Data parallel.**  ``mesh`` and ``sharding`` are a ``parallel/mesh.py``
``Mesh`` (the port has no sharding object apart from it), and every process
of the group makes the same calls.  ``sharding``: each embed batch is split
over the processes, each embeds its rows on its device and ``fetch_global``
joins the features on every process.  ``mesh``: the ranking is
query-sharded (each process ranks its rows of a query chunk; every
per-query statistic is row-independent) and the submission's top-k runs
through ``parallel/ranking.py::sharded_topk``.  The gallery cache's process
0 is the authority: it alone reads and writes the files, and its hits are
broadcast.
"""
from __future__ import annotations

import fnmatch
import hashlib
import itertools
import os
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
from prcv2025reid_tpu_torch.data.pipeline import collate
from prcv2025reid_tpu_torch.evaluation.similarity import _full_f32, similarity  # noqa: F401 (re-exported)
from prcv2025reid_tpu_torch.parallel.collectives import data_parallel
from prcv2025reid_tpu_torch.parallel.mesh import fetch_global, spanning
from prcv2025reid_tpu_torch.utils import distributed
from prcv2025reid_tpu_torch.utils.device import resolve_device

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
    memory O(query_chunk x Ng)).  Inputs are numpy arrays or tensors.  With
    a ``mesh`` of N processes (each passing the same inputs) every chunk is
    padded to a multiple of N rows, each process ranks its contiguous share
    and the per-query statistics are gathered: the same numbers on every
    process."""
    mesh = spanning(mesh)
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
        rows = _chunk_rows(n_real, query_chunk)
        if mesh is not None:
            rows = -(-rows // mesh.size) * mesh.size
        pad = rows - n_real
        qc, qp = _pad_rows(q[sl], pad), _pad_rows(q_p_all[sl], pad)
        ex = None if ex_all is None else _pad_rows(ex_all[sl], pad)
        bi = None if bi_all is None else _pad_rows(bi_all[sl], pad)
        if mesh is not None:  # this process's share of the chunk's rows
            per = rows // mesh.size
            mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
            qc, qp = qc[mine], qp[mine]
            ex = None if ex is None else ex[mine]
            bi = None if bi is None else bi[mine]
        ap, hr, t1, cmc_hits = _chunk_stats(
            qc, qp, g, g_p,
            None if excl_is_idx else ex,
            ex.long() if excl_is_idx else None,
            bi,
            topk_cmc,
        )
        # [rows, 3 + len(topk_cmc)]: one fetch (a gather over the mesh)
        stats = torch.stack([ap, hr, t1, *cmc_hits], dim=1)
        stats = (stats.cpu().numpy() if mesh is None else fetch_global(stats, mesh))[:n_real]
        ap_l.append(stats[:, 0])
        hr_l.append(stats[:, 1])
        t1_l.append(stats[:, 2])
        for j, k in enumerate(topk_cmc):
            cmc_l[k].append(stats[:, 3 + j])

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


# ----- batched embedding of dataset records -----


def _fetch_async(feats: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start the device-to-host copy of ``feats``: into pinned memory,
    non-blocking, with an event the host waits on before reading.  A CPU
    tensor is already on the host."""
    if feats.device.type != "cuda":
        return feats, None
    host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
    host.copy_(feats, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(feats.device))
    return host, done


def embed_samples(
    embed_fn: Callable[..., torch.Tensor],
    dataset: MultiModalDataset,
    indices: Sequence[int],
    tokenizer,
    batch_size: int,
    modalities: Optional[Tuple[str, ...]] = None,
    seed: int = 0,
    sharding=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Embed records -> (features [N, D] f32, pids [N]) as numpy arrays.

    ``embed_fn(images, image_mask, text_tokens, text_mask)`` returns the
    features of one collated batch as a tensor (JAX's takes ``(variables,
    batch)``).  ``modalities=None`` -> gallery mode (vis only).  The last
    batch is padded to ``batch_size`` by reusing its last sample, so every
    call sees one shape.  One-deep overlap, as JAX's: the records are
    decoded here, in the calling process, one after another, and the next
    batch's decode runs while the current embed runs on the device; its
    features come back by a non-blocking copy into pinned memory that the
    host reads only after the next batch is dispatched.

    ``sharding`` (a ``Mesh`` of N processes, ``batch_size`` a multiple of
    N): every process draws every record's sample, so the sample stream is
    the one process's, decodes and embeds only its contiguous share of each
    batch (under the mesh's collectives, so the fusion's batch-coupled
    rescue reads the whole batch), and ``fetch_global`` joins the features:
    the same arrays on every process."""
    mesh = spanning(sharding)
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} does not divide over the {mesh.size}-process "
                         "mesh")
    per = batch_size if mesh is None else batch_size // mesh.size
    lo = 0 if mesh is None else mesh.rank * per
    rng = np.random.default_rng(seed)
    feats_out: List[np.ndarray] = []
    pids_out: List[np.ndarray] = []
    mods = modalities if modalities is not None else ("vis",)
    pending = None  # (host features, their copy's event, n_real, pids)

    def _collect(p):
        host, done, n_real, pids = p
        if mesh is not None:
            feats_out.append(fetch_global(host, mesh)[:n_real])
        else:
            if done is not None:
                done.synchronize()
            feats_out.append(host.numpy()[:n_real])
        pids_out.append(pids[:n_real])

    for start in range(0, len(indices), batch_size):
        chunk = list(indices[start : start + batch_size])
        n_real = len(chunk)
        # this process decodes its own rows, and the last real record when
        # its rows hold the tail's padding (copies of that record)
        mine = range(lo, lo + per)
        samples = [dataset.get_query_sample(i, mods, rng, decode=j in mine or (
            j == n_real - 1 and lo + per > n_real)) for j, i in enumerate(chunk)]
        # pad the tail batch by REUSING the last decoded sample (rows past
        # n_real are discarded)
        samples.extend(samples[-1:] * (batch_size - n_real))
        batch = collate(samples[lo:lo + per], tokenizer)
        with data_parallel(mesh):
            feats = embed_fn(batch["images"], batch["image_mask"], batch["text_tokens"],
                             batch["text_mask"])  # enqueued on the device
        pids = np.asarray([s["pid"] for s in samples], np.int32)
        if mesh is not None:  # joined in _collect, after the next batch is dispatched
            host, done = feats.float(), None
        else:
            host, done = _fetch_async(feats.float())
        if pending is not None:
            _collect(pending)
        pending = (host, done, n_real, pids)
    if pending is not None:
        _collect(pending)
    if not feats_out:
        return np.zeros((0, 1), np.float32), np.zeros((0,), np.int64)
    return np.concatenate(feats_out), np.concatenate(pids_out)


# ----- gallery cache -----


# every config selector that changes embedding NUMERICS (not just speed):
# (field, default).  A cache entry written under one value must never be
# reused under another — the tag appends each non-default value.  The
# token_reduce_* fields enter the tag even when token_keep = 0, where they
# change nothing: mirrored from JAX so the two packages' tags stay equal
# (ROADMAP.md §3).
NUMERICS_PATH_FIELDS = (
    ("block_impl", "xla"),
    ("attn_backend", "xla"),
    ("use_pallas_attention", False),
    ("use_fused_resln", False),
    ("use_fused_mlp", False),
    ("gelu_impl", "erf"),
    ("compute_dtype", "bfloat16"),
    ("token_keep", 0),
    ("token_reduce_layer", 6),
    ("token_reduce_mode", "merge"),
)


def checkpoint_cache_tag(model: torch.nn.Module, base: str, *, step: int, config,
                         weighted: bool = False) -> str:
    """Cache tag that changes with the WEIGHTS (md5 of the classifier
    kernel's bytes, f32 [in, out] as flax stores it — the JAX package's
    string for the same weights) and with the COMPUTE PATH
    (NUMERICS_PATH_FIELDS is the authority)."""
    kernel = model.bn_neck.classifier.kernel.detach().to("cpu", torch.float32).contiguous()
    fp = hashlib.md5(kernel.numpy().tobytes()).hexdigest()[:10]
    tag = f"{base}_st{step}_{fp}"
    if weighted:
        tag += "_w"
    for field, default in NUMERICS_PATH_FIELDS:
        val = getattr(config, field)
        if val != default:
            tag += f"_{field}={val}"
    return tag


class GalleryCache:
    """On-disk gallery feature cache (npz; the JAX package's file names and
    keys, so either package reads the other's files).

    ``keep_newest`` bounds the directory: each save evicts the oldest
    gallery npz beyond the limit (the just-written file is always retained).
    Several processes (``process_count``, default the group's): process 0
    is the authority.  It alone reads and writes the files; ``load``
    broadcasts its verdict, and on a hit its features and pids (f32,
    int64), so that every process takes the same branch into the collective
    embed (a split verdict on shared storage would hang it)."""

    def __init__(self, cache_dir: str, tag: str, keep_newest: int = 4,
                 process_count: Optional[int] = None):
        self.cache_dir = cache_dir
        self.tag = tag
        self.keep_newest = keep_newest
        self.process_count = (distributed.process_count() if process_count is None
                              else process_count)

    def _path(self, indices: Sequence[int]) -> str:
        h = hashlib.md5(np.asarray(indices, np.int64).tobytes()).hexdigest()[:12]
        return os.path.join(self.cache_dir, f"gallery_{self.tag}_{len(indices)}_{h}.npz")

    def _load_local(self, indices) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        try:
            with np.load(self._path(indices)) as z:
                return z["feats"], z["pids"]
        except (OSError, ValueError):
            # absent, or evicted/truncated by a concurrent process between
            # our check and the read — treat as a miss and re-embed
            return None

    def load(self, indices) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.process_count == 1:
            return self._load_local(indices)
        local = self._load_local(indices) if distributed.is_main_process() else None
        hdr = (np.asarray([1, *local[0].shape], np.int64) if local is not None
               else np.zeros(3, np.int64))
        hdr = distributed.broadcast_one_to_all(hdr)
        if hdr[0] == 0:
            return None
        n, d = int(hdr[1]), int(hdr[2])
        feats = (np.asarray(local[0], np.float32) if local is not None
                 else np.zeros((n, d), np.float32))
        pids = (np.asarray(local[1], np.int64) if local is not None
                else np.zeros((n,), np.int64))
        return distributed.broadcast_one_to_all(feats), distributed.broadcast_one_to_all(pids)

    def save(self, indices, feats: np.ndarray, pids: np.ndarray):
        if not distributed.is_main_process():
            return  # one writer; the others read through load's broadcast
        os.makedirs(self.cache_dir, exist_ok=True)
        p = self._path(indices)
        # atomic: a concurrent reader must never observe a truncated npz
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, feats=feats, pids=pids)
        os.replace(tmp, p)
        self._evict(protect=p)

    def _evict(self, protect: str):
        if self.keep_newest is None or self.keep_newest < 1:
            return
        try:
            entries = [
                os.path.join(self.cache_dir, f)
                for f in os.listdir(self.cache_dir)
                if f.startswith("gallery_") and f.endswith(".npz")
            ]
            entries.sort(key=os.path.getmtime, reverse=True)
            for p in entries[self.keep_newest :]:
                if os.path.abspath(p) != os.path.abspath(protect):
                    os.remove(p)
        except OSError:  # concurrent eval processes racing on the same dir
            pass


# ----- the protocol -----


def _query_indices(dataset: MultiModalDataset, mods: Tuple[str, ...]) -> List[int]:
    return [i for i, r in enumerate(dataset.records) if all(m in r.modalities() for m in mods)]


def evaluate_protocol(
    embed_fn: Optional[Callable[..., torch.Tensor]],
    dataset: MultiModalDataset,
    tokenizer,
    *,
    batch_size: int = 64,
    include_patterns: Optional[Sequence[str]] = None,
    k_values: Sequence[int] = (1, 2, 3, 4),
    exclude_same_image: bool = False,
    cache: Optional[GalleryCache] = None,
    sample_ratio: float = 1.0,
    seed: int = 0,
    embed_factory: Optional[Callable[[Tuple[str, ...]], Callable]] = None,
    sharding=None,
    mesh=None,
    rerank: Optional[Dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """Run the MM protocol; returns {map_single, map_quad, map_avg2,
    map_mm_avg, mm{k}_map, cmc1/5/10, detail} as JAX's.

    ``embed_factory(modalities) -> embed step`` gives a combo-specialised
    step per plan (e.g. ``lambda m: make_combo_embed_step(model, m)``);
    without it ``embed_fn`` embeds every plan.  With ``rerank`` each plan's
    head is re-ranked (with the same-image exclusion when it is on), and
    its ``detail`` entry gains ``mAP_plain``, the cosine ranking's mAP.  The
    ranking runs on ``device``.  ``sharding`` splits the embedding and
    ``mesh`` the ranking over a process group (module docstring)."""
    gallery_indices = [i for i, r in enumerate(dataset.records) if r.vis]

    def _fn(mods: Tuple[str, ...]) -> Callable:
        return embed_factory(mods) if embed_factory is not None else embed_fn

    g = cache.load(gallery_indices) if cache else None
    if g is None:
        g_feats, g_pids = embed_samples(_fn(("vis",)), dataset, gallery_indices, tokenizer,
                                        batch_size, sharding=sharding)
        if cache:
            cache.save(gallery_indices, g_feats, g_pids)
    else:
        g_feats, g_pids = g

    plans = filter_plans(build_query_plans(k_values), include_patterns)
    detail: Dict[str, Dict] = {}
    for name, mods in plans:
        q_indices = _query_indices(dataset, mods)
        if sample_ratio < 1.0 and len(q_indices) > 4:
            # per-plan derived stream: the subset for (checkpoint, plan,
            # seed) must not depend on which OTHER plans ran before it
            plan_rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
            n_keep = max(1, int(len(q_indices) * sample_ratio))
            q_indices = sorted(plan_rng.choice(q_indices, n_keep, replace=False).tolist())
        if not q_indices:
            continue
        q_feats, q_pids = embed_samples(_fn(mods), dataset, q_indices, tokenizer, batch_size,
                                        modalities=mods, seed=seed, sharding=sharding)
        exclude = None
        if exclude_same_image:
            # a query must not retrieve the gallery entry built from the very
            # same record: at most ONE gallery position per query
            g_pos = {rec_i: pos for pos, rec_i in enumerate(gallery_indices)}
            exclude = np.asarray([g_pos.get(qi, -1) for qi in q_indices], np.int32)
        if rerank is not None:
            from prcv2025reid_tpu_torch.evaluation.rerank import rerank_orders

            boost = rerank_orders(q_feats, g_feats, excl_idx=exclude, mesh=mesh, device=device,
                                  **rerank)
            detail[name] = compute_retrieval_metrics(q_feats, q_pids, g_feats, g_pids, exclude,
                                                     mesh=mesh, boost_idx=boost, device=device)
            detail[name]["mAP_plain"] = compute_retrieval_metrics(
                q_feats, q_pids, g_feats, g_pids, exclude, mesh=mesh, device=device)["mAP"]
        else:
            detail[name] = compute_retrieval_metrics(q_feats, q_pids, g_feats, g_pids, exclude,
                                                     mesh=mesh, device=device)

    singles = [detail[f"single/{m}"]["mAP"] for m in NONVIS if f"single/{m}" in detail]
    map_single = float(np.mean(singles)) if singles else 0.0
    map_quad = detail.get("quad/nir+sk+cp+text", {}).get("mAP", 0.0)
    all_cmc = {
        f"cmc{k}": float(np.mean([d[f"cmc{k}"] for d in detail.values()])) if detail else 0.0
        for k in (1, 5, 10)
    }
    # MM-k averages: the mean over the combos of size k
    mm_avgs = {}
    for k in k_values:
        vals = [d["mAP"] for n, d in detail.items() if n.startswith(KIND_NAME[k] + "/")]
        if vals:
            mm_avgs[f"mm{k}_map"] = float(np.mean(vals))
    mm_all = list(mm_avgs.values())
    return {
        "map_single": map_single,
        "map_quad": map_quad,
        "map_avg2": (map_single + map_quad) / 2.0,
        "map_mm_avg": float(np.mean(mm_all)) if mm_all else 0.0,
        **mm_avgs,
        **all_cmc,
        "detail": detail,
    }


def export_submission_csv(
    embed_fn: Optional[Callable[..., torch.Tensor]],
    dataset: MultiModalDataset,
    tokenizer,
    output_path: str,
    *,
    batch_size: int = 64,
    k_values: Sequence[int] = (1, 2, 3, 4),
    top_k: int = 100,
    seed: int = 0,
    embed_factory: Optional[Callable[[Tuple[str, ...]], Callable]] = None,
    mesh=None,
    sharding=None,
    rerank: Optional[Dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> int:
    """Write the competition CSV: ``query_key,ranked_gallery_ids``, one row
    a query; query_key = pid|mods|anchor-stem, then the top-k gallery
    anchor stems by similarity, space-joined.  Returns the row count.

    Ranked on ``device`` by a stable descending sort of the full-f32
    similarities, so ties go to the lower gallery index as JAX's
    ``lax.top_k`` orders them (``torch.topk`` defines no order among ties
    on CUDA).  With ``rerank`` the rows are the re-ranked heads, re-ranked
    at least ``top_k`` deep.  With a ``mesh`` of several processes the top-k
    is ``sharded_topk``'s (the same order: ties to the lower index) and
    process 0 writes the file; ``sharding`` splits the embedding."""
    from prcv2025reid_tpu_torch.parallel.ranking import sharded_topk

    mesh = spanning(mesh)
    dev = resolve_device(device)

    def _fn(mods: Tuple[str, ...]) -> Callable:
        return embed_factory(mods) if embed_factory is not None else embed_fn

    gallery_indices = [i for i, r in enumerate(dataset.records) if r.vis]
    g_feats, _ = embed_samples(_fn(("vis",)), dataset, gallery_indices, tokenizer, batch_size,
                               sharding=sharding)
    g_ids = [os.path.splitext(os.path.basename(dataset.records[i].anchor_vis))[0]
             for i in gallery_indices]
    g = torch.as_tensor(g_feats, dtype=torch.float32, device=dev)
    k_eff = min(top_k, g_feats.shape[0])

    rows: List[Tuple[str, str]] = []
    for _, mods in build_query_plans(k_values):
        q_indices = _query_indices(dataset, mods)
        if not q_indices:
            continue
        q_feats, _ = embed_samples(_fn(mods), dataset, q_indices, tokenizer, batch_size,
                                   modalities=mods, seed=seed, sharding=sharding)
        if rerank is not None:
            from prcv2025reid_tpu_torch.evaluation.rerank import rerank_orders

            rr = dict(rerank)
            rr["top_n"] = max(rr.get("top_n", k_eff), k_eff)  # at least as deep as the rows
            order = rerank_orders(q_feats, g_feats, mesh=mesh, device=dev, **rr)[:, :k_eff]
        elif mesh is not None:
            order = np.concatenate([
                sharded_topk(q, g, k_eff, mesh, device=dev)[1].cpu().numpy()
                for q in torch.as_tensor(q_feats, dtype=torch.float32, device=dev).split(1024)
            ])
        else:
            order = np.concatenate([
                torch.argsort(-similarity(q, g), dim=1, stable=True)[:, :k_eff].cpu().numpy()
                for q in torch.as_tensor(q_feats, dtype=torch.float32, device=dev).split(1024)
            ])
        for qi, record_idx in enumerate(q_indices):
            rec = dataset.records[record_idx]
            stem = os.path.splitext(os.path.basename(rec.anchor_vis))[0]
            query_key = f"{rec.pid}|{'+'.join(mods)}|{stem}"
            rows.append((query_key, " ".join(g_ids[j] for j in order[qi])))

    if distributed.is_main_process():
        os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
        with open(output_path, "w") as f:
            f.write("query_key,ranked_gallery_ids\n")
            for key, ranked in rows:
                f.write(f"{key},{ranked}\n")
    distributed.barrier("submission-written")
    return len(rows)
