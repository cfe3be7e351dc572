"""Strict P x K modality-paired batch sampling (own copy of the JAX
package's ``data/sampler.py``: the same seed draws the same index stream).

Reference: datasets/dataset.py:1327-1464 (ModalAwarePKBatchSampler_Strict) —
the one sampler train.py actually uses — plus the precomputed-metadata idea
from tools/cached_sampler.py:14-231 (buckets are built once, O(1) sampling).

Semantics reproduced exactly:
- pid -> {vis: [idx...], nonvis: [idx...]} buckets; a record lands in ``vis``
  if it has a vis image, in ``nonvis`` if it has any non-vis image OR text.
- strong ids have both buckets non-empty; soft ids fill when strong runs out.
- each batch: P ids (random.choices over the strong pool under id-reuse),
  each contributing K//2 vis + K - K//2 non-vis records (odd K -> extra
  non-vis), with pool-swap fallback when a bucket is empty.
- nominal length = sum(min(|vis|, |nonvis|)) // (P*K).

Differences (deliberate, SURVEY.md §7 hard part 3): explicit steps-per-epoch
instead of an infinite iterator, and a checkpointable numpy RNG stream.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset


class PKBatchSampler:
    def __init__(
        self,
        dataset: MultiModalDataset,
        num_ids_per_batch: int,
        instances_per_id: int,
        allow_id_reuse: bool = True,
        seed: int = 0,
        steps_per_epoch: Optional[int] = None,
        force_modal_pairs: bool = True,
        sampling_fallback: bool = True,
        min_modal_coverage: Optional[float] = None,
    ):
        """``force_modal_pairs=False`` drops the per-id vis/non-vis split (a
        plain P x K draw); ``sampling_fallback=False`` disables the soft-id
        fill and the bucket-swap fallback (short batches are dropped instead)
        — the knobs the reference declares at configs/config.py:57-59.
        ``min_modal_coverage`` warns when the strong-id fraction is below it.
        """
        self.P = int(num_ids_per_batch)
        self.K = int(instances_per_id)
        self.allow_id_reuse = allow_id_reuse
        self.force_modal_pairs = force_modal_pairs
        self.sampling_fallback = sampling_fallback
        self.rng = np.random.default_rng(seed)

        self.pid_buckets: Dict[int, Dict[str, List[int]]] = {}
        for idx, rec in enumerate(dataset.records):
            mods = rec.modalities()
            has_vis = "vis" in mods
            has_nonvis = bool(mods & {"nir", "sk", "cp", "text"})
            d = self.pid_buckets.setdefault(rec.pid, {"vis": [], "nonvis": []})
            if has_vis:
                d["vis"].append(idx)
            if has_nonvis:
                d["nonvis"].append(idx)

        self.strong_ids = sorted(
            pid for pid, d in self.pid_buckets.items() if d["vis"] and d["nonvis"]
        )
        # soft ids must still have at least one usable record — a pid whose
        # record has no modalities at all can never fill a batch slot
        self.soft_ids = sorted(
            pid
            for pid, d in self.pid_buckets.items()
            if pid not in set(self.strong_ids) and (d["vis"] or d["nonvis"])
        )

        if self.force_modal_pairs:
            total_pairs = sum(
                min(len(self.pid_buckets[p]["vis"]),
                    len(self.pid_buckets[p]["nonvis"]))
                for p in self.strong_ids
            )
            self.nominal_steps = max(1, total_pairs // max(1, self.P * self.K))
        else:
            # plain P x K mode never consults the pair buckets: size the
            # epoch by the usable record count, not the (possibly tiny)
            # strong-pair supply
            usable = len({
                i for d in self.pid_buckets.values()
                for i in d["vis"] + d["nonvis"]
            })
            self.nominal_steps = max(1, usable // max(1, self.P * self.K))
        self.steps_per_epoch = (
            steps_per_epoch if steps_per_epoch is not None else self.nominal_steps
        )

        n_ids = len(self.pid_buckets)
        coverage = len(self.strong_ids) / max(1, n_ids)
        if min_modal_coverage is not None and coverage < min_modal_coverage:
            import logging

            logging.getLogger(__name__).warning(
                "cross-modal coverage %.2f below min_modal_coverage=%.2f "
                "(%d/%d ids pairable) — SDM pair supply will be thin",
                coverage,
                min_modal_coverage,
                len(self.strong_ids),
                n_ids,
            )

    @property
    def batch_size(self) -> int:
        return self.P * self.K

    def state_dict(self) -> Dict:
        return {"rng_state": self.rng.bit_generator.state}

    def load_state_dict(self, state: Dict):
        self.rng.bit_generator.state = state["rng_state"]

    def _choose_ids(self, strong_pool=None, soft_pool=None) -> List[int]:
        rng = self.rng
        strong = self.strong_ids if strong_pool is None else strong_pool
        soft = self.soft_ids if soft_pool is None else soft_pool
        if not self.force_modal_pairs:
            # plain P x K: any id with records qualifies
            pool = sorted(set(strong) | set(soft))
            if not pool:
                return []
            take = self.P if self.allow_id_reuse else min(self.P, len(pool))
            return list(rng.choice(pool, take, replace=self.allow_id_reuse))
        if len(strong) >= self.P:
            return list(rng.choice(strong, self.P, replace=self.allow_id_reuse))
        if not self.sampling_fallback:
            # hard mode: never fill from the soft pool
            return list(strong)
        need = self.P - len(strong)
        fillers: List[int] = []
        if soft:
            fillers = list(
                rng.choice(soft, min(need, len(soft)) if not self.allow_id_reuse else need,
                           replace=self.allow_id_reuse)
            )
        return list(strong) + fillers

    def _batch_for_ids(self, ids: List[int]) -> List[int]:
        rng = self.rng
        batch: List[int] = []
        for pid in ids:
            d = self.pid_buckets.get(pid, {"vis": [], "nonvis": []})
            if not self.force_modal_pairs:
                pool = sorted(set(d["vis"]) | set(d["nonvis"]))
                if pool:
                    replace = len(pool) < self.K
                    batch.extend(int(x) for x in rng.choice(pool, self.K, replace=replace))
                continue
            if self.sampling_fallback:
                vis_pool = d["vis"] or d["nonvis"]
                nonvis_pool = d["nonvis"] or d["vis"]
            else:
                vis_pool, nonvis_pool = d["vis"], d["nonvis"]
            k_vis = self.K // 2
            k_nonvis = self.K - k_vis
            for pool, k in ((vis_pool, k_vis), (nonvis_pool, k_nonvis)):
                if not pool:
                    continue
                replace = len(pool) < k
                batch.extend(int(x) for x in rng.choice(pool, k, replace=replace))
        return batch

    def sample_batch(self) -> List[int]:
        """One batch of P*K record indices (vis-first per id)."""
        return self._batch_for_ids(self._choose_ids())

    def __len__(self) -> int:
        """Upper bound on batches per epoch, CONSISTENT with __iter__ —
        len(sampler) sizes the LR-schedule horizon and the per-step metric
        ring (trainer.py), so an estimate that ignores the soft-pool fill or
        the steps_per_epoch cap would mis-size both."""
        if not self.allow_id_reuse:
            # no-reuse: each id serves at most once per epoch
            # (datasets/dataset.py:1458-1464 removes used pids); __iter__
            # draws P ids per batch until the pools drain or steps_per_epoch
            # is reached.  Soft ids participate except in hard pair mode
            # (sampling_fallback=False never fills from the soft pool).
            pool = len(self.strong_ids)
            if not self.force_modal_pairs or self.sampling_fallback:
                pool += len(self.soft_ids)
            return min(self.steps_per_epoch, max(1, -(-pool // self.P)))
        return self.steps_per_epoch

    def __iter__(self) -> Iterator[List[int]]:
        import logging

        strong_pool = list(self.strong_ids)
        soft_pool = list(self.soft_ids)
        yielded = 0
        dropped = 0
        for _ in range(self.steps_per_epoch):
            if not self.allow_id_reuse and not strong_pool and not soft_pool:
                break
            ids = (
                self._choose_ids()
                if self.allow_id_reuse
                else self._choose_ids(strong_pool, soft_pool)
            )
            batch = self._batch_for_ids(ids)
            if not self.allow_id_reuse:
                # consume: used ids leave the pools (datasets/dataset.py:1458-1464)
                used = set(ids)
                strong_pool = [p for p in strong_pool if p not in used]
                soft_pool = [p for p in soft_pool if p not in used]
            if len(batch) == self.P * self.K:
                yielded += 1
                yield batch
            else:
                dropped += 1
        if dropped:
            logging.getLogger(__name__).warning(
                "sampler dropped %d/%d short batches (degenerate ids in pool)",
                dropped,
                self.steps_per_epoch,
            )
        if yielded == 0:
            raise RuntimeError(
                "sampler produced no complete batches — every candidate id is "
                f"degenerate (strong={len(self.strong_ids)}, soft={len(self.soft_ids)}, "
                f"P={self.P}, K={self.K})"
            )
