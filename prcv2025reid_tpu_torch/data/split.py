"""ID-disjoint train/val splitting (own copy of the JAX package's
``data/split.py``).

Reference: tools/split.py:12-139 — shuffle ids by seed, slice by ratio,
assert disjoint+complete, and keep ONE shared pid2label over train ∪ val
(train.py:1317-1323 sizes the classifier with |train ∪ val| ids).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset


def split_ids(
    person_ids: Sequence[int], val_ratio: float, seed: int
) -> Tuple[List[int], List[int]]:
    ids = sorted(person_ids)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ids))
    n_val = int(round(len(ids) * val_ratio))
    val = sorted(ids[i] for i in perm[:n_val])
    train = sorted(ids[i] for i in perm[n_val:])
    assert not (set(train) & set(val)), "train/val ids overlap"
    assert set(train) | set(val) == set(ids), "split does not cover all ids"
    return train, val


def create_split_datasets(
    config: TrainingConfig,
) -> Tuple[MultiModalDataset, MultiModalDataset, Dict[int, int]]:
    """Build train/val datasets with a shared global label space."""
    full = MultiModalDataset(config, split="train")
    train_ids, val_ids = split_ids(full.person_ids, config.val_ratio, config.seed)
    all_ids = sorted(set(train_ids) | set(val_ids))
    pid2label = {pid: i for i, pid in enumerate(all_ids)}
    # reuse the expanded records — annotation parsing + pid-dir globbing is
    # the expensive part and is split-independent
    train_ds = MultiModalDataset(
        config, "train", person_ids=train_ids, pid2label=pid2label, records=full.records
    )
    val_ds = MultiModalDataset(
        config, "val", person_ids=val_ids, pid2label=pid2label, records=full.records
    )
    return train_ds, val_ds, pid2label


def verify_split_integrity(
    train_ds: MultiModalDataset, val_ds: MultiModalDataset
) -> bool:
    train_pids = {r.pid for r in train_ds.records}
    val_pids = {r.pid for r in val_ds.records}
    assert not (train_pids & val_pids), "records leak across the id split"
    shared = set(train_ds.pid2label.items()) == set(val_ds.pid2label.items())
    assert shared, "train/val must share one pid2label table"
    return True
