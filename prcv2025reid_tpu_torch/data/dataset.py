"""ORBench-style multi-modal dataset (own copy of the JAX package's
``data/dataset.py``; imports no torch: the pipeline's workers unpickle it).

Reference: datasets/dataset.py:309-723 (MultiModalDataset).  Annotation
contract (guide20 rules reproduced from _load_annotations,
datasets/dataset.py:341-447):

- ``text_annos.json`` is a list of ``{"file_path": "vis/0941/0941_....jpg",
  "caption": "..."}`` entries — only VIS paths + captions.
- PID parses from the second path component.
- Each VIS anchor expands to a multi-modal record: the anchor vis image, ALL
  NIR images of that PID (identity-level pool), and SK/CP images grouped by
  view (front/back/side via filename substring; unknown -> front).
- Text pairs 1:1 with the anchor VIS image.

Samples are produced as dense numpy arrays: images [Mv, H, W, 3] uint8 in
[0, 255] (zeros for missing modalities; ImageNet normalization happens
on the device — see data/device_feed.py::normalize_images_device), image_mask [Mv],
caption, label.  Randomness uses explicit numpy Generators (reproducible +
checkpointable).
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.data.augment import ImageTransform
from prcv2025reid_tpu_torch.utils.modalities import VISION_MODALITIES

VIEWS = ("front", "back", "side")
_IMG_EXTS = ("*.jpg", "*.jpeg", "*.png")


@dataclass
class Record:
    """One multi-modal record (a VIS anchor expanded to all modalities)."""

    pid: int
    anchor_vis: str
    caption: str
    file_path: str
    vis: List[str] = field(default_factory=list)
    nir: List[str] = field(default_factory=list)
    sk_by_view: Dict[str, List[str]] = field(default_factory=dict)
    cp_by_view: Dict[str, List[str]] = field(default_factory=dict)

    def pool(self, modality: str) -> List[str]:
        if modality == "vis":
            return self.vis
        if modality == "nir":
            return self.nir
        by_view = self.sk_by_view if modality == "sk" else self.cp_by_view
        return [p for v in VIEWS for p in by_view.get(v, [])]

    def modality_mask(self) -> Dict[str, float]:
        return {
            "vis": 1.0 if self.vis else 0.0,
            "nir": 1.0 if self.nir else 0.0,
            "sk": 1.0 if self.pool("sk") else 0.0,
            "cp": 1.0 if self.pool("cp") else 0.0,
            "text": 1.0 if self.caption else 0.0,
        }

    def modalities(self) -> Set[str]:
        return {m for m, v in self.modality_mask().items() if v > 0}


def _glob_images(directory: str) -> List[str]:
    out: List[str] = []
    for ext in _IMG_EXTS:
        out.extend(glob.glob(os.path.join(directory, ext)))
    return sorted(out)


def _group_by_view(paths: Sequence[str]) -> Dict[str, List[str]]:
    """front/back/side by filename substring; unknown -> front
    (reference: datasets/dataset.py:395-408)."""
    groups: Dict[str, List[str]] = {v: [] for v in VIEWS}
    for p in paths:
        name = os.path.basename(p)
        for view in VIEWS:
            if f"_{view}_" in name:
                groups[view].append(p)
                break
        else:
            groups["front"].append(p)
    return groups


class MultiModalDataset:
    """Host-side dataset: JSON annotations -> expanded multi-modal records."""

    def __init__(
        self,
        config: TrainingConfig,
        split: str = "train",
        person_ids: Optional[Sequence[int]] = None,
        pid2label: Optional[Dict[int, int]] = None,
        records: Optional[List[Record]] = None,
    ):
        self.config = config
        self.split = split
        self.is_training = split == "train"
        # ``records`` lets a split reuse an already-expanded dataset instead
        # of re-reading the annotation JSON and re-globbing every pid dir
        # (the pools are identity-level, independent of the split).
        self.records = list(records) if records is not None else self._load_annotations()
        if person_ids is not None:
            keep = set(person_ids)
            self.records = [r for r in self.records if r.pid in keep]
            self.person_ids = sorted(keep)
        else:
            self.person_ids = sorted({r.pid for r in self.records})
        # shared global label space may be injected (tools/split.py:61-78 keeps
        # one pid2label over train ∪ val)
        self.pid2label = pid2label or {p: i for i, p in enumerate(self.person_ids)}
        self.transform = ImageTransform(
            image_size=config.image_size,
            train=self.is_training,
            crop_scale_min=config.crop_scale_min,
            flip=config.random_flip,
            random_crop=config.random_crop,
            color_jitter=config.color_jitter_strength if config.color_jitter else 0.0,
            random_erase=config.random_erase,
        )

    # ----- loading -----

    def _load_annotations(self) -> List[Record]:
        with open(self.config.json_file, encoding="utf-8") as f:
            annotations = json.load(f)

        root = self.config.data_root
        # identity-level pools are shared across anchors of a pid — scan once
        nir_cache: Dict[str, List[str]] = {}
        view_cache: Dict[str, Dict[str, List[str]]] = {}

        records: List[Record] = []
        for entry in annotations:
            file_path = entry.get("file_path", "")
            caption = entry.get("caption", "")
            parts = file_path.split("/")
            if len(parts) < 2 or not parts[1].isdigit():
                continue
            pid_str = parts[1]
            pid = int(pid_str)

            anchor = os.path.join(root, file_path)
            rec = Record(pid=pid, anchor_vis=anchor, caption=caption, file_path=file_path)
            if os.path.exists(anchor):
                rec.vis.append(anchor)

            if pid_str not in nir_cache:
                nir_cache[pid_str] = _glob_images(os.path.join(root, "nir", pid_str))
            rec.nir = nir_cache[pid_str]

            for mod in ("sk", "cp"):
                key = f"{mod}/{pid_str}"
                if key not in view_cache:
                    view_cache[key] = _group_by_view(
                        _glob_images(os.path.join(root, mod, pid_str))
                    )
                if mod == "sk":
                    rec.sk_by_view = view_cache[key]
                else:
                    rec.cp_by_view = view_cache[key]
            records.append(rec)
        return records

    def __len__(self) -> int:
        return len(self.records)

    # ----- sample production -----

    def _load_image(self, path: str, rng: Optional[np.random.Generator]) -> np.ndarray:
        return self.transform.load_and_transform(
            path,
            rng if self.is_training else None,
            use_native=self.config.use_native_decode,
        )

    def get_sample(
        self, idx: int, rng: np.random.Generator, modality_dropout: Optional[float] = None
    ) -> Dict:
        """Produce one training/eval sample (reference: datasets/dataset.py:512-613).

        Selection rules: vis = anchor image; nir = random from identity pool;
        sk/cp = random from a shared target view with view -> any-view -> flat
        fallback.  Per-modality dropout (train only) zeroes the image and its
        mask.  Failures produce zero placeholders, never exceptions.
        """
        rec = self.records[idx]
        S = self.config.image_size
        if modality_dropout is None:
            modality_dropout = (
                self.config.modality_dropout if self.is_training else 0.0
            )
        target_view = (
            VIEWS[int(rng.integers(0, len(VIEWS)))] if self.is_training else "front"
        )

        images = np.zeros((len(VISION_MODALITIES), S, S, 3), np.uint8)
        mask = np.zeros(len(VISION_MODALITIES), np.float32)
        for mi, mod in enumerate(VISION_MODALITIES):
            if modality_dropout > 0 and rng.random() <= modality_dropout:
                continue
            path = self._select_path(rec, mod, target_view, rng)
            if path is None:
                continue
            try:
                images[mi] = self._load_image(path, rng)
                mask[mi] = 1.0
            except Exception:
                pass  # zero placeholder (datasets/dataset.py:593-597)

        return {
            "pid": rec.pid,
            "label": self.pid2label.get(rec.pid, -1),
            "images": images,
            "image_mask": mask,
            "caption": rec.caption,
            "text_mask": 1.0 if rec.caption else 0.0,
            "index": idx,
            "anchor_vis": rec.anchor_vis,
        }

    def _select_path(
        self,
        rec: Record,
        mod: str,
        target_view: str,
        rng: np.random.Generator,
        any_view_fallback: bool = True,
    ) -> Optional[str]:
        """Pick one image path for ``mod``.  sk/cp try ``target_view`` first;
        the train path (reference: datasets/dataset.py:545-586) then tries a
        random non-empty view before the flat pool, while the eval-query path
        (dataset.py:651-659) falls straight to the flat pool."""
        if mod == "vis":
            if rec.vis:
                return rec.anchor_vis if rec.anchor_vis in rec.vis else rec.vis[0]
            return None
        if mod == "nir":
            return (
                rec.nir[int(rng.integers(0, len(rec.nir)))] if rec.nir else None
            )
        by_view = rec.sk_by_view if mod == "sk" else rec.cp_by_view
        pool = by_view.get(target_view) or []
        if not pool and any_view_fallback:
            views_avail = [v for v in VIEWS if by_view.get(v)]
            if views_avail:
                v = views_avail[int(rng.integers(0, len(views_avail)))]
                pool = by_view[v]
        if not pool:
            pool = rec.pool(mod)
        return pool[int(rng.integers(0, len(pool)))] if pool else None

    def get_query_sample(
        self,
        idx: int,
        query_modalities: Sequence[str],
        rng: np.random.Generator,
    ) -> Dict:
        """Eval-protocol sample restricted to the given modalities with a
        shared target view (reference: datasets/dataset.py:615-678).

        The shared view is drawn at random per query and sk/cp fall straight
        from it to the flat pool — exactly the reference's
        ``get_multimodal_query`` (dataset.py:634,651-659), NOT the train
        path's view->any-view->flat chain."""
        rec = self.records[idx]
        S = self.config.image_size
        target_view = VIEWS[int(rng.integers(0, len(VIEWS)))]
        images = np.zeros((len(VISION_MODALITIES), S, S, 3), np.uint8)
        mask = np.zeros(len(VISION_MODALITIES), np.float32)
        wants_text = "text" in query_modalities
        for mi, mod in enumerate(VISION_MODALITIES):
            if mod not in query_modalities:
                continue
            path = self._select_path(
                rec, mod, target_view, rng, any_view_fallback=False
            )
            if path is None:
                continue
            try:
                images[mi] = self._load_image(path, None)
                mask[mi] = 1.0
            except Exception:
                pass
        return {
            "pid": rec.pid,
            "label": self.pid2label.get(rec.pid, -1),
            "images": images,
            "image_mask": mask,
            "caption": rec.caption if wants_text else "",
            "text_mask": 1.0 if (wants_text and rec.caption) else 0.0,
            "index": idx,
            "anchor_vis": rec.anchor_vis,
        }


# modality spellings from older dataset layouts; their presence in a data
# tree means the normalization that produced vis/nir/sk/cp did not run
LEGACY_MODALITY_NAMES = {"rgb", "ir", "sketch", "cpencil"}


def quick_scan(dataset: "MultiModalDataset", n: int = 200) -> Dict:
    """Fast data-health self-check (reference: datasets/dataset.py:158-185
    ``quick_scan``): per-modality counts and the vis<->non-vis pair ratio
    over the first ``n`` records, plus legacy modality-name leakage
    detection — the reference checks the canonicalized sample modalities for
    {'rgb','ir','sketch','cpencil'}; here Record fields are canonical by
    construction, so the check moves to where leakage could actually enter:
    the data tree's top-level directory names."""
    records = dataset.records[: min(n, len(dataset.records))]
    counts = {m: 0 for m in ("vis", "nir", "sk", "cp", "text")}
    pair = 0
    for rec in records:
        mods = rec.modalities()
        for m in mods:
            counts[m] += 1
        if "vis" in mods and bool(mods & {"nir", "sk", "cp", "text"}):
            pair += 1
    leaked = []
    root = dataset.config.data_root
    if root and os.path.isdir(root):
        leaked = sorted(
            d
            for d in os.listdir(root)
            if d.lower() in LEGACY_MODALITY_NAMES
            and os.path.isdir(os.path.join(root, d))
        )
    return {
        "scanned": len(records),
        "per_modality": counts,
        "pair_ratio": pair / max(1, len(records)),
        "legacy_names": leaked,
    }


def analyze_sampling_capability(
    dataset: MultiModalDataset, limit: Optional[int] = None
) -> Dict:
    """Pre-flight data-health check (reference: datasets/dataset.py:95-157).

    Counts per-modality availability and "strong" IDs (have both a vis and a
    non-vis side) — training aborts when no ID is pairable
    (reference: train.py:1371-1375).  ``limit=None`` scans the full dataset
    (the abort decision must not be made on a prefix); pass a limit only for
    quick interactive panels.
    """
    per_modality = {m: 0 for m in ("vis", "nir", "sk", "cp", "text")}
    pid_sides: Dict[int, List[bool]] = {}
    records = dataset.records if limit is None else dataset.records[:limit]
    for rec in records:
        mods = rec.modalities()
        for m in mods:
            per_modality[m] += 1
        has_vis = "vis" in mods
        has_nonvis = bool(mods - {"vis"})
        side = pid_sides.setdefault(rec.pid, [False, False])
        side[0] |= has_vis
        side[1] |= has_nonvis
    strong = [p for p, (v, nv) in pid_sides.items() if v and nv]
    return {
        "num_records": len(records),
        "num_ids": len(pid_sides),
        "per_modality": per_modality,
        "strong_ids": len(strong),
        "pairable": len(strong) > 0,
    }
