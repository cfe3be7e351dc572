"""Synthetic ORBench-style dataset generator (own copy of the JAX
package's ``utils/synthetic.py``: the same arguments write the same bytes).

Used by the port's tests, by ``chip_smoke.py``'s dataset phase and as a
data-free way to exercise the data path and the dataset evaluation before
real ORBench data is available.

Layout mirrors the reference's annotation contract
(reference: datasets/dataset.py:341-447): JSON lists only vis paths +
captions; nir is an identity-level pool; sk/cp filenames carry
front/back/side view tags.

Identity signal (round 5): each identity is a LOW-FREQUENCY color-block
pattern (a small random grid bilinearly upsampled to the image size),
shared across all modalities, plus per-image pixel noise.  Low-frequency
matters: the round-4 flagship probe showed that a per-PIXEL random base
pattern is destroyed by RandomResizedCrop + resize resampling, leaving
cross-modal retrieval unlearnable at any scale — a blocky pattern survives
crops, JPEG, and downsampling, so retrieval = "match the color layout",
which also GENERALIZES to held-out identities (the val-split gate).
nir/sk are written grayscale (luminance of the base) like real ORBench, so
the channel-adapter path is honestly exercised.
"""
from __future__ import annotations

import json
import os

import numpy as np


def make_synthetic_orbench(
    root, num_ids=6, anchors_per_id=2, img_size=48, pattern_cells=6
):
    """Write a tiny ORBench-style tree: vis/nir/sk/cp dirs + text_annos.json."""
    from PIL import Image

    g = np.random.default_rng(1234)
    annos = []
    for pid in range(1, num_ids + 1):
        pid_str = f"{pid:04d}"
        for mod in ("vis", "nir", "sk", "cp"):
            os.makedirs(os.path.join(root, mod, pid_str), exist_ok=True)

        id_rng = np.random.default_rng(10_000 + pid)
        cells = id_rng.integers(
            30, 225, (pattern_cells, pattern_cells, 3)
        ).astype(np.uint8)
        base = np.asarray(
            Image.fromarray(cells).resize(
                (img_size, img_size), Image.BILINEAR
            ),
            dtype=np.int16,
        )

        def _write(relpath, mod):
            noise = g.integers(-25, 25, (img_size, img_size, 3))
            arr = np.clip(base + noise, 0, 255).astype(np.uint8)
            if mod in ("nir", "sk"):  # grayscale modalities in real ORBench
                lum = arr.mean(axis=2).astype(np.uint8)
                arr = np.stack([lum] * 3, axis=2)
            Image.fromarray(arr).save(os.path.join(root, relpath))

        for a in range(anchors_per_id):
            rel = f"vis/{pid_str}/{pid_str}_cam{a}_{a:04d}_vis.jpg"
            _write(rel, "vis")
            annos.append(
                {
                    "file_path": rel,
                    "caption": f"person {pid} wearing outfit {a} walking",
                }
            )
        for n in range(2):
            _write(f"nir/{pid_str}/{pid_str}_nir_{n:04d}.jpg", "nir")
        for view in ("front", "back"):
            _write(f"sk/{pid_str}/{pid_str}_{view}_sk.jpg", "sk")
            _write(f"cp/{pid_str}/{pid_str}_{view}_cp.jpg", "cp")
    with open(os.path.join(root, "text_annos.json"), "w") as f:
        json.dump(annos, f)
    return root
