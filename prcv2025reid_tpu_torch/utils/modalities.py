"""Modality canonicalization and fixed orderings (own copy of the JAX
package's ``utils/modalities.py``).

Batches are dense ``[B, M, ...]`` tensors with slot index == modality id;
all routing in the encoder keys off these integer ids, never strings.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

# Canonical names, fixed order. Vision slots come first so that slot index in
# the stacked image tensor equals the vision modality id.
VISION_MODALITIES = ("vis", "nir", "sk", "cp")
MODALITIES = VISION_MODALITIES + ("text",)

VISION_MODALITY_ID: Dict[str, int] = {m: i for i, m in enumerate(VISION_MODALITIES)}
MODALITY_ID: Dict[str, int] = {m: i for i, m in enumerate(MODALITIES)}

# Vision modalities patchified from grayscale (nir/sk are 1-channel).
SINGLE_CHANNEL = ("nir", "sk")

# Alias map: dataset names / legacy names -> canonical.
_ALIASES: Dict[str, str] = {
    "vis": "vis", "rgb": "vis", "visible": "vis", "v": "vis",
    "nir": "nir", "ir": "nir", "infrared": "nir",
    "sk": "sk", "sketch": "sk",
    "cp": "cp", "cpencil": "cp", "colorpencil": "cp", "coloredpencil": "cp",
    "text": "text", "txt": "text", "caption": "text",
}


def canon_mod(name: Optional[str]) -> str:
    """Map any alias to its canonical modality name; unknown names pass
    through lowercased/stripped, None -> ""."""
    if name is None:
        return ""
    key = str(name).strip().lower()
    return _ALIASES.get(key, key)


def canon_mods(names: Iterable[str]) -> List[str]:
    """Canonicalize, dedupe (order-preserving), and keep only known names."""
    out = []
    for n in names:
        c = canon_mod(n)
        if c in MODALITIES and c not in out:
            out.append(c)
    return out


def is_truthy(v) -> bool:
    """Truthiness for mask-ish annotation fields: containers by length,
    numbers by > 0.5, strings by non-whitespace content, arrays by
    non-emptiness (+ |x|.sum() > 1e-6 when floating)."""
    import numpy as np

    if v is None:
        return False
    if isinstance(v, (list, tuple, set, dict)):
        return len(v) > 0
    if isinstance(v, (bool, int, float)):
        return float(v) > 0.5
    if isinstance(v, str):
        return len(v.strip()) > 0
    if isinstance(v, np.ndarray):
        if v.size == 0:
            return False
        return float(np.abs(v).sum()) > 1e-6 if np.issubdtype(v.dtype, np.floating) else True
    return True
