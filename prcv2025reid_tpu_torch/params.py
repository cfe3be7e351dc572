"""Weight bridge: the JAX package's flat ``/``-keyed parameter dict (the
``tools/export_params.py::params_to_npz`` format, i.e.
``flax.traverse_util.flatten_dict({"params": ..., "batch_stats": ...},
sep="/")``) into the port's modules, and a numpy-only initialiser that
builds the same dict.

The port's modules carry the flax names and layouts, so the state-dict key
of ``params/a/b/c`` (or ``batch_stats/a/b/c``) is ``a.b.c`` and every array
is copied as it is: kernels ``[in, out]``, ``lora_A [M, in, r]``,
``lora_B [M, r, out]``, patch kernels ``[P, P, C, D]``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from prcv2025reid_tpu_torch.configs import TrainingConfig

COLLECTIONS = ("params", "batch_stats")
# keys of the JAX tree that belong to modules this port does not have yet:
# none since the SDM module came with the training step
NOT_YET_PORTED = ()
# init_params draws the keys of each later group after all earlier ones, so
# that a module added to the port leaves every earlier key's values as they
# were: the text tower and text_proj came after the vision path, the SDM
# module after them
LATER_GROUPS = (("params/encoder/text/", "params/encoder/text_proj/"),
                ("params/sdm_module/",))


def _draw_order(key: str):
    """(group, key): the keys of the first port's modules (group -1), then
    each LATER_GROUPS entry in turn, each sorted by key."""
    group = next((i for i, g in enumerate(LATER_GROUPS) if key.startswith(g)), -1)
    return group, key


def _torch_name(key: str) -> str:
    return key.split("/", 1)[1].replace("/", ".")


def load_params(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> List[str]:
    """Copy ``flat`` into ``model`` in place; returns the keys it did not
    consume.  Raises on a shape mismatch or a model tensor left unset."""
    state = model.state_dict()
    consumed, skipped = set(), []
    for key in sorted(flat):
        name = _torch_name(key) if key.split("/", 1)[0] in COLLECTIONS else None
        if name not in state:
            skipped.append(key)
            continue
        arr = np.array(flat[key], dtype=np.float32)  # a writable copy
        dst = state[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(arr))
        consumed.add(name)
    missing = sorted(set(state) - consumed)
    if missing:
        raise ValueError(f"parameters missing from the checkpoint: {missing[:8]}")
    return skipped


def check_skipped(skipped: List[str]) -> None:
    """Raise on any unconsumed key outside the not-yet-ported modules."""
    unknown = [k for k in skipped if not k.startswith(NOT_YET_PORTED)]
    if unknown:
        raise ValueError(f"checkpoint keys the port does not know: {unknown[:8]}")


def param_shapes(config: TrainingConfig, num_classes: int) -> Dict[str, tuple]:
    """The JAX tree's keys and shapes for the modules the port has."""
    from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel

    model = MultiModalReIDModel(config, num_classes, device=torch.device("meta"))
    buffers = {n for n, _ in model.named_buffers()}
    return {
        ("batch_stats/" if n in buffers else "params/") + n.replace(".", "/"): tuple(t.shape)
        for n, t in model.state_dict().items()
    }


def init_params(config: TrainingConfig, num_classes: int, seed: int = 0,
                perturb: bool = True) -> Dict[str, np.ndarray]:
    """A flat parameter dict with the JAX tree's keys and shapes, from numpy
    alone, seeded.  Initialisers follow the JAX package's (lecun-normal
    kernels, uniform lora_A, 0.02-normal tokens, the text tower's
    0.01-normal positions and fan-in-normal embedding rows; keys drawn in
    ``_draw_order``).  JAX zero-initialises
    lora_B, biases and the BN running mean and sets LN/BN scales and the
    running variance to 1, which would hide a LoRA-folding, bias or BN bug:
    with ``perturb`` those get seeded nonzero values."""
    rng = np.random.default_rng(seed)
    out = {}
    shapes = param_shapes(config, num_classes)
    for key in sorted(shapes, key=_draw_order):
        shape = shapes[key]
        leaf = key.rsplit("/", 1)[1]
        if leaf == "lora_A":
            bound = shape[-2] ** -0.5
            a = rng.uniform(-bound, bound, shape)
        elif leaf == "lora_B":
            a = rng.normal(0.0, 0.5, shape) if perturb else np.zeros(shape)
        elif leaf == "kernel" and "classifier" in key:
            a = rng.normal(0.0, 0.001, shape)
        elif leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == "embedding":  # flax Embed: variance scaling over the width
            a = rng.normal(0.0, shape[-1] ** -0.5, shape)
        elif leaf == "pos_embed" and key.startswith("params/encoder/text/"):
            a = rng.normal(0.0, 0.01, shape)
        elif leaf in ("cls_token", "pos_embed", "null_tokens"):
            a = rng.normal(0.0, 0.02, shape)
        elif leaf == "bias" or leaf == "mean":
            a = rng.normal(0.0, 0.05, shape) if perturb else np.zeros(shape)
        elif leaf == "scale":
            a = 1.0 + rng.normal(0.0, 0.05, shape) if perturb else np.ones(shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape) if perturb else np.ones(shape)
        else:
            raise KeyError(f"no initialiser for {key}")
        out[key] = a.astype(np.float32)
    return out
