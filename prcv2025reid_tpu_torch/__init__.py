"""PyTorch / CUDA port of the multi-modal Re-ID system for NVIDIA Hopper.

The JAX package ``prcv2025reid_tpu`` is the reference this port is held
against; the port imports nothing from it.  Entry points:
``engine.build_model``, ``engine.make_combo_embed_step``,
``engine.make_embed_step``, ``engine.make_weighted_embed_step`` and, for
training, ``engine.init_train_state``, ``engine.make_train_step`` and the
whole loop, ``Trainer`` (``training/trainer.py``; ``tools_torch/train.py``
is its command line).  ``tools_torch/eval_mm_protocol.py`` evaluates a
saved checkpoint.

The names below load on first access (a module ``__getattr__``): importing
the package, or one of its torch-free host modules (``configs``,
``data.dataset``, ``data.sampler``, ``data.pipeline`` ...), imports no torch,
so the host pipeline's spawn workers, which unpickle a dataset, never load
the model stack.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Trainer": "prcv2025reid_tpu_torch.training.trainer",
    "TrainingConfig": "prcv2025reid_tpu_torch.configs",
    "build_model": "prcv2025reid_tpu_torch.engine",
    "init_train_state": "prcv2025reid_tpu_torch.engine",
    "make_combo_embed_step": "prcv2025reid_tpu_torch.engine",
    "make_embed_step": "prcv2025reid_tpu_torch.engine",
    "make_train_step": "prcv2025reid_tpu_torch.engine",
    "make_weighted_embed_step": "prcv2025reid_tpu_torch.engine",
    "init_params": "prcv2025reid_tpu_torch.params",
    "load_params": "prcv2025reid_tpu_torch.params",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
