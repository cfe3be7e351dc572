"""PyTorch / CUDA port of the multi-modal Re-ID system for NVIDIA Hopper.

The JAX package ``prcv2025reid_tpu`` is the reference this port is held
against; the port imports nothing from it.  Entry points:
``engine.build_model``, ``engine.make_combo_embed_step`` and, for training,
``engine.init_train_state`` and ``engine.make_train_step``.
"""
from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.engine import (
    build_model,
    init_train_state,
    make_combo_embed_step,
    make_train_step,
)
from prcv2025reid_tpu_torch.params import init_params, load_params

__all__ = [
    "TrainingConfig",
    "build_model",
    "init_params",
    "init_train_state",
    "load_params",
    "make_combo_embed_step",
    "make_train_step",
]
