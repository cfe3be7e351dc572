"""A model's inference state <-> one flat ``.npz`` (counterpart of the JAX
package's ``tools/export_params.py``; the same file).

The file holds ``params/...`` and ``batch_stats/...`` keyed by the flax
tree's ``/``-joined paths, each array in the flax layout, as JAX's
``params_to_npz`` writes it: JAX's ``npz_to_params`` loads what
:func:`params_to_npz` writes into a ``MultiModalReIDModel`` tree, and
``params.load_params`` / ``engine.build_model`` load it into the port.

CLI (a checkpoint the port's trainer wrote, ``state.pt`` + ``host_state.json``):
    python3 -m prcv2025reid_tpu_torch.tools.export_params \\
        --model_path ./checkpoints/best --out model.npz [--cpu]
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from prcv2025reid_tpu_torch.params import load_params


def _flat_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``params/a/b/c`` for the parameter ``a.b.c``, ``batch_stats/...`` for
    a buffer: the flat keys of the model's state dict."""
    buffers = {n for n, _ in model.named_buffers()}
    return {("batch_stats/" if n in buffers else "params/") + n.replace(".", "/"): t
            for n, t in model.state_dict().items()}


def flat_params(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and BN statistics as the flat dict
    ``params.load_params`` reads, f32 on the host."""
    return {k: t.detach().float().cpu().numpy() for k, t in _flat_tensors(model).items()}


def params_to_npz(path: str, model: torch.nn.Module) -> str:
    """Write ``model``'s flat dict to ``path``; returns the path written
    (``.npz`` appended where missing, as ``np.savez`` does)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **flat_params(model))
    return path


def npz_to_params(path: str, model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Load a flat npz into ``model`` in place, its keys and shapes checked
    against the model's as JAX's ``npz_to_params`` checks them against its
    template; returns the flat dict."""
    want = {k: tuple(t.shape) for k, t in _flat_tensors(model).items()}
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    missing = [k for k in want if k not in flat]
    extra = [k for k in flat if k not in want]
    if missing or extra:
        raise ValueError(f"npz/tree mismatch: missing={missing[:5]} extra={extra[:5]}")
    for k, shape in want.items():
        if tuple(flat[k].shape) != tuple(shape):
            raise ValueError(f"shape mismatch at {k}: {flat[k].shape} vs {shape}")
    load_params(model, flat)
    return flat


def main(argv=None, device="cuda"):
    import argparse
    import os

    from prcv2025reid_tpu_torch.engine import load_checkpoint_model

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_path", required=True,
                    help="a checkpoint directory (state.pt + host_state.json)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true", help="load the checkpoint on the CPU")
    args = ap.parse_args(argv)

    _, model, _, _ = load_checkpoint_model(os.path.abspath(args.model_path),
                                           "cpu" if args.cpu else device)
    written = params_to_npz(args.out, model)
    print(f"wrote {written}")
    return written


if __name__ == "__main__":
    main()
