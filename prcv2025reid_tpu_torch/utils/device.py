"""The device an entry point runs on.  No model code here: the bundle
server (``tools_torch/serve_artifact.py``) resolves its device without
loading the models."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain versions on the CPU"
        )
    return dev
