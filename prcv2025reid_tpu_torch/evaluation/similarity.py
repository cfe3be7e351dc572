"""The ranking's f32 product (``protocol.similarity``, re-exported there).
No model code here: the bundle server's gallery search imports it."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _full_f32():
    """f32 products in full f32 (no TF32) inside the scope."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def similarity(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q [Nq, D] @ g [Ng, D].T in full f32 (no TF32)."""
    with _full_f32():
        return q @ g.T
