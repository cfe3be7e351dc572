"""Process-level glue for the trainer and the checkpoints (the part of the
JAX package's ``utils/distributed.py`` that they call), for one process.

The port runs one process on one device: ``is_main_process`` is True and
``barrier`` has nothing to wait for.  A run that ``torch.distributed`` has
set up with more than one process raises, naming the ROADMAP.md item that
multi-process training waits for; it never carries on as if it were alone.
No torch import at module level: the host pipeline's workers stay free of
it.
"""
from __future__ import annotations

import sys


def _single_process() -> None:
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"a process group of {dist.get_world_size()} processes: multi-process "
            "training is not ported yet: ROADMAP.md §1, the item 'Parallel and "
            "multi-process'")


def is_main_process() -> bool:
    """The process that writes the host-side artifacts: the only one."""
    _single_process()
    return True


def barrier(name: str = "") -> None:
    """A cross-process sync point; one process has nothing to wait for."""
    _single_process()
