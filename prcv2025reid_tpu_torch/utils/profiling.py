"""Profiling and step-timing utilities (the port's counterpart of the JAX
package's ``utils/profiling.py``).

- ``trace``: context manager around ``torch.profiler.profile`` (CPU and CUDA
  activities) that writes a Chrome trace JSON into ``log_dir`` when the scope
  ends (``utils/trace_table.py`` reads it back).
- ``StepTimer``: cheap steady-state step timing with warmup discard; it does
  not synchronise the device inside the loop (pair it with one synchronise
  at the end, or a periodic metric fetch).  A copy of JAX's.
- ``cost_summary``: FLOPs of one call counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (JAX's reads XLA's cost
  analysis).  Only the keys the backend gives are returned, as JAX's does:
  the counter gives ``flops`` and no ``bytes_accessed``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope on the CPU and, where there is one, the CUDA card;
    on exit write ``<log_dir>/trace_<pid>_<ns>.pt.trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._last: Optional[float] = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def steps_per_sec(self) -> float:
        m = self.mean_step_time
        return 1.0 / m if m > 0 else 0.0


def cost_summary(fn, *args, **kwargs) -> Dict[str, float]:
    """Operation count of one ``fn(*args, **kwargs)`` call: {"flops": n}
    (PyTorch's counter: 2 per multiply-add of the products and convolutions
    it knows); {} when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return {"flops": float(flops)} if flops else {}
