"""Device time of one call on the CUDA card, from CUDA events (the benchmark
tools' second reading beside their host clocks).

Not from torch.profiler's per-kernel sums: in a long-lived process they
drop kernels (``chip_smoke.py`` phase 4f prints both for one ranking call,
beside the least time its f32 product can take), while CUDA events around
the same call hold."""
from __future__ import annotations

import time
from typing import Callable

import torch

CLOCK_HZ = 2e9  # ~ an H100's clock, to size the spin kernel


def device_ms(fn: Callable[[], object]) -> float:
    """The device time of one ``fn()`` in ms: CUDA events around it, queued
    behind a spin kernel 1.5x as long as one whole call takes on the host
    clock, so the host has issued every launch before the device starts and
    the events time the device's span, not the host's issue.  ``fn`` runs
    twice (the first call is that host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1.5 * CLOCK_HZ * (time.perf_counter() - t0)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
