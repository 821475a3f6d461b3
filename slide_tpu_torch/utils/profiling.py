"""Profiling (counterpart: `slide_tpu/utils/profiling.py`): a device trace
from `torch.profiler` and a step timer that waits for the device."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Trace the enclosed block with `torch.profiler` (host operations, and
    the card's kernels where there is a card) and write a Chrome trace,
    `<log_dir>/trace.json` (Perfetto or chrome://tracing read it).  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with a warm-up skip and a percentile summary.
    With a CUDA `device` it synchronises that device before it reads the
    clock on entry and on exit, so a step's asynchronous launches are timed
    to their end."""

    def __init__(self, skip_first: int = 1, device: Optional[torch.device] = None):
        self.skip_first = skip_first
        self.device = None if device is None else torch.device(device)
        self.times: list[float] = []
        self._seen = 0
        self._t = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)
        return False

    def summary(self) -> dict:
        """mean_s, p50_s, p95_s, n and steps_per_sec of the timed steps ({}
        before any)."""
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"mean_s": float(arr.mean()), "p50_s": float(np.median(arr)),
                "p95_s": float(np.percentile(arr, 95)), "n": len(arr),
                "steps_per_sec": float(1.0 / arr.mean())}
