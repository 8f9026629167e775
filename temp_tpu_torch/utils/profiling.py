"""Profiling helpers.

- ``trace(log_dir)``: a ``torch.profiler`` context (CPU activity, and CUDA
  activity where a card is visible) that writes a Chrome trace
  (``trace.<pid>.<ns>.json``) into `log_dir`; open it in Perfetto or
  ``chrome://tracing``;
- ``StepTimer``: wall-clock EMA of step latency, synchronizing the card;
- ``device_memory_stats()``: live, peak and total memory of each visible
  card, in MB.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; yields `log_dir`, which holds the trace at exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


def _sync(x) -> None:
    """Wait for the card of `x`: a tensor, a device, or a list or tuple of
    them; nothing for the CPU."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _sync(y)
        return
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepTimer:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            _sync(sync_on)
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (
            self.alpha * dt + (1 - self.alpha) * self.ema)
        return dt


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{"cuda:i": {"bytes_in_use_mb", "peak_bytes_mb", "bytes_limit_mb"}}
    for each visible card (PyTorch's allocator: allocated, its peak since
    the last reset, and the card's total memory); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use_mb": torch.cuda.memory_allocated(i) / 1e6,
        "peak_bytes_mb": torch.cuda.max_memory_allocated(i) / 1e6,
        "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory
        / 1e6} for i in range(torch.cuda.device_count())}
