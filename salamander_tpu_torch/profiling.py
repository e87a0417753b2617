"""Observability, held against salamander_tpu/profiling.py: named phase
timers whose clock stops when the device work is done, and one-line access
to torch.profiler for a device trace.

A phase ends with ``torch.cuda.synchronize()`` on its CUDA device, so it
times completion, not the enqueue; a failed synchronization is an error
(it means the device work failed), never skipped. ``device_trace`` records
CPU and CUDA activity and writes a Chrome trace JSON (chrome://tracing,
Perfetto) into its directory.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

__all__ = ["Timings", "device_trace", "phase", "timed_fit"]


@dataclass
class Timings:
    """Accumulated named phase durations (seconds)."""

    phases: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        width = max((len(k) for k in self.phases), default=0)
        lines = [
            f"{name:<{width}}  {seconds:9.3f}s  x{self.counts[name]}"
            for name, seconds in sorted(
                self.phases.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines)


def _synchronize(device) -> None:
    """Wait for the work queued on `device` when it is a CUDA device; None
    means every card this process has used. Errors propagate."""
    if device is None:
        if torch.cuda.is_initialized():
            for index in range(torch.cuda.device_count()):
                torch.cuda.synchronize(index)
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def phase(timings: Timings, name: str, device=None):
    """Time a named phase; the device's queued work is finished before the
    clock stops (device=None: every card in use)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        _synchronize(device)
        timings.add(name, time.perf_counter() - start)


@contextmanager
def device_trace(log_dir: str):
    """Record CPU and CUDA activity with torch.profiler and write the
    Chrome trace JSON into log_dir (created if missing). Yields the
    profiler, whose key_averages() sum the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as profiler:
        yield profiler
    profiler.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


def timed_fit(model, adata, timings: Timings | None = None, **fit_kwargs):
    """model.fit on the model's device, timed to completion as the phase
    "fit" (the JAX package's "fit(total, incl. compile)": nothing is
    compiled here). Returns (model, Timings)."""
    timings = timings or Timings()
    with phase(timings, "fit", model.device):
        model.fit(adata, **fit_kwargs)
    return model, timings
