"""Observability, held against salamander_tpu/profiling.py: named phase
timers whose clock stops when the device work is done, one-line access
to torch.profiler for a device trace, and the program's own spans and
counters.

A phase ends with ``torch.cuda.synchronize()`` on its CUDA device, so it
times completion, not the enqueue; a failed synchronization is an error
(it means the device work failed), never skipped. ``device_trace`` records
CPU and CUDA activity and writes a Chrome trace JSON (chrome://tracing,
Perfetto) into its directory.

Spans and counters. ``span(name)`` marks a stretch of the program. While
recording - a torch.profiler profile records in this process, or inside
``recording()`` - it opens the host range ``salamander.<name>``, so the
range lands on the profiler's timeline beside the device activity, and
the open call keeps the span as ``(name, start_ns, end_ns, parent,
call)``: start and end on ``time.time_ns()``, the clock of the profiler's
events, ``parent`` the index of the enclosing span in the call's spans
(None for the call's root). The range is a function-scope record
(``torch._C._profiler._RecordFunctionFast``), not
``torch.profiler.record_function``: a user annotation of that kind is
also drawn on the device's timeline over the kernels it launched, where
a reading of device time would count it as device work. Otherwise a
span does nothing: one module-level check, no allocation, no torch call.
A public entry (``entry``) opens a root span, a call, whose spans and
counter increments the record keeps; the last RING calls stay
(``calls``). ``count(name, n)`` adds to a process-wide host integer
(``counters``) always, and while recording to the open call's too. One
thread's spans nest into that thread's call only.
"""

from __future__ import annotations

import collections
import functools
import itertools
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Timings", "calls", "count", "counters", "device_trace",
           "end_prelude", "entry", "is_recording", "phase", "prelude",
           "recording", "span", "timed_fit"]

RING = 64            # calls the record keeps
PREFIX = "salamander."  # of every range the program opens

# process-wide counts by name (count): host integers, never a device read
counters: dict[str, int] = {}

_recording = 0  # depth of recording() scopes
_ring: collections.deque = collections.deque(maxlen=RING)
_call_ids = itertools.count()
_local = threading.local()  # .call: this thread's open _Call, if any


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


# --------------------------------------------------------------------- #
# spans and counters
# --------------------------------------------------------------------- #


def is_recording() -> bool:
    """Whether spans record: a torch.profiler profile records in this
    process, or a recording() scope is open."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


@contextmanager
def recording():
    """Record spans and calls without a profiler (nests)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class _Off:
    """The span while nothing records: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Call:
    __slots__ = ("id", "spans", "counts", "open", "prelude")

    def __init__(self):
        self.id = next(_call_ids)
        self.spans: list = []    # [name, start_ns, end_ns, parent, call]
        self.counts: dict = {}
        self.open: list = []     # indices of the open spans, innermost last
        self.prelude = None      # the open prelude's _Span


class _Span:
    __slots__ = ("name", "root", "range", "call", "index")

    def __init__(self, name: str, root: bool):
        self.name = name
        self.root = root
        self.range = None
        self.call = None
        self.index = None

    def __enter__(self):
        self.range = torch._C._profiler._RecordFunctionFast(
            PREFIX + self.name)
        self.range.__enter__()
        call = getattr(_local, "call", None)
        if call is None and self.root:
            call = _local.call = _Call()
        if call is not None:
            self.call, self.index = call, len(call.spans)
            call.spans.append([self.name, time.time_ns(), None,
                               call.open[-1] if call.open else None,
                               call.id])
            call.open.append(self.index)
        return None

    def __exit__(self, *exc):
        call = self.call
        if call is not None:
            if call.prelude is not None and call.prelude is not self \
                    and call.open[-1] == call.prelude.index:
                call.prelude.__exit__(None, None, None)
            call.spans[self.index][2] = time.time_ns()
            call.open.pop()
            if call.prelude is self:
                call.prelude = None
            if not call.open:
                _local.call = None
                _ring.append(call)
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking `name` (module docstring); does nothing
    while nothing records."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, False)


def entry(name: str):
    """Decorate a public entry: each call runs inside the root span `name`,
    a call of the record, unless it runs inside another call, where it is
    a span of that one."""
    def decorate(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_recording or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name, True):
                return fn(*args, **kwargs)

        return run

    return decorate


def prelude(name: str) -> None:
    """Open the span `name` in the open call, to last until end_prelude()
    (the engine's first span of a fit) or the end of the span that
    encloses it. One prelude is open at a time; outside a call this does
    nothing."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    call = getattr(_local, "call", None)
    if call is None or call.prelude is not None:
        return
    call.prelude = _Span(name, False)
    call.prelude.__enter__()


def end_prelude() -> None:
    """Close the open call's prelude where it is the innermost open span."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    call = getattr(_local, "call", None)
    if call is not None and call.prelude is not None \
            and call.open[-1] == call.prelude.index:
        call.prelude.__exit__(None, None, None)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`; while recording, to the open call's
    count of it too."""
    counters[name] = counters.get(name, 0) + n
    if _recording or _autograd_profiler._is_profiler_enabled:
        call = getattr(_local, "call", None)
        if call is not None:
            call.counts[name] = call.counts.get(name, 0) + n


def calls(n: int = RING) -> list[dict]:
    """The last n finished calls of the record, oldest first: each a dict
    of its ``id``, its root span's ``name``, its ``spans`` as (name,
    start_ns, end_ns, parent, call) tuples in the order they opened, and
    its ``counts`` (the counter increments made while it was open)."""
    kept = list(_ring)[-n:] if n > 0 else []
    return [{"id": call.id, "name": call.spans[0][0],
             "spans": [tuple(item) for item in call.spans],
             "counts": dict(call.counts)} for call in kept]
