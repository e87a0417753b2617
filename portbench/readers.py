"""The arithmetic the metric readers share. A reader gets the run's
context:

- ``setup_s``, ``window_s``;
- ``jobs``: the window's job records (``wall_s``, ``failed``, ``work``,
  ``counters``);
- ``traced``: with ``--trace 1``, one entry per profiled job (``wall_s``
  under the profiler, ``busy_s`` the union of device intervals,
  ``kernel_s`` and ``kernel_count`` of the MU kernels, ``untraced`` the
  window's record of the same seed); otherwise None.

A reader returns None where the run holds nothing for it to read: never
0 for a share of a bound.
"""

from __future__ import annotations


def done(ctx) -> list:
    return [job for job in ctx["jobs"] if not job["failed"]]


def work_sum(ctx, key: str) -> float:
    return sum(job["work"][key] for job in done(ctx))


def rate(ctx, key: str):
    """The window's `key` work over the window's seconds."""
    if not done(ctx):
        return None
    return work_sum(ctx, key) / ctx["window_s"]


def mean_work(ctx, key: str):
    jobs = done(ctx)
    return sum(job["work"][key] for job in jobs) / len(jobs) if jobs else None


def per_job(ctx, counter: str):
    """A program counter's change over the window, per finished job."""
    jobs = done(ctx)
    if not jobs:
        return None
    return sum(job["counters"][counter] for job in jobs) / len(jobs)


def kernel_roofline(ctx):
    """% of the MU kernels' device time that the least time for the MU
    work of the profiled jobs is."""
    traced = ctx.get("traced")
    kernel_s = sum(job["kernel_s"] for job in traced or [])
    if not kernel_s:
        return None
    bound = sum(job["untraced"]["work"]["bound_s"] for job in traced)
    return 100.0 * bound / kernel_s


def work_roofline(ctx):
    """% of the profiled jobs' device busy time that the least time for
    their MU work is, whatever kernels did it."""
    traced = ctx.get("traced")
    busy_s = sum(job["busy_s"] for job in traced or [])
    if not busy_s:
        return None
    bound = sum(job["untraced"]["work"]["bound_s"] for job in traced)
    return 100.0 * bound / busy_s


def idle_share(ctx):
    """% of the untraced wall of the profiled jobs' seeds in which the
    device ran nothing, by the traced busy time of the same jobs."""
    traced = ctx.get("traced")
    busy_s = sum(job["busy_s"] for job in traced or [])
    if not busy_s:
        return None
    wall = sum(job["untraced"]["wall_s"] for job in traced)
    return 100.0 * (1.0 - busy_s / wall)
