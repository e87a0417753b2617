"""Device time from a torch.profiler trace: the union of the intervals in
which an operation ran on the device, the time by operation, and the idle
gaps named by what the host had open when each began.

The busy-share arithmetic follows chip_smoke.py:1504-1534 (``device_busy``:
traced device time over the untraced wall of the same work), with the
union of intervals in place of its sum of kernel durations.
"""

from __future__ import annotations

JOB_SPAN = "portbench.job"
KERNEL_TAG = "mu_block_"  # the names of the port's MU kernels hold it
TOP = 10                  # entries of each list of the breakdown


def merged(intervals):
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def union_seconds(intervals) -> float:
    """Total length of the union of [start, end) intervals (any unit in,
    the same unit out)."""
    return sum(end - start for start, end in merged(intervals))


def idle_gaps(busy, window):
    """The gaps of `window` = (start, end) that no busy interval covers,
    as (start, end) pairs."""
    gaps, cursor = [], window[0]
    for start, end in merged(busy):
        if start > cursor:
            gaps.append((cursor, min(start, window[1])))
        cursor = max(cursor, end)
        if cursor >= window[1]:
            break
    if cursor < window[1]:
        gaps.append((cursor, window[1]))
    return [gap for gap in gaps if gap[1] > gap[0]]


def open_at(host_events, time):
    """The innermost host event (name, start, end) open at `time`: the
    latest-starting one that contains it; None if none does."""
    best = None
    for name, start, end in host_events:
        if start <= time <= end and (best is None or start >= best[1]):
            best = (name, start, end)
    return best


def read_profile(prof):
    """(device, host) events of a finished torch.profiler run, each a
    list of (name, start_ns, end_ns). The benchmark's span also casts a
    shadow on the device timeline (a "gpu_user_annotation"), which is no
    device work and is left out."""
    import torch

    device, host = [], []
    for event in prof.profiler.kineto_results.events():
        item = (event.name(), event.start_ns(),
                event.start_ns() + event.duration_ns())
        if event.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif item[0] != JOB_SPAN:
            device.append(item)
    return device, host


def summarize(device, host):
    """What the metric readers and the result's breakdown take from one
    traced run: per job span its wall, busy seconds (union), seconds of
    kernels whose name holds KERNEL_TAG and their count; the device
    operations by time; the longest idle gaps by the host event open at
    their start."""
    spans = sorted((start, end) for name, start, end in host
                   if name == JOB_SPAN)
    jobs = []
    for start, end in spans:
        inside = [(s, e, name) for name, s, e in device
                  if s < end and e > start]
        tagged = [(s, e) for s, e, name in inside if KERNEL_TAG in name]
        jobs.append({
            "wall_s": (end - start) / 1e9,
            "busy_s": union_seconds((max(s, start), min(e, end))
                                    for s, e, _ in inside) / 1e9,
            "kernel_s": union_seconds(tagged) / 1e9,
            "kernel_count": len(tagged),
        })
    by_name: dict[str, float] = {}
    for name, start, end in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e9
    device_ops = sorted(by_name.items(), key=lambda item: -item[1])[:TOP]
    gaps = []
    inner = [event for event in host if event[0] != JOB_SPAN]
    for start, end in spans:
        busy = [(s, e) for _, s, e in device if s < end and e > start]
        gaps.extend(idle_gaps(busy, (start, end)))
    gaps = sorted(gaps, key=lambda gap: gap[0] - gap[1])[:TOP]
    named = []
    for start, end in gaps:
        event = open_at(inner, start)
        named.append([event[0] if event else JOB_SPAN, (end - start) / 1e9])
    return {
        "jobs": jobs,
        "device_ops": [[name[:200], seconds] for name, seconds in device_ops],
        "idle_gaps": [[name[:200], seconds] for name, seconds in named],
    }
