"""The program's own record of the traced jobs: the spans and counter
increments that salamander_tpu_torch.profiling keeps of each call of a
public entry while a torch.profiler profile records.

run.py profiles only the traced jobs, each one call of the port's entry,
and reads the per-layer metrics right after, so the last
``len(ctx["traced"])`` calls of ``profiling.calls()`` are those jobs. A
program that keeps no record (no ``profiling.calls``) gives None, and so
does every reader of it. A span is (name, start_ns, end_ns, parent,
call); its times are on the host's clock.
"""

from __future__ import annotations


def calls(ctx):
    """The traced jobs' calls, oldest first, or None where the run traced
    nothing or the program kept no record of it."""
    traced = ctx.get("traced")
    if not traced:
        return None
    try:
        from salamander_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "calls", None)
    if read is None:
        return None
    found = read(len(traced))
    return found if len(found) == len(traced) else None


def spans(record, name: str) -> list:
    """Every span called `name` in the calls of `record`."""
    return [span for call in record for span in call["spans"]
            if span[0] == name]


def seconds(record, name: str) -> float:
    """The summed seconds of the spans called `name`."""
    return sum(span[2] - span[1] for span in spans(record, name)) / 1e9


def counted(record, name: str) -> int:
    """The counter `name`'s increments made within the calls."""
    return sum(call["counts"].get(name, 0) for call in record)


def untraced_wall(ctx) -> float:
    """The untraced wall of the traced jobs' seeds (readers.idle_share's
    base)."""
    return sum(job["untraced"]["wall_s"] for job in ctx["traced"])


def share_of_wall(ctx, name: str):
    """% of the traced jobs' untraced wall that the spans called `name`
    took in the traced run."""
    found = calls(ctx)
    if found is None:
        return None
    return 100.0 * seconds(found, name) / untraced_wall(ctx)


def per_fit_ms(ctx, name: str):
    """Milliseconds of the spans called `name` per restarts.fit span."""
    found = calls(ctx)
    fits = len(spans(found, "restarts.fit")) if found else 0
    if not fits:
        return None
    return 1e3 * seconds(found, name) / fits
