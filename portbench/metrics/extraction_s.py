"""extraction_s: the window's seconds over the extraction jobs finished."""
from portbench.readers import done


def read(ctx):
    jobs = done(ctx)
    return ctx["window_s"] / len(jobs) if jobs else None
