"""The least time for the profiled jobs' joint EM cycles
(portbench/roofline_corrnmf.py, from the Newton steps the program counted)
over their device busy time (portbench.readers.work_roofline); None where
a job has no bound (a program that does not count its Newton steps)."""
from portbench.readers import work_roofline


def read(ctx):
    traced = ctx.get("traced") or []
    if any(job["untraced"]["work"].get("bound_s") is None for job in traced):
        return None
    return work_roofline(ctx)
