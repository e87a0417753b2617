"""The least time for the profiled jobs' minimum-volume NMF work
(portbench/roofline_mvnmf.py, from each lane's own iterations at its own
rank) over their device busy time (portbench.readers.work_roofline);
None where a job has no bound."""
from portbench.readers import work_roofline


def read(ctx):
    traced = ctx.get("traced") or []
    if any(job["untraced"]["work"].get("bound_s") is None for job in traced):
        return None
    return work_roofline(ctx)
