"""The least time for the profiled jobs' MU work over their device busy
time, whatever ran (portbench.readers.work_roofline)."""
from portbench.readers import work_roofline


def read(ctx):
    return work_roofline(ctx)
