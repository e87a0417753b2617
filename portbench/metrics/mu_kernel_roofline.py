"""The least time for the profiled jobs' MU work over the device time
of the kernels named mu_block_* (portbench.readers.kernel_roofline)."""
from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx)
