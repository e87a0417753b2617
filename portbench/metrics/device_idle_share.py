"""1 - the profiled jobs' device busy time over the untraced wall of the
same seeds, in % (portbench.readers.idle_share)."""
from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
