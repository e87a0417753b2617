"""assigned_samples_per_s: samples assigned in the window over its
seconds."""
from portbench.readers import rate


def read(ctx):
    return rate(ctx, "samples")
