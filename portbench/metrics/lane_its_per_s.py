"""lane_its_per_s: MU iterations of every lane of every fit finished in
the window, over the window's seconds."""
from portbench.readers import rate


def read(ctx):
    return rate(ctx, "lane_iterations")
