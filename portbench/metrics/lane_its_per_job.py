"""The sum of replicate_iterations over an extraction job, averaged
over the window's jobs: the MU work the convergence rule asked for."""
from portbench.readers import mean_work


def read(ctx):
    return mean_work(ctx, "lane_iterations")
