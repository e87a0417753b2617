"""CUDA graphs the engine captured in the window, per fit
(engine.graph_counts["captures"]): each capture is a stall in a fit."""
from portbench.readers import per_job


def read(ctx):
    return per_job(ctx, "captures")
