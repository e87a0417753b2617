"""Milliseconds of a fit's set-up (the program's restarts.init span: the
starting points, the initial objective and the loop state, up to the
first engine span) per restarts.fit call of the traced jobs."""
from portbench.program_record import per_fit_ms


def read(ctx):
    return per_fit_ms(ctx, "restarts.init")
