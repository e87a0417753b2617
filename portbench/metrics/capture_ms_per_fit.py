"""Milliseconds of CUDA graph capture (the program's engine.capture span,
capture_begin to capture_end) per restarts.fit call of the traced jobs."""
from portbench.program_record import per_fit_ms


def read(ctx):
    return per_fit_ms(ctx, "engine.capture")
