"""% of the lane-steps the engine ran (engine.lane_steps: lanes in the
batch x steps) that stepped a lane already done (the rest is
engine.lane_steps_live, the lanes' own iterations), over the traced
jobs."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    steps = counted(found, "engine.lane_steps") if found else 0
    if not steps:
        return None
    return 100.0 * (1.0 - counted(found, "engine.lane_steps_live") / steps)
