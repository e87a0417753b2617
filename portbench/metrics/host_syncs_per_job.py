"""The host's reads of device state per traced job: the program's
counters engine.host_syncs and ops.host_syncs over the jobs' calls."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    if found is None:
        return None
    return (counted(found, "engine.host_syncs")
            + counted(found, "ops.host_syncs")) / len(found)
