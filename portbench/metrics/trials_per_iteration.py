"""Trials the MvNMF line search evaluated per lane-step that searched,
over the traced calls: the program's counters mvnmf.lane_trials (each
lane's first trial and every later one) over mvnmf.searches (the lanes
that entered a search; a lockstep batch's done lanes search too, on both
sides of the ratio). None where the program counts no search."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    searches = counted(found, "mvnmf.searches") if found else 0
    if not searches:
        return None
    return counted(found, "mvnmf.lane_trials") / searches
