"""% of the MvNMF line searches of the traced calls that ended at the
gamma floor with the trial still worse than the objective they started
from: the program's counter mvnmf.floor_stops over mvnmf.searches. None
where the program counts no search."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    searches = counted(found, "mvnmf.searches") if found else 0
    if not searches:
        return None
    return 100.0 * counted(found, "mvnmf.floor_stops") / searches
