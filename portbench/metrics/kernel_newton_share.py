"""% of the unrolled CorrNMF Newton solves (the sample side's 3 steps;
counters corrnmf.newton_solves.sample and .signature) that the program
ran in its kernel (counter corrnmf.newton_solves_in_kernel) rather than
as plain steps, over the traced jobs. None where the program keeps no
record or counts no unrolled solve."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    solves = (counted(found, "corrnmf.newton_solves.sample")
              + counted(found, "corrnmf.newton_solves.signature")
              if found else 0)
    if not solves:
        return None
    return 100.0 * counted(found, "corrnmf.newton_solves_in_kernel") / solves
