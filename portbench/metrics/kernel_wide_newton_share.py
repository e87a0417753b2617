"""% of the CorrNMF Newton solves of rows with more than OTHERS_MAX others
(the signature side's samples; counter corrnmf.newton_solves_wide) that
the program ran in its wide kernel (counter
corrnmf.newton_solves_wide_in_kernel) rather than as plain steps, over
the traced jobs. None where the program keeps no record or counts no
wide solve (a program without the counters)."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    solves = counted(found, "corrnmf.newton_solves_wide") if found else 0
    if not solves:
        return None
    return (100.0 * counted(found, "corrnmf.newton_solves_wide_in_kernel")
            / solves)
