"""Newton steps per joint EM cycle in the traced calls: the program's
counters corrnmf.newton_steps.signature and corrnmf.newton_steps.sample
(one step advances every row of every lane) over mmcorrnmf.cycles."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    cycles = counted(found, "mmcorrnmf.cycles") if found else 0
    if not cycles:
        return None
    return (counted(found, "corrnmf.newton_steps.signature")
            + counted(found, "corrnmf.newton_steps.sample")) / cycles
