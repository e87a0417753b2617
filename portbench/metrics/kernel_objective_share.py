"""% of the blocks the engine ran (engine.block_evals) whose convergence
objective came from the block update's own kernel launch
(engine.block_evals_in_kernel) rather than from plain ops after it, over
the traced jobs."""
from portbench.program_record import calls, counted


def read(ctx):
    found = calls(ctx)
    blocks = counted(found, "engine.block_evals") if found else 0
    if not blocks:
        return None
    return 100.0 * counted(found, "engine.block_evals_in_kernel") / blocks
