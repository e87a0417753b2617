"""Mean milliseconds of an elimination round (the program's assign.round
span: a round's candidates, accept and polish through the read that
closes it) in the traced calls."""
from portbench.program_record import calls, spans


def read(ctx):
    found = calls(ctx)
    rounds = spans(found, "assign.round") if found else []
    if not rounds:
        return None
    return sum(span[2] - span[1] for span in rounds) / 1e6 / len(rounds)
