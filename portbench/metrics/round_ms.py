"""Milliseconds of an assignment call's wall per elimination round
(meta["n_rounds"]), averaged over the window's calls."""
from portbench.readers import done


def read(ctx):
    calls = done(ctx)
    if not calls:
        return None
    return sum(1e3 * call["work"]["call_s"] / call["work"]["n_rounds"]
               for call in calls) / len(calls)
