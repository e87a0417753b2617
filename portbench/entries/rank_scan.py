"""The KL-NMF model-selection scan: ``rank_scan_klnmf(X, ranks, R,
seed=job_seed, config=FitConfig(...))`` in float32 at the port's defaults
otherwise (one unpadded fit_klnmf_restarts a rank, rank k at position
offset from seed + 1000 * offset), one call a job on the run's cohort."""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import klnmf as ref
from ..roofline import lanes_bound_s
from . import counted
from . import restarts as per_rank


def prepare(config: dict, traffic: dict, seed: int, device) -> dict:
    import torch

    from salamander_tpu_torch import FitConfig

    counts = inputs.counts(config, seed).to_numpy().T  # (V, D)
    return {
        "X": counts,
        "X_dev": torch.as_tensor(counts, dtype=torch.float32, device=device),
        "device": device,
        "ranks": [int(k) for k in traffic["ranks"]],
        "R": int(traffic["n_restarts"]),
        "fit_config": FitConfig(*traffic["fit_config"]),
        "warm_config": FitConfig(*traffic["warm_config"]),
        "traffic": traffic,
    }


def checked_ranks(state, job_seed: int) -> list:
    """The ranks a job's check compares, drawn from its seed: the
    largest, and check_ranks - 1 others."""
    ranks = state["ranks"]
    n = min(int(state["traffic"]["check_ranks"]), len(ranks))
    rng = np.random.default_rng(int(job_seed))
    others = rng.choice(len(ranks) - 1, size=n - 1, replace=False)
    return sorted([ranks[-1]] + [ranks[int(i)] for i in others])


def _scan(state, seed: int, fit_config, keep=()):
    import torch

    from salamander_tpu_torch import rank_scan_klnmf

    results = rank_scan_klnmf(state["X_dev"], state["ranks"], state["R"],
                              seed=seed, config=fit_config,
                              dtype=torch.float32, device=state["device"])
    return {k: {"W": result.W.cpu().numpy() if k in keep else None,
                "H": result.H.cpu().numpy() if k in keep else None,
                "losses": np.asarray(result.losses, np.float64),
                "n_iterations": np.asarray(result.n_iterations)}
            for k, result in results.items()}


def warm(state) -> None:
    _scan(state, 0, state["warm_config"])


def job(state, seed: int) -> dict:
    keep = checked_ranks(state, seed)
    output, counters = counted(lambda: _scan(state, seed,
                                             state["fit_config"], keep))
    V, D = state["X"].shape
    lanes = [(k, it) for k, fit in output.items()
             for it in fit["n_iterations"]]
    return {
        "work": {
            "jobs": 1,
            "lane_iterations": int(sum(it for _, it in lanes)),
            "bound_s": lanes_bound_s(V, D, lanes, False),
        },
        "counters": counters,
        "output": output,
    }


# entries/restarts.py's numbers this cell does not compare: on the card
# the program's best lane read up to 8.9e-6 from float64's best against the
# control's 3.6e-5 at the least, and up to 17 lanes of a rank stopped at
# another block than float64's where the control's fewest was 1 (the
# unpromoted float32 objective's stops); the limits file keeps the readings
NOT_COMPARED = ("best_loss_gap", "iterations_differing")


def check(state, records, seed: int, arith=ref.FLOAT64, program=True):
    """The restarts cell's numbers (entries/restarts.py's check: the
    median lane's loss and factors, the lanes apart, the reported loss)
    but NOT_COMPARED, each the worst over the checked ranks
    (checked_ranks) of the sampled jobs, every rank against
    reference/klnmf.py's restarts from its own seed, seed + 1000 *
    offset. With program=False the reference in `arith` stands in for the
    program (the control)."""
    from . import sampled

    gaps: dict = {}
    traffic = dict(state["traffic"], check_jobs=1)
    for record in sampled(records, seed,
                          int(state["traffic"]["check_jobs"])):
        for k in checked_ranks(state, record["seed"]):
            offset = state["ranks"].index(k)
            rank_state = dict(state, K=k, traffic=traffic)
            rank_record = {"seed": record["seed"] + 1000 * offset,
                           "failed": False,
                           "output": record.get("output", {}).get(k)}
            for name, value in per_rank.check(rank_state, [rank_record], seed,
                                              arith, program):
                if name not in NOT_COMPARED:
                    gaps[name] = max(gaps.get(name, 0.0), value)
    return list(gaps.items())
