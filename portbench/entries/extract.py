"""De novo consensus extraction: ``extract_signatures(cohort, ranks,
n_bootstraps, seed)`` at the port's defaults otherwise, one call a job on
the run's cohort, every job's resamples and starts drawn from its own
seed."""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import extraction as ref
from ..reference.klnmf import FLOAT64
from ..roofline import lanes_bound_s
from . import counted, sampled


def prepare(config: dict, traffic: dict, seed: int, device) -> dict:
    cohort = inputs.counts(config, seed)
    return {"cohort": cohort, "X": cohort.to_numpy().T, "device": device,
            "ranks": list(traffic["ranks"]),
            "n_bootstraps": int(traffic["n_bootstraps"]), "traffic": traffic,
            "fit_config": tuple(traffic["fit_config"])}


def _extract(state, seed: int, fit_config):
    from salamander_tpu_torch import extract_signatures

    min_iterations, max_iterations, conv_test_freq, tol = fit_config
    result = extract_signatures(
        state["cohort"], state["ranks"], n_bootstraps=state["n_bootstraps"],
        seed=seed, min_iterations=min_iterations,
        max_iterations=max_iterations, conv_test_freq=conv_test_freq,
        tol=tol, dtype="float32", device=state["device"])
    return {
        "ranks": {k: {"losses": np.asarray(result.replicate_losses[k]),
                      "iterations": np.asarray(result.replicate_iterations[k]),
                      "consensus": result.consensus[k].to_numpy(),
                      "silhouettes": np.asarray(result.silhouettes[k])}
                  for k in state["ranks"]},
        "suggested": result.suggested_rank,
    }


def warm(state) -> None:
    """The cell's ranks and cohort through a short fit: every group's
    kernels and graph captures, the clustering and the refits."""
    _extract(state, 0, tuple(state["traffic"]["warm_config"]))


def job(state, seed: int) -> dict:
    output, counters = counted(lambda: _extract(state, seed,
                                                state["fit_config"]))
    V, D = state["X"].shape
    lanes = [(k, it) for k in state["ranks"]
             for it in output["ranks"][k]["iterations"]]
    return {
        "work": {
            "jobs": 1,
            "lane_iterations": int(sum(it for _, it in lanes)),
            "bound_s": lanes_bound_s(V, D, lanes, True),
        },
        "counters": counters,
        "output": output,
    }


def _cosine_gap(got, truth) -> float:
    """1 - the cosine of each reference consensus signature to its
    nearest one of the program's, at the worst."""
    a = got / np.linalg.norm(got, axis=1, keepdims=True)
    b = truth / np.linalg.norm(truth, axis=1, keepdims=True)
    return float(np.max(1.0 - np.max(b @ a.T, axis=1)))


def check(state, records, seed: int, arith=FLOAT64, program=True):
    """The worst over the sampled jobs and ranks of: the median and the
    widest lane's final loss against the reference's (relative), the
    consensus signatures (1 - cosine), the minimum and mean silhouettes
    (absolute), and the suggested rank (1 where it differs). With
    program=False the reference in `arith` stands in for the program (the
    control)."""
    gaps = {"median_lane_loss_gap": 0.0, "widest_lane_loss_gap": 0.0,
            "consensus_gap": 0.0, "silhouette_gap": 0.0, "rank_differs": 0.0}
    for record in sampled(records, seed, int(state["traffic"]["check_jobs"])):
        truth = ref.extract(state["X"], state["ranks"], state["n_bootstraps"],
                            record["seed"], state["fit_config"], FLOAT64,
                            device=state["device"])
        got = record["output"] if program else ref.extract(
            state["X"], state["ranks"], state["n_bootstraps"],
            record["seed"], state["fit_config"], arith, device=state["device"])
        for k in state["ranks"]:
            g, t = got["ranks"][k], truth["ranks"][k]
            lanes = np.abs(g["losses"] - t["losses"]) / t["losses"]
            gaps["median_lane_loss_gap"] = max(gaps["median_lane_loss_gap"],
                                               float(np.median(lanes)))
            gaps["widest_lane_loss_gap"] = max(gaps["widest_lane_loss_gap"],
                                               float(np.max(lanes)))
            gaps["consensus_gap"] = max(
                gaps["consensus_gap"],
                _cosine_gap(g["consensus"], t["consensus"]))
            for stat in (np.min, np.mean):
                gaps["silhouette_gap"] = max(
                    gaps["silhouette_gap"],
                    abs(float(stat(g["silhouettes"]))
                        - float(stat(t["silhouettes"]))))
        gaps["rank_differs"] = max(
            gaps["rank_differs"], float(got["suggested"] != truth["suggested"]))
    return list(gaps.items())
