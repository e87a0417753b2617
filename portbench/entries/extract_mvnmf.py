"""De novo consensus extraction by minimum-volume NMF:
``extract_signatures(cohort, ranks, n_bootstraps, model="mvnmf", lam,
delta, seed)`` at the port's defaults otherwise, one call a job on the
run's cohort, every job's resamples and starts drawn from its own seed;
lam and delta are the configuration's."""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import mvnmf as ref
from ..reference.klnmf import FLOAT64
from ..roofline_mvnmf import lanes_bound_s
from . import counted, sampled
from .extract import _cosine_gap


def prepare(config: dict, traffic: dict, seed: int, device) -> dict:
    cohort = inputs.counts(config, seed)
    model = config["model"]
    return {"cohort": cohort, "X": cohort.to_numpy().T, "device": device,
            "lam": float(model["lam"]), "delta": float(model["delta"]),
            "ranks": list(traffic["ranks"]),
            "n_bootstraps": int(traffic["n_bootstraps"]), "traffic": traffic,
            "fit_config": tuple(traffic["fit_config"])}


def _extract(state, seed: int, fit_config):
    from salamander_tpu_torch import extract_signatures

    min_iterations, max_iterations, conv_test_freq, tol = fit_config
    result = extract_signatures(
        state["cohort"], state["ranks"], n_bootstraps=state["n_bootstraps"],
        seed=seed, model="mvnmf", lam=state["lam"], delta=state["delta"],
        min_iterations=min_iterations, max_iterations=max_iterations,
        conv_test_freq=conv_test_freq, tol=tol, dtype="float32",
        device=state["device"])
    return {
        "ranks": {k: {"losses": np.asarray(result.replicate_losses[k]),
                      "iterations": np.asarray(result.replicate_iterations[k]),
                      "consensus": result.consensus[k].to_numpy(),
                      "silhouettes": np.asarray(result.silhouettes[k])}
                  for k in state["ranks"]},
        "suggested": result.suggested_rank,
    }


def warm(state) -> None:
    """The cell's ranks and cohort through a short fit: the padded batch,
    its searches, the clustering and the refits."""
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
            "bound_s": lanes_bound_s(V, D, lanes),
        },
        "counters": counters,
        "output": output,
    }


def check(state, records, seed: int, arith=FLOAT64, program=True):
    """The worst over the sampled jobs and ranks of: the median and the
    widest lane's final penalized loss against the float64 reference's
    from the same resample and start (relative), the consensus signatures
    (1 - cosine), the minimum and mean silhouettes (absolute), and the
    suggested rank (1 where it differs). With program=False the reference
    in `arith` stands in for the program (the control)."""
    gaps = {"median_lane_loss_gap": 0.0, "widest_lane_loss_gap": 0.0,
            "consensus_gap": 0.0, "silhouette_gap": 0.0, "rank_differs": 0.0}
    args = (state["X"], state["ranks"], state["n_bootstraps"])
    for record in sampled(records, seed, int(state["traffic"]["check_jobs"])):
        truth = ref.extract(*args, record["seed"], state["fit_config"],
                            state["lam"], state["delta"], FLOAT64,
                            device=state["device"])
        got = record["output"] if program else ref.extract(
            *args, record["seed"], state["fit_config"], state["lam"],
            state["delta"], arith, device=state["device"])
        for k in state["ranks"]:
            g, t = got["ranks"][k], truth["ranks"][k]
            lanes = np.abs(g["losses"] - t["losses"]) / np.abs(t["losses"])
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
