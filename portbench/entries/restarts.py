"""Multi-start KL-NMF: ``fit_klnmf_restarts(X, K, R, seed, FitConfig)``,
one call a job, every job's starting points drawn from its own seed."""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..reference import klnmf as ref
from ..roofline import lanes_bound_s
from . import counted, rel_gap, sampled


def prepare(config: dict, traffic: dict, seed: int, device) -> dict:
    import torch

    from salamander_tpu_torch import FitConfig

    counts = inputs.counts(config, seed).to_numpy().T  # (V, D)
    return {
        "X": counts,
        "X_dev": torch.as_tensor(counts, dtype=torch.float32, device=device),
        "device": device,
        "K": int(traffic["n_signatures"]),
        "R": int(traffic["n_restarts"]),
        "fit_config": FitConfig(*traffic["fit_config"]),
        "warm_config": FitConfig(*traffic["warm_config"]),
        "traffic": traffic,
    }


def _fit(state, seed: int, fit_config):
    import torch

    from salamander_tpu_torch import fit_klnmf_restarts

    result = fit_klnmf_restarts(state["X_dev"], state["K"], state["R"],
                                seed=seed, config=fit_config,
                                dtype=torch.float32, device=state["device"])
    return {"W": result.W.cpu().numpy(), "H": result.H.cpu().numpy(),
            "losses": np.asarray(result.losses, np.float64),
            "n_iterations": np.asarray(result.n_iterations)}


def warm(state) -> None:
    _fit(state, 0, state["warm_config"])


def job(state, seed: int) -> dict:
    output, counters = counted(lambda: _fit(state, seed,
                                            state["fit_config"]))
    V, D = state["X"].shape
    iterations = output["n_iterations"]
    return {
        "work": {
            "fits": 1,
            "lane_iterations": int(iterations.sum()),
            "bound_s": lanes_bound_s(V, D, [(state["K"], it)
                                            for it in iterations], False),
        },
        "counters": counters,
        "output": output,
    }


# A lane is apart from float64 whose loss lies LOSS_APART (relative) or
# more from the reference's, or whose W or H lies FACTOR_APART (relative
# Frobenius) or more from it. A sound fit has at most one such lane: one
# still descending at the window's end, whose phase rounding shifts
# (PERF.md); the control has dozens.
LOSS_APART = 1e-5
FACTOR_APART = 1e-3


def check(state, records, seed: int, arith=ref.FLOAT64, program=True):
    """The worst over the sampled fits of: the median lane's final loss
    against the reference's (relative), the median lane's factors against
    the reference's (relative Frobenius distance, W or H, whichever is
    further), the best lane's loss against the reference's best (what a
    caller keeps), the lanes apart from the reference by loss and by
    factors, each lane's reported loss against the float64 KL of its
    reported factors (relative), and the lanes whose iteration count
    differs. With program=False the reference in `arith` stands in for
    the program (the control)."""
    import torch

    fit_config = tuple(state["traffic"]["fit_config"])
    X64 = torch.as_tensor(state["X"], dtype=torch.float64,
                          device=state["device"])
    gaps = {"median_loss_gap": 0.0, "median_factor_gap": 0.0,
            "best_loss_gap": 0.0, "lanes_apart_loss": 0.0,
            "lanes_apart_factors": 0.0, "reported_loss_gap": 0.0,
            "iterations_differing": 0.0}
    for record in sampled(records, seed, int(state["traffic"]["check_jobs"])):
        truth = ref.restarts(state["X"], state["K"], state["R"],
                             record["seed"], fit_config, ref.FLOAT64,
                             device=state["device"])
        if program:
            out = record["output"]
            got = (out["W"], out["H"], out["losses"], out["n_iterations"])
        else:
            got = ref.restarts(state["X"], state["K"], state["R"],
                               record["seed"], fit_config, arith,
                               device=state["device"])
        losses = np.asarray(got[2], np.float64)
        lanes = np.abs(losses - truth[2]) / truth[2]
        factor = np.zeros(len(truth[2]))
        for a, b in ((got[0], truth[0]), (got[1], truth[1])):
            a = np.asarray(a, np.float64).reshape(len(b), -1)
            b = b.reshape(len(b), -1)
            factor = np.maximum(factor, np.linalg.norm(a - b, axis=1)
                                / np.linalg.norm(b, axis=1))
        own = ref.kl(X64, torch.as_tensor(np.asarray(got[0], np.float64),
                                          device=state["device"]),
                     torch.as_tensor(np.asarray(got[1], np.float64),
                                     device=state["device"])).cpu().numpy()
        best = abs(losses.min() - truth[2].min()) / truth[2].min()
        for name, value in (
                ("median_loss_gap", float(np.median(lanes))),
                ("median_factor_gap", float(np.median(factor))),
                ("best_loss_gap", float(best)),
                ("lanes_apart_loss", float(np.sum(lanes >= LOSS_APART))),
                ("lanes_apart_factors",
                 float(np.sum(factor >= FACTOR_APART))),
                ("reported_loss_gap", rel_gap(losses, own)),
                ("iterations_differing", float(np.sum(got[3] != truth[3])))):
            gaps[name] = max(gaps[name], value)
    return list(gaps.items())
