"""Best-of-R multimodal CorrNMF: ``fit_best_of(MultimodalCorrNMF(...),
MuData(...), n_restarts=R, base_seed=job_seed)``, one call a job, every
job's starts drawn from its own seed on the device."""

from __future__ import annotations

import numpy as np

from .. import mm_inputs
from ..reference import mmcorrnmf as ref
from ..roofline_corrnmf import cycles_bound_s
from . import counted, rel_gap, sampled

# the program's counters (salamander_tpu_torch.profiling.counters) a job
# reads: a program without them reads 0, and a job then has no bound
COUNTERS = ("mmcorrnmf.cycles", "corrnmf.newton_steps.signature",
            "corrnmf.newton_steps.sample")


def prepare(config: dict, traffic: dict, seed: int, device) -> dict:
    counts = mm_inputs.cohort(config, seed)
    return {
        "X": {name: frame.to_numpy(copy=True)
              for name, frame in counts.items()},
        "device": device,
        "ns": [int(k) for k in config["ns_signatures"]],
        "dim": int(config["dim_embeddings"]),
        "dtype": config["dtype"],
        "R": int(traffic["n_restarts"]),
        "traffic": traffic,
    }


def _program_counts() -> dict:
    from salamander_tpu_torch import profiling

    found = getattr(profiling, "counters", {})
    return {name: found.get(name, 0) for name in COUNTERS}


def _fit(state, seed: int, fit_config):
    import torch

    from salamander_tpu_torch import (
        AnnData,
        MuData,
        MultimodalCorrNMF,
        fit_best_of,
    )

    min_it, max_it, freq, tol = fit_config
    model = MultimodalCorrNMF(
        ns_signatures=state["ns"], init_method="random",
        min_iterations=min_it, max_iterations=max_it, conv_test_freq=freq,
        tol=tol, dtype=state["dtype"], device=state["device"])
    mdata = MuData({name: AnnData(X.copy()) for name, X in state["X"].items()})
    before = _program_counts()
    summary = fit_best_of(model, mdata, n_restarts=state["R"],
                          base_seed=seed)
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.synchronize(state["device"])
    after = _program_counts()
    best = {
        "mods": {name: {
            "signatures": np.asarray(model.asignatures[name].X),
            "exposures": np.asarray(model.mdata[name].obsm["exposures"]),
            "signature_embeddings": np.asarray(
                model.asignatures[name].obsm["embeddings"]),
        } for name in state["X"]},
        "sample_embeddings": np.asarray(model.mdata.obsm["embeddings"]),
        "variance": float(model.variance),
    }
    return {
        "losses": np.asarray(summary.losses, np.float64),
        "n_iterations": np.asarray(summary.n_iterations),
        "best_index": int(summary.best_index),
        "signatures": {name: np.asarray(stack).transpose(0, 2, 1)
                       for name, stack in summary.signatures.items()},
        "best": best,
    }, {name: after[name] - before[name] for name in COUNTERS}


def warm(state) -> None:
    _fit(state, 0, state["traffic"]["warm_config"])


def job(state, seed: int) -> dict:
    fit_config = state["traffic"]["fit_config"]
    (output, steps), counters = counted(lambda: _fit(state, seed,
                                                     fit_config))
    D = next(iter(state["X"].values())).shape[0]
    cycles = steps["mmcorrnmf.cycles"]
    bound = None
    if cycles:
        bound = cycles_bound_s(
            D, [X.shape[1] for X in state["X"].values()], state["ns"],
            state["dim"], state["R"], cycles,
            steps["corrnmf.newton_steps.signature"],
            steps["corrnmf.newton_steps.sample"],
            cycles // int(fit_config[2]) + 1)
    return {
        "work": {"fits": 1,
                 "lane_iterations": int(output["n_iterations"].sum()),
                 "bound_s": bound},
        "counters": counters,
        "output": output,
    }


# A lane is apart from float64 whose ELBO lies ELBO_APART (relative) or
# more from the reference's, or one of whose modalities' signatures lies
# FACTOR_APART (relative Frobenius) or more from it (PERF.md, section 2).
ELBO_APART = 1e-5
FACTOR_APART = 1e-3


def _host_tree(params, lane=None):
    def leaf(value):
        value = value if lane is None else value[lane]
        return value.detach().cpu().numpy()

    return {"mods": {name: {key: leaf(value) for key, value in mod.items()}
                     for name, mod in params["mods"].items()},
            "sample_embeddings": leaf(params["sample_embeddings"]),
            "variance": float(leaf(params["variance"]))}


def _as_output(params, losses):
    """A reference fit in the form of a job's output (the control)."""
    best = int(np.argmax(losses))
    return {"losses": np.asarray(losses, np.float64),
            "best_index": best,
            "signatures": {name: mod["signatures"].detach().cpu().numpy()
                           for name, mod in params["mods"].items()},
            "best": _host_tree(params, best)}


def check(state, records, seed: int, arith=ref.FLOAT64, program=True):
    """The worst over the sampled jobs of: the median lane's final ELBO
    against float64's from the same start, and its signatures (relative,
    the median over lanes of the worse modality's relative Frobenius
    distance), the reported ELBO against the float64 ELBO of the reported
    parameters, and the lanes apart (ELBO_APART, FACTOR_APART). The widest
    and the best lane are not compared (nor the best lane's signatures,
    sample embeddings and variance): a lane still crossing a ridge at the
    last cycle, or settling along a flat direction of the ELBO, parts from
    float64's by rounding as far as the control's, and it may be the best
    (the limits file keeps the readings). With program=False the reference
    in `arith` stands in for the program (the control)."""
    import torch

    traffic = state["traffic"]
    fit_config = tuple(traffic["fit_config"])
    device = state["device"]
    gaps = dict.fromkeys(("median_elbo_gap", "median_signature_gap",
                          "reported_elbo_gap", "lanes_apart"), 0.0)
    X64 = {name: torch.as_tensor(X, dtype=torch.float64, device=device)
           for name, X in state["X"].items()}
    init_dtype = getattr(torch, state["dtype"])
    for record in sampled(records, seed, int(traffic["check_jobs"])):
        truth, truth_losses, _, _ = ref.best_of(
            state["X"], state["ns"], state["dim"], state["R"],
            record["seed"], fit_config, ref.FLOAT64, device, init_dtype)
        if program:
            got = record["output"]
        else:
            params, losses, _, _ = ref.best_of(
                state["X"], state["ns"], state["dim"], state["R"],
                record["seed"], fit_config, arith, device, init_dtype)
            got = _as_output(params, losses)
        losses = got["losses"]
        lanes = np.abs(losses - truth_losses) / np.abs(truth_losses)
        factor = np.zeros(len(losses))
        for name, mod in truth["mods"].items():
            ref_sigs = mod["signatures"].cpu().numpy()      # (R, K, V)
            diff = np.linalg.norm(
                (np.asarray(got["signatures"][name], np.float64)
                 - ref_sigs).reshape(len(losses), -1), axis=1)
            factor = np.maximum(factor, diff / np.linalg.norm(
                ref_sigs.reshape(len(losses), -1), axis=1))
        own = ref.elbo(X64, ref.tree_map(
            lambda leaf: torch.as_tensor(np.asarray(leaf, np.float64),
                                         device=device), got["best"]))
        for name, value in (
                ("median_elbo_gap", float(np.median(lanes))),
                ("median_signature_gap", float(np.median(factor))),
                ("reported_elbo_gap",
                 rel_gap(losses[got["best_index"]], float(own))),
                ("lanes_apart", float(np.sum((lanes >= ELBO_APART)
                                             | (factor >= FACTOR_APART))))):
            gaps[name] = max(gaps[name], value)
    return list(gaps.items())
