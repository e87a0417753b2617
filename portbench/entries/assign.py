"""Sparse catalog assignment: ``assign_signatures(batch, catalog,
rel_tol)``, one call a job on a fresh batch of the planted cohort drawn
from the job's seed (a lab fitting each new sequencing batch to COSMIC).
The batch is drawn on the host inside the job, before the call."""

from __future__ import annotations

import time

import numpy as np

from .. import inputs
from ..reference import assign as ref
from ..reference.klnmf import FLOAT64
from . import counted, rel_gap, sampled


def prepare(config: dict, traffic: dict, seed: int, device) -> dict:
    catalog = inputs.catalog(config)
    return {"config": config, "catalog": catalog, "device": device,
            "rel_tol": float(traffic["rel_tol"]), "traffic": traffic,
            "W": ref.catalog_matrix(catalog, catalog.columns)}


def _assign(state, batch, rel_tol):
    from salamander_tpu_torch import assign_signatures

    result = assign_signatures(batch, state["catalog"], rel_tol=rel_tol,
                               dtype="float32", device=state["device"])
    return {"H": result.exposures.to_numpy().T,
            "mask": result.active.to_numpy().T,
            "kl_dense": result.kl_dense.to_numpy(),
            "kl_sparse": result.kl_sparse.to_numpy(),
            "n_rounds": int(result.meta["n_rounds"])}


def warm(state) -> None:
    """A whole batch through one round (rel_tol=-1 makes every budget
    zero, so no removal is accepted) and a short dense refit: the call's
    shapes and kernels."""
    from salamander_tpu_torch import assign_signatures

    batch = inputs.planted_cohort(state["config"], 0)
    assign_signatures(batch, state["catalog"], rel_tol=-1.0,
                      max_iterations=100, dtype="float32",
                      device=state["device"])


def job(state, seed: int) -> dict:
    batch = inputs.planted_cohort(state["config"], seed)
    start = time.perf_counter()
    output, counters = counted(lambda: _assign(state, batch,
                                               state["rel_tol"]))
    call_s = time.perf_counter() - start
    return {
        "work": {"samples": len(batch), "n_rounds": output["n_rounds"],
                 "call_s": call_s},
        "counters": counters,
        "output": output,
    }


def check(state, records, seed: int, arith=FLOAT64, program=True):
    """The worst over the sampled calls of: each sample's dense KL against
    the reference's (relative); on the samples whose support equals the
    reference's, each sample's sparse KL against the reference's
    (relative) and its exposures against the reference's (relative L1);
    the share of samples whose support differs; each sample's reported
    sparse KL against the KL of its reported exposures (relative); the
    reported sparse KL over the reported budget (kl_sparse - (1 + rel_tol)
    kl_dense, as a share of kl_dense: the port states the budget exact);
    and the reported sparse KL over the float64 reference's budget, as a
    share of the reference's kl_dense. With program=False the reference in
    `arith` stands in for the program (the control)."""
    import torch

    gaps = {"kl_dense_gap": 0.0, "kl_sparse_gap": 0.0, "exposure_gap": 0.0,
            "support_differs": 0.0, "reported_kl_gap": 0.0,
            "budget_excess_reported": -np.inf,
            "f64_budget_excess": -np.inf}
    for record in sampled(records, seed, int(state["traffic"]["check_jobs"])):
        X = inputs.planted_cohort(state["config"], record["seed"]).to_numpy().T
        truth = ref.eliminate(X, state["W"], state["rel_tol"], FLOAT64,
                              device=state["device"])
        got = record["output"] if program else ref.eliminate(
            X, state["W"], state["rel_tol"], arith, device=state["device"])
        X64 = torch.as_tensor(X, dtype=torch.float64, device=state["device"])
        W64 = torch.as_tensor(state["W"], dtype=torch.float64,
                              device=state["device"])
        H = np.asarray(got["H"], np.float64)
        kl_got = ref.sample_kl(X64, W64, torch.as_tensor(
            H, device=state["device"]), FLOAT64).cpu().numpy()
        kl_dense = np.asarray(got["kl_dense"], np.float64)
        kl_sparse = np.asarray(got["kl_sparse"], np.float64)
        slack = 1.0 + state["rel_tol"]
        same = np.all(np.asarray(got["mask"], bool) == truth["mask"], axis=0)
        for name, value in (
                ("kl_dense_gap", rel_gap(kl_dense, truth["kl_dense"])),
                ("kl_sparse_gap", rel_gap(kl_sparse[same],
                                          truth["kl_sparse"][same])),
                ("exposure_gap", float(np.max(
                    np.abs(H[:, same] - truth["H"][:, same]).sum(0)
                    / np.abs(truth["H"][:, same]).sum(0)))),
                ("support_differs", float(np.mean(~same))),
                ("reported_kl_gap", rel_gap(kl_sparse, kl_got)),
                ("budget_excess_reported", float(np.max(
                    (kl_sparse - slack * kl_dense) / np.abs(kl_dense)))),
                ("f64_budget_excess", float(np.max(
                    (kl_sparse - slack * truth["kl_dense"])
                    / np.abs(truth["kl_dense"]))))):
            gaps[name] = max(gaps[name], value)
    return list(gaps.items())
