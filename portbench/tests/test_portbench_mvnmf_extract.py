"""The MvNMF extraction cell and the rank-scan cell at a tiny size on the
CPU: whole runs, the traced run's new metrics, the faults each job can
have coming out as not correct, the control outside a limit, the MvNMF
reference's own descent, and the MvNMF bound charging each lane at its
own rank for its own iterations only."""

import json

import numpy as np
import pytest
import torch

from portbench import calibrate, roofline_mvnmf, run
from portbench.reference import mvnmf as ref

SEED = 2**31 + 5151  # a run's seed may pass 32 signed bits
MV = "pancancer_sbs_20k_breast-mvnmf_extract"
SCAN = "pancancer_sbs_20k-rank_scan"
TRAFFIC = {
    "mvnmf_extract_b10": {"ranks": [2, 3], "n_bootstraps": 3,
                          "fit_config": [20, 60, 10, 1e-7],
                          "warm_config": [10, 20, 10, 1e-7]},
    "rank_scan20": {"ranks": [2, 3, 4], "n_restarts": 3,
                    "fit_config": [20, 60, 10, 1e-7],
                    "warm_config": [10, 20, 10, 1e-7], "check_ranks": 2},
}
N_SAMPLES = 100
# 3 lanes of 60 steps on 100 samples: no sound lane is apart there, and
# the program's median lane lies ~3e-8 from float64's, the control's ~4e-6
# and a volume term off by a tenth ~2e-6: the card's limit of 5e-6 is
# lowered to 5e-7 here
LIMITS = {SCAN: {"lanes_apart_loss": 0.0, "lanes_apart_factors": 0.0},
          MV: {"median_lane_loss_gap": 5e-7}}


@pytest.fixture
def mv_root(tiny_root):
    """The tiny copy with the new cells shrunk too."""
    for name, changes in TRAFFIC.items():
        path = tiny_root / "portbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(changes)
        path.write_text(json.dumps(traffic))
    for cell, changes in LIMITS.items():
        path = tiny_root / "portbench" / "limits" / f"{cell}.json"
        limits = json.loads(path.read_text())
        limits["limits"].update(changes)
        path.write_text(json.dumps(limits))
    path = (tiny_root / "portbench" / "configs"
            / "pancancer_sbs_20k_breast.json")
    config = json.loads(path.read_text())
    config["cohort"]["n_samples"] = N_SAMPLES
    path.write_text(json.dumps(config))
    return tiny_root


def run_tiny(root, cell, trace=False, seconds=0.01):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu", root=root)


@pytest.mark.parametrize("cell", [MV, SCAN])
def test_cell_runs_correct(mv_root, cell):
    result = run_tiny(mv_root, cell)
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0
    e2e = "extraction_s.cohort" if cell == MV else "lane_its_per_s"
    assert {"setup_s", e2e} <= set(result["metrics"])


def test_traced_mvnmf_run_reads_the_new_metrics(mv_root):
    metrics = run_tiny(mv_root, MV, trace=True)["metrics"]
    assert metrics["trials_per_iteration.mvnmf_extract"]["value"] >= 1.0
    assert 0.0 <= metrics["floor_stop_share.mvnmf_extract"]["value"] <= 100
    assert 0.0 < metrics["line_search_share.mvnmf_extract"]["value"] < 100
    assert metrics["host_syncs_per_job.mvnmf_extract"]["value"] > 0
    assert "frozen_lane_share.mvnmf_extract" in metrics
    # a CPU run has no device trace
    assert "mv_work_roofline.mvnmf_extract" not in metrics


def test_traced_scan_is_one_call(mv_root):
    metrics = run_tiny(mv_root, SCAN, trace=True)["metrics"]
    # the record's calls are found only where a scan is one call
    assert "frozen_lane_share.rank_scan" in metrics
    assert "kernel_objective_share.rank_scan" in metrics
    assert "mu_kernel_roofline.rank_scan" not in metrics


# --- faults planted under the timed path --------------------------------

def _volume_term_off_by_a_tenth(monkeypatch):
    from salamander_tpu_torch.ops import mvnmf

    real = mvnmf.make_masked_step_functions
    monkeypatch.setattr(
        mvnmf, "make_masked_step_functions",
        lambda lam, delta, *args, **kwargs: real(lam * 1.1, delta, *args,
                                                 **kwargs))


def _trial_not_renormalized(monkeypatch):
    from salamander_tpu_torch.ops import mvnmf

    monkeypatch.setattr(mvnmf, "normalize_wh", lambda W, H: (W, H))


def _altered_mvnmf_loss(monkeypatch):
    import salamander_tpu_torch as sal

    real = sal.extract_signatures

    def change(*args, **kwargs):
        result = real(*args, **kwargs)
        result.replicate_losses[2][0] *= 1.001
        return result
    monkeypatch.setattr(sal, "extract_signatures", change)


def _unchanged_klnmf_step(monkeypatch):
    from salamander_tpu_torch.ops import klnmf

    monkeypatch.setattr(klnmf, "update_WH",
                        lambda X, W, H, *args, **kwargs: (W, H))


def _scan_rank_from_another_seed(monkeypatch):
    import salamander_tpu_torch as sal

    real = sal.rank_scan_klnmf

    def change(X, ranks, R, seed=0, **kwargs):
        result = real(X, ranks, R, seed=seed, **kwargs)
        k = list(result)[-1]
        result[k] = real(X, [k], R, seed=seed + 1, **kwargs)[k]
        return result
    monkeypatch.setattr(sal, "rank_scan_klnmf", change)


FAULTS = [(MV, _volume_term_off_by_a_tenth), (MV, _trial_not_renormalized),
          (MV, _altered_mvnmf_loss), (SCAN, _unchanged_klnmf_step),
          (SCAN, _scan_rank_from_another_seed)]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f"{c}-{p.__name__[1:]}" for c, p in FAULTS])
def test_fault_is_not_correct(mv_root, monkeypatch, cell, plant):
    plant(monkeypatch)
    result = run_tiny(mv_root, cell)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("cell", [MV, SCAN])
def test_control_fails_a_limit(mv_root, cell):
    limits = json.loads((mv_root / "portbench" / "limits"
                         / f"{cell}.json").read_text())["limits"]
    rows = calibrate.readings(cell, [SEED], [SEED + 1], device="cpu",
                              root=mv_root)
    program, control = rows[0]["numbers"], rows[1]["numbers"]
    assert all(program[name] <= limits[name] for name in limits), program
    assert any(control[name] > limits[name] for name in limits), control


# --- the reference and the bound ----------------------------------------

def test_reference_descends_and_stays_on_the_simplex():
    gen = torch.Generator().manual_seed(9)
    X = torch.poisson(torch.rand((3, 20, 40), generator=gen,
                                 dtype=torch.float64) * 30) + 1
    W = torch.rand((3, 20, 4), generator=gen, dtype=torch.float64)
    W = W / W.sum(-2, keepdim=True)
    H = torch.rand((3, 4, 40), generator=gen, dtype=torch.float64) * 20
    start = ref.objective(X, W, H, 1.0, 1.0, ref.FLOAT64)
    W_fit, _, losses, iterations = ref.fit_lanes(X, W, H, 1.0, 1.0, 30, 30,
                                                 10, 1e-7, ref.FLOAT64)
    assert np.all(losses < start.numpy())
    assert list(iterations) == [30, 30, 30]
    assert torch.allclose(W_fit.sum(-2), torch.ones(3, 4,
                                                    dtype=torch.float64))


def test_bound_charges_each_lane_its_own_rank_and_iterations(mv_root):
    V, D = 96, 20000
    lanes = [(2, 500), (10, 3000), (6, 1200)]
    total = roofline_mvnmf.lanes_bound_s(V, D, lanes)
    assert total == pytest.approx(sum(
        roofline_mvnmf.lane_bound_s(V, D, k, it, it) for k, it in lanes))
    # a padded batch's width would charge the rank-2 lane at rank 10
    assert roofline_mvnmf.lane_bound_s(V, D, 2, 500, 500) < \
        roofline_mvnmf.lane_bound_s(V, D, 10, 500, 500)
    # a microsecond or a few a lane iteration at these shapes
    assert 1e-7 < roofline_mvnmf.lane_bound_s(V, D, 6, 1, 1) < 1e-5
    # a job record's bound is of its lanes' own ranks and iterations
    from portbench import manifest

    book = manifest.load(mv_root)
    cell = manifest.cell(book, MV)
    traffic = manifest.traffic(cell, mv_root)
    kind = manifest.job_kind(traffic["entry"])
    state = kind.prepare(manifest.config(book, cell, mv_root), traffic,
                         SEED, torch.device("cpu"))
    record = kind.job(state, SEED)
    own = [(k, it) for k in traffic["ranks"]
           for it in record["output"]["ranks"][k]["iterations"]]
    assert record["work"]["bound_s"] == pytest.approx(
        roofline_mvnmf.lanes_bound_s(96, N_SAMPLES, own))
