"""The multimodal best-of cell and the converging restarts cell at a tiny
size on the CPU: whole runs, the traced run's new counters, the cohort
generator, the faults the multimodal job can have coming out as not
correct, the control outside a limit, and the reference's own ascent."""

import json

import numpy as np
import pytest
import torch

from portbench import calibrate, mm_inputs, run
from portbench.reference import mmcorrnmf as ref

SEED = 2**31 + 4242  # a run's seed may pass 32 signed bits
MM = "pancancer_sbs_id_20k-mm_best_of8"
CONVERGE = "pcawg_sbs-restarts100-converge"
N_SAMPLES = 60
TRAFFIC = {
    "mm_best_of8": {"n_restarts": 3, "fit_config": [20, 20, 10, 1e-7],
                    "warm_config": [10, 10, 10, 1e-7]},
    "restarts100_converge": {"n_restarts": 4,
                             "fit_config": [30, 400, 10, 1e-5],
                             "warm_config": [20, 20, 10, 1e-7],
                             "check_jobs": 2, "profiled_jobs": 1},
}


@pytest.fixture
def mm_root(tiny_root):
    """The tiny copy with the new cells shrunk too: 60 samples, 3 lanes
    of 20 cycles; 4 converging restarts."""
    for name, changes in TRAFFIC.items():
        path = tiny_root / "portbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(changes)
        path.write_text(json.dumps(traffic))
    path = tiny_root / "portbench" / "configs" / "pancancer_sbs_id_20k.json"
    config = json.loads(path.read_text())
    config["cohort"]["n_samples"] = N_SAMPLES
    path.write_text(json.dumps(config))
    return tiny_root


def run_tiny(root, cell, trace=False, seconds=0.01):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu", root=root)


@pytest.mark.parametrize("cell", [MM, CONVERGE])
def test_cell_runs_correct(mm_root, cell):
    result = run_tiny(mm_root, cell)
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0
    assert {"setup_s", "lane_its_per_s"} <= set(result["metrics"])


def test_traced_run_reads_the_new_counters(mm_root):
    result = run_tiny(mm_root, MM, trace=True)
    metrics = result["metrics"]
    # two modalities' signature solves and 3 sample steps a cycle at least
    assert metrics["newton_steps_per_cycle.mm_cohort"]["value"] >= 5
    assert metrics["host_syncs_per_job.mm_cohort"]["value"] > 0
    # a CPU run has no device trace
    assert "em_work_roofline.mm_cohort" not in metrics


def test_cohort_is_reproducible_and_shaped(mm_root):
    config = json.loads((mm_root / "portbench" / "configs"
                         / "pancancer_sbs_id_20k.json").read_text())
    a = mm_inputs.cohort(config, SEED, mm_root)
    b = mm_inputs.cohort(config, SEED, mm_root)
    c = mm_inputs.cohort(config, SEED + 1, mm_root)
    assert list(a) == ["sbs", "indel"]
    assert a["sbs"].shape == (N_SAMPLES, 96)
    assert a["indel"].shape == (N_SAMPLES, 83)
    for name in a:
        assert np.array_equal(a[name].to_numpy(), b[name].to_numpy())
        assert not np.array_equal(a[name].to_numpy(), c[name].to_numpy())
        assert a[name].to_numpy().min() >= 1.0
    assert a["sbs"].to_numpy().sum() > 5 * a["indel"].to_numpy().sum()


# --- faults planted under the timed path of the multimodal job ----------

def _skipped_sample_newton_step(monkeypatch):
    from salamander_tpu_torch.ops import corrnmf

    real = corrnmf.update_embeddings

    def fewer(*args, **kwargs):
        if kwargs.get("max_iter") == 3:
            kwargs["max_iter"] = 2
        return real(*args, **kwargs)
    monkeypatch.setattr(corrnmf, "update_embeddings", fewer)


def _signatures_not_renormalized(monkeypatch):
    from salamander_tpu_torch.ops import klnmf

    monkeypatch.setattr(
        klnmf, "update_W_from_numerator",
        lambda W, numerator, n_given=0: torch.clamp_min(W * numerator,
                                                        klnmf.EPSILON))


def _wrong_variance(monkeypatch):
    from salamander_tpu_torch.ops import corrnmf

    real = corrnmf.variance_from
    monkeypatch.setattr(corrnmf, "variance_from",
                        lambda *args: real(*args) * 1.01)


FAULTS = [_skipped_sample_newton_step, _signatures_not_renormalized,
          _wrong_variance]


@pytest.mark.parametrize("plant", FAULTS, ids=lambda p: p.__name__[1:])
def test_fault_is_not_correct(mm_root, monkeypatch, plant):
    plant(monkeypatch)
    result = run_tiny(mm_root, MM)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("cell", [MM, CONVERGE])
def test_control_fails_a_limit(mm_root, cell):
    limits = json.loads((mm_root / "portbench" / "limits"
                         / f"{cell}.json").read_text())["limits"]
    rows = calibrate.readings(cell, [SEED], [SEED + 1], device="cpu",
                              root=mm_root)
    program, control = rows[0]["numbers"], rows[1]["numbers"]
    assert all(program[name] <= limits[name] for name in limits), program
    assert any(control[name] > limits[name] for name in limits), control


def test_reference_ascends_and_stays_finite():
    gen = torch.Generator().manual_seed(3)
    Xs = {"a": torch.poisson(torch.rand((40, 12), generator=gen,
                                        dtype=torch.float64) * 30) + 1,
          "b": torch.poisson(torch.rand((40, 9), generator=gen,
                                        dtype=torch.float64) * 5) + 1}
    params0 = ref.restart_init(Xs, [3, 2], 3, 2, 7, torch.float64)
    start = ref.elbo(Xs, params0)
    params, losses, iterations = ref.fit_lanes(Xs, params0, 30, 30, 10,
                                               1e-7)
    assert np.all(losses > start.numpy())
    assert list(iterations) == [30, 30]
    for mod in params["mods"].values():
        assert torch.allclose(mod["signatures"].sum(-1),
                              torch.ones(2, mod["signatures"].shape[1],
                                         dtype=torch.float64))
