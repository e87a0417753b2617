"""Whole runs of the harness at the tiny size on the CPU (the look for a
card skipped): the result's form, a cell and a metric added as files
alone, and the faults a cell can have coming out as not correct."""

import json

import numpy as np
import pytest

from portbench import run

SEED = 2**31 + 12345  # the driver's seeds pass 32 signed bits
CELLS = ["pcawg_sbs-restarts100", "pcawg_sbs-extract",
         "pancancer_sbs_20k-extract", "pancancer_sbs_20k-assign"]


def run_tiny(root, cell, trace=False, seconds=0.5):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu", root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_result_form(tiny_root, cell):
    result = run_tiny(tiny_root, cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    for item in result["check"].values():
        assert item["value"] <= item["limit"]
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(tiny_root):
    result = run_tiny(tiny_root, "pcawg_sbs-extract", trace=True)
    assert "lane_its_per_job.pcawg_extract" in result["metrics"]
    assert "setup_s" not in result["metrics"]
    # a CPU run has no device trace: the device shares stay out
    assert "mu_kernel_roofline.pcawg_extract" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_cell_and_metric_added_as_files(tiny_root):
    book = json.loads((tiny_root / "BENCHMARK.json").read_text())
    traffic = json.loads((tiny_root / "portbench" / "traffic"
                          / "restarts100.json").read_text())
    traffic["n_signatures"] = 3
    (tiny_root / "portbench" / "traffic" / "restarts_k3.json").write_text(
        json.dumps(traffic))
    (tiny_root / "portbench" / "limits" / "pcawg_sbs-restarts_k3.json"
     ).write_text((tiny_root / "portbench" / "limits"
                   / "pcawg_sbs-restarts100.json").read_text())
    (tiny_root / "portbench" / "metrics" / "lane_its_per_fit.k3.py"
     ).write_text("def read(ctx):\n"
                  "    jobs = ctx['jobs']\n"
                  "    return sum(j['work']['lane_iterations'] for j in jobs)"
                  " / len(jobs)\n")
    book["workloads"].append({"name": "pcawg_sbs-restarts_k3",
                              "config": "pcawg_sbs", "traffic": "restarts_k3",
                              "chips": 1, "why": "k=3"})
    for metric in book["end_to_end"]:
        if metric["name"] == "lane_its_per_s":
            metric["workloads"].append("pcawg_sbs-restarts_k3")
    book["per_layer"].append({
        "name": "lane_its_per_fit.k3", "unit": "its", "better": "lower",
        "source": "program_counter", "layer": "drivers",
        "moves": "lane_its_per_s", "workloads": ["pcawg_sbs-restarts_k3"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(book))
    result = run_tiny(tiny_root, "pcawg_sbs-restarts_k3", trace=True)
    assert result["correct"] is True, result["check"]
    assert result["metrics"]["lane_its_per_fit.k3"]["value"] == 4 * 50
    plain = run_tiny(tiny_root, "pcawg_sbs-restarts_k3")
    assert "lane_its_per_s" in plain["metrics"]


# --- the faults each cell can have, planted under the timed path ---------

def _unchanged_klnmf_step(monkeypatch):
    from salamander_tpu_torch.ops import klnmf

    monkeypatch.setattr(klnmf, "update_WH",
                        lambda X, W, H, *args, **kwargs: (W, H))


def _unchanged_lane_block(monkeypatch):
    from salamander_tpu_torch.parallel import compaction

    monkeypatch.setattr(compaction, "plain_block_builder",
                        lambda update_fn: lambda params, data:
                        lambda p, n_steps: p)


def _unchanged_exposure_step(monkeypatch):
    from salamander_tpu_torch.ops import assign

    monkeypatch.setattr(assign, "_masked_mu_step", lambda X, W, H, mask: H)


def _wrap(monkeypatch, name, change):
    import salamander_tpu_torch as sal

    real = getattr(sal, name)
    monkeypatch.setattr(sal, name,
                        lambda *args, **kwargs: change(real, args, kwargs))


def _altered_loss(monkeypatch):
    def change(real, args, kwargs):
        result = real(*args, **kwargs)
        result.losses[0] *= 1.001
        return result
    _wrap(monkeypatch, "fit_klnmf_restarts", change)


def _half_the_lanes(monkeypatch):
    import torch

    def change(real, args, kwargs):
        X, K, R = args[:3]
        half = real(X, K, R // 2, *args[3:], **kwargs)
        return half._replace(W=torch.cat([half.W, half.W]),
                             H=torch.cat([half.H, half.H]),
                             losses=np.concatenate([half.losses] * 2),
                             n_iterations=np.concatenate(
                                 [half.n_iterations] * 2))
    _wrap(monkeypatch, "fit_klnmf_restarts", change)


def _a_quarter_of_the_lanes_from_another_start(monkeypatch):
    import torch

    def change(real, args, kwargs):
        result = real(*args, **kwargs)
        other = real(*args, **dict(kwargs, seed=kwargs["seed"] + 1))
        n = max(1, len(result.losses) // 4)
        losses = np.array(result.losses)
        losses[:n] = other.losses[:n]
        return result._replace(
            W=torch.cat([other.W[:n], result.W[n:]]),
            H=torch.cat([other.H[:n], result.H[n:]]), losses=losses)
    _wrap(monkeypatch, "fit_klnmf_restarts", change)


def _altered_consensus(monkeypatch):
    def change(real, args, kwargs):
        result = real(*args, **kwargs)
        frame = result.consensus[2]
        frame.iloc[0] = np.roll(frame.iloc[0].to_numpy(), 1)
        return result
    _wrap(monkeypatch, "extract_signatures", change)


def _altered_kl(monkeypatch):
    def change(real, args, kwargs):
        result = real(*args, **kwargs)
        result.kl_sparse.iloc[0] *= 1.01
        return result
    _wrap(monkeypatch, "assign_signatures", change)


FAULTS = [
    ("pcawg_sbs-restarts100", _unchanged_klnmf_step),
    ("pcawg_sbs-restarts100", _altered_loss),
    ("pcawg_sbs-restarts100", _half_the_lanes),
    ("pcawg_sbs-restarts100", _a_quarter_of_the_lanes_from_another_start),
    ("pcawg_sbs-extract", _unchanged_lane_block),
    ("pcawg_sbs-extract", _altered_consensus),
    ("pancancer_sbs_20k-extract", _unchanged_lane_block),
    ("pancancer_sbs_20k-assign", _unchanged_exposure_step),
    ("pancancer_sbs_20k-assign", _altered_kl),
]


@pytest.mark.parametrize("cell,plant", FAULTS,
                         ids=[f"{c}-{p.__name__[1:]}" for c, p in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, plant):
    plant(monkeypatch)
    result = run_tiny(tiny_root, cell, seconds=0.01)
    assert result["correct"] is False, result["check"]


@pytest.mark.cuda
def test_card_run_names_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run.run_cell(CELLS[0], SEED, 1.0, True, device="cuda",
                          root=tiny_root)
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert result["device"]["busy_s"] > 0
    assert result["correct"] is True, result["check"]
