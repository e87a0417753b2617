"""salamander_tpu_torch's minimum-volume NMF extraction against the
benchmark's plain reference (portbench/reference/mvnmf.py, plain PyTorch
written from the algorithm) at float64 on the CPU: 96 x 300 counts planted
from the breast mix of portbench's pancancer_sbs_20k_breast, ranks 2-4 x 3
bootstraps, 200 iterations, at the package's lam and at a lam large
enough that the line search shrinks gamma. The reference draws the same
resamples and keyed starts itself. A planted fault (lam off by a tenth, a
lane's trial skipped) comes out apart. Then the program's record: the
line search's counters against a hand count, no host read added while
nothing records, and a rank scan as one call."""

import json

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from portbench import inputs
from portbench.manifest import ROOT
from portbench.reference import extraction as ref_extraction
from portbench.reference import mvnmf as ref
from salamander_tpu_torch import profiling
from salamander_tpu_torch.ops import mvnmf

torch.set_num_threads(1)

SEED = 2**31 + 91
RANKS = [2, 3, 4]
BOOTSTRAPS = 3
# min, max, every, tol: a tolerance above float32's floor, so both sides
# stop by the same rule
FIT = (100, 200, 10, 1e-5)
# at lam 2000 the volume term is a large share of the objective and the
# first trial of many searches is worse; at lam 1 none is at this size
LAMS = [1.0, 2000.0]


def cohort(n_samples=300):
    config = json.loads((ROOT / "portbench" / "configs"
                         / "pancancer_sbs_20k_breast.json").read_text())
    return inputs.planted_cohort(config, SEED, n_samples=n_samples)


def program(lam, seed=SEED):
    result = port.extract_signatures(
        cohort(), RANKS, n_bootstraps=BOOTSTRAPS, model="mvnmf", lam=lam,
        delta=1.0, seed=seed, min_iterations=FIT[0], max_iterations=FIT[1],
        conv_test_freq=FIT[2], tol=FIT[3], dtype="float64", device="cpu",
        fit_final=False)
    return {k: (np.asarray(result.replicate_losses[k]),
                np.asarray(result.replicate_iterations[k]),
                result.consensus[k].to_numpy(),
                np.asarray(result.silhouettes[k]))
            for k in RANKS}, result.suggested_rank


def reference(lam):
    """reference/mvnmf.py's extraction, its starts in float64 (the
    benchmark's run draws them in the configuration's float32)."""
    X = torch.as_tensor(np.maximum(cohort().to_numpy().T, ref.EPS32))
    V, D = X.shape
    generator = torch.Generator().manual_seed(SEED)
    X_boot = torch.clamp_min(ref_extraction.multinomial_resamples(
        X.to(torch.float32), generator, BOOTSTRAPS), ref.EPS32)
    out = {}
    for k in RANKS:
        draws = [ref_extraction.lane_draws(SEED, k, b, RANKS[-1], V, D)
                 for b in range(BOOTSTRAPS)]
        W0, H0 = ref_extraction.lane_starts(
            X_boot, torch.as_tensor(np.stack([d[0] for d in draws])),
            torch.as_tensor(np.stack([d[1] for d in draws])), k)
        W, _, losses, iterations = ref.fit_lanes(
            X_boot, W0, H0, lam, 1.0, *FIT, ref.FLOAT64)
        stack = np.transpose(W.numpy(), (0, 2, 1))
        consensus, matched = ref_extraction.consensus_cluster(
            stack, int(np.argmin(losses)))
        out[k] = (losses, iterations, consensus,
                  ref_extraction.silhouettes(matched))
    return out, ref_extraction.suggest_rank(
        RANKS, [np.min(out[k][3]) for k in RANKS])


def gaps(got, truth):
    """The worst relative lane loss gap, iterations differing, the worst
    consensus entry gap, the worst silhouette gap, rank differing."""
    (got, got_rank), (truth, truth_rank) = got, truth
    out = np.zeros(5)
    for k in RANKS:
        g, t = got[k], truth[k]
        out = np.maximum(out, [
            np.max(np.abs(g[0] - t[0]) / np.abs(t[0])),
            np.sum(g[1] != t[1]),
            np.max(np.abs(g[2] - t[2])),
            np.max(np.abs(g[3] - t[3])),
            float(got_rank != truth_rank)])
    return out


def agree(found) -> bool:
    """Lane losses to 1e-9 relative, equal iterations and rank, the
    consensus and the silhouettes to 1e-9."""
    return bool(found[0] <= 1e-9 and found[1] == 0 and found[2] <= 1e-9
                and found[3] <= 1e-9 and found[4] == 0)


@pytest.fixture(scope="module")
def truths():
    return {lam: reference(lam) for lam in LAMS}


@pytest.mark.parametrize("lam", LAMS)
def test_extraction_equals_reference(truths, lam):
    found = gaps(program(lam), truths[lam])
    assert agree(found), found


def _lam_off(monkeypatch):
    return 1.1


def _trial_skipped(monkeypatch):
    """Lane 0 of the batch takes its first searched trial's predecessor:
    its search stops a round early once."""
    real = mvnmf._serial_search
    state = {"done": False}

    def skipping(W, W_unconstrained, gamma, prev_objective, renormalize):
        if state["done"]:
            return real(W, W_unconstrained, gamma, prev_objective,
                        renormalize)

        def once(W_trial):
            W_new, H_new, value = renormalize(W_trial)
            if bool(value[0] > prev_objective[0]) and not state["done"]:
                state["done"] = True
                value = value.clone()
                value[0] = prev_objective[0]
            return W_new, H_new, value
        return real(W, W_unconstrained, gamma, prev_objective, once)

    monkeypatch.setattr(mvnmf, "_serial_search", skipping)
    return 2000.0


@pytest.mark.parametrize("plant", [_lam_off, _trial_skipped],
                         ids=lambda p: p.__name__[1:])
def test_planted_fault_comes_out_apart(truths, monkeypatch, plant):
    lam = plant(monkeypatch)
    found = gaps(program(lam), truths[2000.0 if lam == 2000.0 else 1.0])
    assert not agree(found), found


# --- the program's record -------------------------------------------------


LAM = 1.0


def search_case():
    """Four lanes of fitted factors (30 MvNMF iterations from random ones)
    and a step toward random signatures, worse than where the lanes are:
    each search shrinks gamma over rounds; lane 1 starts at the floor."""
    gen = torch.Generator().manual_seed(3)
    X = torch.poisson(torch.rand((12, 30), generator=gen,
                                 dtype=torch.float64) * 40) + 1
    W = torch.rand((4, 12, 3), generator=gen, dtype=torch.float64)
    W = W / W.sum(-2, keepdim=True)
    H = torch.rand((4, 3, 30), generator=gen, dtype=torch.float64) * 50
    gamma = torch.ones(4, dtype=torch.float64)
    for _ in range(30):
        H = port.ops.klnmf.update_H(X, W, H)
        W_unc = mvnmf.update_W_unconstrained(X, W, H, LAM, 1.0)
        W, H, gamma = mvnmf.line_search(X, W, H, LAM, 1.0, gamma, W_unc)
    W_unc = torch.rand((4, 12, 3), generator=gen, dtype=torch.float64)
    gamma = torch.ones(4, dtype=torch.float64)
    gamma[1] = 1e-17
    return X, W, H, gamma, W_unc


def hand_count(X, W, H, gamma, W_unc):
    """The search redone by hand: (searches, trials, rounds, floor
    stops)."""
    start = mvnmf.kl_divergence_penalized(X, W, H, LAM, 1.0)
    _, _, value = mvnmf._renormalized_objective(X, W_unc, H, LAM, 1.0)
    g = gamma.clone()
    searching = (value > start) & (g > mvnmf.GAMMA_FLOOR)
    trials, rounds = W.shape[0], 1
    stops = int(((value > start) & ~searching).sum())
    while bool(searching.any()):
        trials += int(searching.sum())
        rounds += 1
        g = torch.where(searching, g * 0.8, g)
        gl = g.reshape(-1, 1, 1)
        _, _, v = mvnmf._renormalized_objective(
            X, (1 - gl) * W + gl * W_unc, H, LAM, 1.0)
        value = torch.where(searching, v, value)
        was = searching
        searching = (value > start) & (g > mvnmf.GAMMA_FLOOR)
        stops += int((was & ~searching & (value > start)).sum())
    return W.shape[0], trials, rounds, stops


def test_counters_equal_a_hand_count():
    X, W, H, gamma, W_unc = search_case()
    before = dict(profiling.counters)
    with profiling.recording():
        mvnmf.line_search(X, W, H, LAM, 1.0, gamma, W_unc)
    counts = {name: profiling.counters.get(name, 0) - before.get(name, 0)
              for name in ("mvnmf.searches", "mvnmf.lane_trials",
                           "mvnmf.search_rounds", "mvnmf.floor_stops",
                           "ops.host_syncs")}
    searches, trials, rounds, stops = hand_count(X, W, H, gamma, W_unc)
    # lane 1 stops at the floor at once; a lane whose trials come within
    # rounding of its start may run to the floor too
    assert rounds > 2 and stops >= 1
    assert counts == {"mvnmf.searches": searches,
                      "mvnmf.lane_trials": trials,
                      "mvnmf.search_rounds": rounds,
                      "mvnmf.floor_stops": stops,
                      "ops.host_syncs": rounds}


def test_search_makes_no_host_read_beyond_its_rounds(monkeypatch):
    """While nothing records each round reads one number (as the search
    always read one flag a round) and the floor stops are not computed."""
    X, W, H, gamma, W_unc = search_case()
    reads = []
    real_int, real_tolist = torch.Tensor.__int__, torch.Tensor.tolist

    def int_read(self):
        reads.append("int")
        return real_int(self)

    def list_read(self):
        reads.append("list")
        return real_tolist(self)

    before = profiling.counters.get("mvnmf.floor_stops", 0)
    monkeypatch.setattr(torch.Tensor, "__int__", int_read)
    monkeypatch.setattr(torch.Tensor, "tolist", list_read)
    mvnmf.line_search(X, W, H, LAM, 1.0, gamma, W_unc)
    monkeypatch.undo()
    _, _, rounds, _ = hand_count(X, W, H, gamma, W_unc)
    assert reads == ["int"] * rounds
    assert profiling.counters.get("mvnmf.floor_stops", 0) == before


@pytest.mark.parametrize("scan", ["klnmf", "mvnmf"])
def test_rank_scan_is_one_call(scan):
    X = torch.as_tensor(cohort(40).to_numpy().T.copy())
    config = port.FitConfig(20, 20, 10, 1e-7)
    run = port.rank_scan_klnmf if scan == "klnmf" else port.rank_scan_mvnmf
    with profiling.recording():
        run(X, [2, 3], 2, seed=4, config=config, dtype=torch.float64,
            device="cpu")
    (call,) = profiling.calls(1)
    assert call["name"] == "restarts.rank_scan"
    names = [span[0] for span in call["spans"]]
    if scan == "klnmf":
        assert names.count("restarts.fit") == 2
    else:
        assert names.count("mvnmf.line_search") > 0
    assert {span[4] for span in call["spans"]} == {call["id"]}


def test_float32_trial_is_judged_by_its_change_where_whole_objectives_tie():
    """At a cohort's 20,000 samples the penalized KL is about 9e5, whose
    float32 spacing is 0.0625: trials 0.01-0.1 worse than the start in
    float64 tie with it as whole float32 objectives, and so would be
    accepted. The port's float32 search judges each trial by its change
    summed term by term, and rejects every trial float64 rejects (each
    ends at the floor here, its gamma at the floor already)."""
    config = json.loads((ROOT / "portbench" / "configs"
                         / "pancancer_sbs_20k_breast.json").read_text())
    X = torch.as_tensor(inputs.planted_cohort(config, 7).to_numpy().T.copy())
    catalog = inputs.catalog(config)
    W = torch.as_tensor(catalog.loc[config["cohort"]["planted"]]
                        .to_numpy().T.copy())
    gen = torch.Generator().manual_seed(0)
    W = W * (1 + 0.05 * torch.rand(W.shape, generator=gen,
                                   dtype=torch.float64))
    W = W / W.sum(0)
    H = torch.full((5, X.shape[1]), 400.0, dtype=torch.float64)
    for _ in range(30):
        H = port.ops.klnmf.update_H(X, W, H)
    W_step = mvnmf.update_W_unconstrained(X, W, H, LAM, 1.0)
    X32, H32 = X.float(), H.float()
    W32 = W.float() / W.float().sum(0)
    # steps against the W step, across the change's zero in float64
    g = -torch.linspace(5e-5, 9e-5, 12, dtype=torch.float64)[:, None, None]
    trials = ((1 - g) * W32.double() + g * W_step).float()
    lanes = (X32, W32.expand(12, -1, -1), H32.expand(12, -1, -1))

    start, threshold = mvnmf._search_start(*lanes, LAM, 1.0, None, None,
                                           None, None)
    W_t, H_t, change = mvnmf._renormalized_objective(
        X32, trials, lanes[2], LAM, 1.0, None, start)
    whole = mvnmf._renormalized_objective(X32, trials, lanes[2], LAM, 1.0)[2]
    whole_start = mvnmf.kl_divergence_penalized(X32, W32, H32, LAM, 1.0)
    worse64 = (mvnmf.kl_divergence_penalized(X, W_t.double(), H_t.double(),
                                             LAM, 1.0)
               > mvnmf.kl_divergence_penalized(X, W32.double(),
                                               H32.double(), LAM, 1.0))
    assert torch.equal(change > threshold, worse64)
    tied = (whole == whole_start) & worse64
    assert bool(tied.any()), (whole - whole_start, worse64)

    before = profiling.counters.get("mvnmf.floor_stops", 0)
    with profiling.recording():
        mvnmf.line_search(*lanes, LAM, 1.0, torch.full((12,), 1e-17), trials)
    assert (profiling.counters["mvnmf.floor_stops"] - before
            == int(worse64.sum()))
