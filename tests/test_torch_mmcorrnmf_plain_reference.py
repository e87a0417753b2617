"""salamander_tpu_torch's MultimodalCorrNMF against the benchmark's plain
reference (portbench/reference/mmcorrnmf.py, plain PyTorch written from
the stated algorithm) at float64 on the CPU, {96, 83} x 64, ns [3, 2],
m = 3, two lanes from seeded random parameters: the starts fit_best_of
draws, one joint cycle leaf by leaf and its ELBO, and 20 cycles through
fit_best_of; the program's record of a fit (the Newton solves' spans and
step counters, their host reads, the cycles); and the signature-side
Newton solve in float32 at a cohort's 20,000 samples against float64."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from portbench.reference import mmcorrnmf as ref
from salamander_tpu_torch import profiling
from salamander_tpu_torch.initialization.methods import mm_corrnmf_init_batch
from salamander_tpu_torch.ops import corrnmf

torch.set_num_threads(1)

N_SAMPLES = 64
FEATURES = {"sbs": 96, "indel": 83}
NS = [3, 2]
DIM = 3
LANES = 2
SEED = 2**31 + 77


def counts(seed=0):
    """Poisson counts of a planted rank-3 rate per modality."""
    rng = np.random.default_rng(seed)
    load = rng.gamma(2.0, 1.0, (N_SAMPLES, 3))
    return {name: rng.poisson(40.0 * load @ rng.dirichlet(np.ones(v), 3))
            .astype(float) + 1.0 for name, v in FEATURES.items()}


def tensors(X):
    return {name: torch.as_tensor(x) for name, x in X.items()}


def model(cycles):
    return port.MultimodalCorrNMF(
        NS, dim_embeddings=DIM, init_method="random",
        min_iterations=cycles, max_iterations=cycles, dtype="float64",
        device="cpu")


def mdata(X):
    return port.MuData({name: port.AnnData(x.copy()) for name, x in X.items()})


def random_params(Xs, seed=1):
    """Seeded random parameters away from any start: scalings and
    embeddings drawn, the exposures of those."""
    gen = torch.Generator().manual_seed(seed)
    params = ref.restart_init(Xs, NS, DIM, LANES, seed, torch.float64)
    for mod in params["mods"].values():
        for key in ("signature_scalings", "sample_scalings"):
            mod[key] = 0.3 * torch.randn(mod[key].shape, generator=gen,
                                         dtype=torch.float64)
        mod["signature_embeddings"] = 0.7 * torch.randn(
            mod["signature_embeddings"].shape, generator=gen,
            dtype=torch.float64)
    params["sample_embeddings"] = 0.7 * torch.randn(
        params["sample_embeddings"].shape, generator=gen,
        dtype=torch.float64)
    params["variance"] = torch.tensor([0.8, 1.3], dtype=torch.float64)
    for mod in params["mods"].values():
        mod["exposures"] = ref.exposures(
            mod["signature_scalings"], mod["sample_scalings"],
            mod["signature_embeddings"], params["sample_embeddings"],
            ref.FLOAT64)
    return params


def test_starts_are_the_device_draw():
    Xs = tensors(counts())
    drawn = ref.restart_init(Xs, NS, DIM, LANES, SEED, torch.float64)
    generator = torch.Generator().manual_seed(SEED)
    port_params = mm_corrnmf_init_batch(generator, Xs, list(Xs), NS, DIM,
                                        LANES)
    for name in Xs:
        for key, value in drawn["mods"][name].items():
            if key == "exposures":  # a product, summed in another order
                np.testing.assert_allclose(
                    value, port_params["mods"][name][key], rtol=1e-13)
            else:
                assert torch.equal(value, port_params["mods"][name][key]), \
                    key
    assert torch.equal(drawn["sample_embeddings"],
                       port_params["sample_embeddings"])
    assert torch.equal(drawn["variance"], port_params["variance"])


# The port's float64 Armijo test compares whole objectives and the
# reference's their difference term by term: near a row's stop the two can
# take different halvings, and rows then stop apart by less than the
# stop's m * 1e-5 allows. Leaves past the Newton solves are held at 1e-6,
# the ELBO at 1e-8; a leaf computed before them differs in rounding only.
# Twenty cycles downstream the leaves are held at 1e-6 absolute too, as
# test_torch_mmcorrnmf_model.py holds the fitted leaves against the JAX
# package's.
NEWTON_RTOL, NEWTON_ATOL = 1e-6, 1e-8
FIT_ATOL = 1e-6


def test_one_cycle_leaf_by_leaf():
    X = counts()
    Xs = tensors(X)
    params = random_params(Xs)
    fitted = model(10)
    fitted._setup_mdata(mdata(X))
    update_fn, objective_fn = fitted._build_step()
    got = update_fn(params, {"X": Xs})
    want = ref.cycle(Xs, params, ref.FLOAT64)
    for name in Xs:
        for key, value in want["mods"][name].items():
            before = key in ("sample_scalings", "exposures", "signatures")
            np.testing.assert_allclose(
                got["mods"][name][key].numpy(), value.numpy(),
                rtol=1e-12 if before else NEWTON_RTOL,
                atol=0.0 if before else NEWTON_ATOL, err_msg=f"{name} {key}")
    for key in ("sample_embeddings", "variance"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=NEWTON_RTOL, atol=NEWTON_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(objective_fn(got, {"X": Xs}).numpy(),
                               ref.elbo(Xs, want).numpy(), rtol=1e-8)


def test_twenty_cycles_through_fit_best_of():
    X = counts(1)
    fitted = model(20)
    summary = port.fit_best_of(fitted, mdata(X), n_restarts=LANES,
                               base_seed=SEED)
    params, losses, iterations, best = ref.best_of(
        X, NS, DIM, LANES, SEED, (20, 20, 10, 1e-7),
        init_dtype=torch.float64)
    np.testing.assert_allclose(summary.losses, losses, rtol=1e-8)
    assert list(summary.n_iterations) == list(iterations) == [20, 20]
    assert summary.best_index == best
    for name in X:
        np.testing.assert_allclose(
            summary.signatures[name].transpose(0, 2, 1),
            params["mods"][name]["signatures"].numpy(), rtol=NEWTON_RTOL,
            atol=FIT_ATOL)
    np.testing.assert_allclose(fitted.mdata.obsm["embeddings"],
                               params["sample_embeddings"][best].numpy(),
                               rtol=NEWTON_RTOL, atol=FIT_ATOL)
    assert fitted.variance == pytest.approx(
        float(params["variance"][best]), rel=NEWTON_RTOL)


def test_record_of_a_fit():
    X = counts(2)
    with profiling.recording():
        port.fit_best_of(model(20), mdata(X), n_restarts=LANES,
                         base_seed=SEED)
    (call,) = profiling.calls(1)
    assert call["name"] == "multistart.fit_best_of"
    names = {span[0] for span in call["spans"]}
    assert {"corrnmf.signature_newton", "corrnmf.sample_newton",
            "mmcorrnmf.objective"} <= names
    counts_ = call["counts"]
    assert counts_["mmcorrnmf.cycles"] == 20
    # three sample-side steps a cycle; each signature-side step is one host
    # read of the done flags
    assert counts_["corrnmf.newton_steps.sample"] == 3 * 20
    assert counts_["ops.host_syncs"] == counts_[
        "corrnmf.newton_steps.signature"] >= 2 * 20


def test_newton_steps_counted_are_the_loop_steps(monkeypatch):
    Xs = tensors(counts())
    params = random_params(Xs)
    mod, U = params["mods"]["sbs"], params["sample_embeddings"]
    aux = mod["exposures"].mT * mod["signatures"].sum(-1, keepdim=True)
    run = []
    real = corrnmf._newton_step
    monkeypatch.setattr(corrnmf, "_newton_step",
                        lambda *args: run.append(1) or real(*args))
    for max_iter, side in ((100, "signature"), (3, "sample")):
        before = dict(profiling.counters)
        run.clear()
        corrnmf.update_embeddings(
            mod["signature_embeddings"], U, mod["signature_scalings"],
            mod["sample_scalings"], params["variance"], aux,
            max_iter=max_iter)
        name = f"corrnmf.newton_steps.{side}"
        assert profiling.counters[name] - before.get(name, 0) == len(run)
        syncs = profiling.counters.get("ops.host_syncs", 0) - before.get(
            "ops.host_syncs", 0)
        assert syncs == (len(run) if side == "signature" else 0)
    assert len(run) == 3


def test_signature_solve_in_float32_at_cohort_size():
    """The Armijo test over 20,000 samples: float32 within 1e-5 of
    float64's solve (the difference of two whole objectives, which it
    read before, stopped rows 3.6e-4 short)."""
    gen = torch.Generator().manual_seed(0)
    D, K, m = 20_000, 6, 6
    U = 0.5 * torch.randn((D, m), generator=gen, dtype=torch.float64)
    L_true = 0.5 * torch.randn((K, m), generator=gen, dtype=torch.float64)
    tau = torch.log(torch.rand(D, generator=gen, dtype=torch.float64) * 50
                    + 10)
    sigma = torch.zeros(K, dtype=torch.float64)
    aux = torch.poisson(torch.exp(sigma[:, None] + tau[None] + L_true @ U.T),
                        generator=gen)
    L0 = torch.randn((K, m), generator=gen, dtype=torch.float64)
    solved = [corrnmf.update_embeddings(
        L0.to(dtype), U.to(dtype), sigma.to(dtype), tau.to(dtype), 1.0,
        aux.to(dtype), max_iter=100).double()
        for dtype in (torch.float64, torch.float32)]
    assert float((solved[1] - solved[0]).abs().max()) < 1e-5
