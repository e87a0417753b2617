"""Tests that need an NVIDIA GPU: the port's CUDA kernels (resident at
every cluster size, and streamed at every split it is tested at) against
their plain PyTorch version, with one X shared by all lanes and with one X
per lane, at PCAWG size and at cohort size; the engine's spans of the
kernel route captured as CUDA graphs against the same spans run eagerly,
bit for bit; and the unrolled CorrNMF Newton solve's kernel against its
plain steps, step by step. They skip without a card.

This file imports neither jax nor salamander_tpu, so it also runs where JAX
is not installed: on the card, run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from salamander_tpu_torch.ops import cuda_klnmf

EPSILON = float(np.finfo(np.float32).eps)


def make_problem(V, K, D, R, seed=0):
    rng = np.random.default_rng(seed)
    X = np.clip(rng.poisson(30, (V, D)), EPSILON, None)
    W = rng.dirichlet(np.ones(V), (R, K)).transpose(0, 2, 1)
    H = rng.uniform(size=(R, K, D)) * 30
    return (X.astype(np.float32), np.ascontiguousarray(W, np.float32),
            H.astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def kernels_taking(X, W):
    """Every (kernel, cluster or split) the tests hold for these tensors."""
    R, V, K = W.shape
    return cuda_klnmf._kernels_taking(R, V, K, X.shape[-1],
                                      cuda_klnmf._sm_count(X.device.index))


def assert_kernel_close(actual, expected):
    """rtol 2e-4 (float32 sums in another order, amplified over the steps;
    the JAX package's on-chip check uses the same), with an absolute floor
    of 1e-6 of the tensor's largest entry for entries at the eps clip."""
    atol = 1e-6 * float(expected.abs().max())
    torch.testing.assert_close(actual, expected, rtol=2e-4, atol=atol)


SHAPES = [
    (96, 5, 192, 100),   # PCAWG SBS headline shape (resident, C=1)
    (96, 5, 192, 1),     # a single fit (C=8)
    (96, 5, 192, 20),    # C=4
    (96, 5, 192, 40),    # C=2
    (96, 10, 192, 20),   # the rank scan's K=10 point
    (83, 5, 192, 4),     # indel channels
    (32, 5, 192, 4),     # SV channels
    (96, 1, 192, 4),
    (96, 20, 192, 4),
    (96, 5, 100, 4),     # D not a multiple of the tile
    (96, 5, 100, 1),     # D limits the cluster to 4
    (83, 5, 17, 3),      # D not a multiple of 4: 4-byte copies of X
]
STEP_COUNTS = (1, 7, 10, 3, 0)


def card_problem(device, V, K, D, R):
    return tuple(torch.from_numpy(a).to(device)
                 for a in make_problem(V, K, D, R, seed=V + K + D + R))


@pytest.mark.cuda
@pytest.mark.parametrize("V, K, D, R", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, V, K, D, R):
    """The planned kernel (fused_mu_block) against the plain version."""
    X, W, H = card_problem(cuda_device, V, K, D, R)
    plan = cuda_klnmf.launch_plan(X, W)
    for steps in STEP_COUNTS:
        before = cuda_klnmf.fused_mu_block.launches
        by_variant = cuda_klnmf.fused_mu_block.launches_by_variant[
            plan.variant]
        W_k, H_k = cuda_klnmf.fused_mu_block(X, W, H, steps)
        torch.cuda.synchronize()
        assert cuda_klnmf.fused_mu_block.launches == before + 1
        assert cuda_klnmf.fused_mu_block.launches_by_variant[
            plan.variant] == by_variant + 1
        W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
        assert_kernel_close(W_k, W_r)
        assert_kernel_close(H_k, H_r)


# the cohort shapes: the 96 x 10,000 scan (suite config5) at R = 100 and
# 20, one cohort fit, the largest rank, an unaligned D (4-byte copies)
COHORT_SHAPES = [
    (96, 5, 10000, 20),
    (96, 5, 10000, 100),
    (96, 20, 10000, 100),
    (96, 10, 10000, 20),
    (96, 8, 10000, 1),
    (96, 32, 10000, 4),
    (96, 5, 9999, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("V, K, D, R", SHAPES + COHORT_SHAPES)
def test_each_kernel_matches_plain_on_card(cuda_device, V, K, D, R):
    """Both kernels, the resident one at every cluster size that holds a
    lane and the streamed one at splits 1, 2, 8 and its plan's, against
    the plain version at 0, 1, 3, 7 and 10 steps; 0 steps copy the
    inputs. The cohort shapes plan the streamed kernel."""
    X, W, H = card_problem(cuda_device, V, K, D, R)
    names = kernels_taking(X, W)
    assert ("streamed", 1) in names
    if D >= 9999:
        plan = cuda_klnmf.launch_plan(X, W)
        assert plan.variant == "streamed"
        assert ("streamed", plan.cluster) in names
        assert R > 20 or plan.cluster > 1
    for steps in STEP_COUNTS:
        W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
        for variant, cluster in names:
            W_k, H_k = cuda_klnmf._fused_mu_block_variant(
                X, W, H, steps, variant, cluster)
            torch.cuda.synchronize()
            if steps == 0:
                assert torch.equal(W_k, W) and torch.equal(H_k, H)
            assert_kernel_close(W_k, W_r)
            assert_kernel_close(H_k, H_r)


@pytest.mark.cuda
@pytest.mark.parametrize("V, K, D, R", [(96, 5, 192, 100), (96, 5, 192, 1),
                                        (96, 10, 192, 20), (83, 5, 17, 3),
                                        (96, 8, 10000, 1), (96, 5, 9999, 4)])
def test_two_launches_are_bit_equal(cuda_device, V, K, D, R):
    """Fixed reduction orders and no atomics on values: the same inputs
    give the same bits, in every kernel and at every split."""
    X, W, H = card_problem(cuda_device, V, K, D, R)
    for variant, cluster in kernels_taking(X, W):
        first = cuda_klnmf._fused_mu_block_variant(X, W, H, 10, variant,
                                                   cluster)
        second = cuda_klnmf._fused_mu_block_variant(X, W, H, 10, variant,
                                                    cluster)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def per_lane_problem(device, R=20, K=5, seed=0):
    """R multinomial resamples of PCAWG SBS (one X per lane) with random
    W and H."""
    from salamander_tpu_torch import datasets

    counts = datasets.load_pcawg_sbs().to_numpy().T  # (96, 192)
    rng = np.random.default_rng(seed)
    totals = counts.sum(0).astype(np.int64)
    lanes = np.stack([
        np.stack([rng.multinomial(n, column / column.sum())
                  for n, column in zip(totals, counts.T)], axis=1)
        for _ in range(R)])
    X = np.clip(lanes, EPSILON, None).astype(np.float32)
    _, W, H = make_problem(96, K, 192, R, seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (X, W, H))


@pytest.mark.cuda
def test_per_lane_x_matches_plain_on_card(cuda_device):
    """X (R, V, D): R = 20 PCAWG resamples at K = 5, the resident kernel at
    every cluster size that holds a lane and the streamed kernel, against
    the plain version at rtol 2e-4."""
    X, W, H = per_lane_problem(cuda_device)
    names = kernels_taking(X, W)
    assert {c for v, c in names if v == "resident"} == {1, 2, 4, 8}
    assert ("streamed", 1) in names
    for steps in (1, 10, 0):
        W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
        for variant, cluster in names:
            W_k, H_k = cuda_klnmf._fused_mu_block_variant(
                X, W, H, steps, variant, cluster)
            torch.cuda.synchronize()
            assert_kernel_close(W_k, W_r)
            assert_kernel_close(H_k, H_r)


@pytest.mark.cuda
def test_shared_x_equals_identical_lanes_bitwise(cuda_device):
    """A per-lane X whose lanes are copies of one X gives the bits of the
    shared-X (stride 0) launch, in every kernel."""
    X, W, H = per_lane_problem(cuda_device)
    shared = X[0].contiguous()
    copies = shared.expand_as(X).contiguous()
    for variant, cluster in kernels_taking(X, W):
        one = cuda_klnmf._fused_mu_block_variant(shared, W, H, 10, variant,
                                                 cluster)
        lanes = cuda_klnmf._fused_mu_block_variant(copies, W, H, 10,
                                                   variant, cluster)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(one, lanes))


@pytest.mark.cuda
def test_per_lane_x_at_cohort_size_matches_plain_on_card(cuda_device):
    """X (R, V, D) of 10 lanes of 96 x 20,000 Poisson counts, K = 5 (a
    cell 7b rank group at a tenth of its samples): the streamed kernel at
    each split against the plain version, and a per-lane X whose lanes
    copy one X bit-equal to the shared-X launch."""
    rng = np.random.default_rng(7)
    X0, W, H = make_problem(96, 5, 20000, 10, seed=7)
    X = np.clip(rng.poisson(X0, (10,) + X0.shape), EPSILON, None)
    X, W, H = (torch.from_numpy(np.ascontiguousarray(a, np.float32))
               .to(cuda_device) for a in (X, W, H))
    names = kernels_taking(X, W)
    assert cuda_klnmf.launch_plan(X, W).variant == "streamed"
    for steps in (1, 10):
        W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
        for variant, cluster in names:
            W_k, H_k = cuda_klnmf._fused_mu_block_variant(
                X, W, H, steps, variant, cluster)
            torch.cuda.synchronize()
            assert_kernel_close(W_k, W_r)
            assert_kernel_close(H_k, H_r)
    shared = X[0].contiguous()
    copies = shared.expand_as(X).contiguous()
    for variant, cluster in names:
        one = cuda_klnmf._fused_mu_block_variant(shared, W, H, 10, variant,
                                                 cluster)
        lanes = cuda_klnmf._fused_mu_block_variant(copies, W, H, 10,
                                                   variant, cluster)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(one, lanes))


@pytest.mark.cuda
def test_the_library_agrees_with_the_plan(cuda_device):
    """mu_block_plan in the source and plan_launch agree (the library
    checks it at load) and the headline shape takes the resident kernel."""
    cuda_klnmf._library()
    X, W, _ = card_problem(cuda_device, 96, 5, 192, 100)
    assert cuda_klnmf.launch_plan(X, W).variant == "resident"


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    X, W, H = (torch.from_numpy(a).to(cuda_device)
               for a in make_problem(16, 3, 20, 2))
    with pytest.raises(ValueError, match="float32"):
        cuda_klnmf.fused_mu_block(X.double(), W.double(), H.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_klnmf.fused_mu_block(X, W.transpose(1, 2).contiguous()
                                  .transpose(1, 2), H, 2)


# ---- the kernel route's spans as CUDA graphs (engine/fit.py) ----


def graph_problem(device, K, R, X=None, seed=0):
    """(params0, data) of R KLNMF lanes on X (PCAWG SBS by default; an
    (R, V, D) X gives each lane its own), random W and H from a seed."""
    from salamander_tpu_torch import datasets

    if X is None:
        X = datasets.load_pcawg_sbs().to_numpy().T
    X = torch.as_tensor(np.ascontiguousarray(X), dtype=torch.float32,
                        device=device)
    V, D = X.shape[-2:]
    _, W, H = make_problem(V, K, D, R, seed=seed)
    H = H * float(X.sum()) / (X.shape[0] if X.dim() == 3 else 1) / (
        D * K * 15.0)
    return ({"W": torch.from_numpy(W).to(device),
             "H": torch.from_numpy(np.ascontiguousarray(H)).to(device)},
            {"X": X})


def kernel_fns(params0):
    """(update, objective, block factory) of the kernel route: the float64
    objective of the fits, the kernel's block bound to its data (the one
    klnmf_block gives these params)."""
    from salamander_tpu_torch.models.signature_nmf import promote_objective
    from salamander_tpu_torch.ops.klnmf import make_step_functions

    update_fn, objective_fn = make_step_functions()
    objective_fn = promote_objective(objective_fn, params0)

    def block(data):
        fused = cuda_klnmf.klnmf_block(params0, data)
        assert isinstance(fused, cuda_klnmf.KernelBlock)
        return fused

    return update_fn, objective_fn, block


def graphed_and_eager(run):
    """run() with spans captured, then with every span eager: the two
    results, and the graph counts and launches of each."""
    from salamander_tpu_torch.engine import fit as fit_module

    out = []
    for eager in (False, True):
        for key in fit_module.graph_counts:
            fit_module.graph_counts[key] = 0
        cuda_klnmf.fused_mu_block.launches = 0
        if eager:
            with fit_module._eager_spans():
                result = run()
        else:
            result = run()
        torch.cuda.synchronize()
        out.append((result, dict(fit_module.graph_counts),
                    cuda_klnmf.fused_mu_block.launches))
    return out


def assert_fit_results_equal(a, b):
    for key in a.params:
        assert torch.equal(a.params[key], b.params[key]), key
    torch.testing.assert_close(a.history, b.history, rtol=0, atol=0,
                               equal_nan=True)
    assert np.array_equal(np.asarray(torch.as_tensor(a.n_evals).cpu()),
                          np.asarray(torch.as_tensor(b.n_evals).cpu()))
    assert np.array_equal(np.asarray(torch.as_tensor(a.n_iterations).cpu()),
                          np.asarray(torch.as_tensor(b.n_iterations).cpu()))


def assert_graphed(counts, launches, eager_counts, eager_launches):
    """The graphed run captured and replayed; the eager one did neither;
    both launched the kernel as often (replays count their launches)."""
    assert counts["captures"] >= 1 and counts["replays"] >= 1
    assert eager_counts == {"captures": 0, "replays": 0}
    assert launches == eager_launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
def test_graphed_headline_equals_eager(cuda_device, compact):
    """The headline shapes (PCAWG SBS, K=5, R=100), lockstep and
    compacting: graphed spans give the eager spans' W, H, history,
    evaluations and iterations bit for bit."""
    from salamander_tpu_torch.engine import FitConfig, fit_loop_lockstep
    from salamander_tpu_torch.parallel.compaction import compacting_runner

    params0, data = graph_problem(cuda_device, 5, 100)
    config = FitConfig(500, 3000, 10, 1e-7)
    _, objective_fn, block = kernel_fns(params0)

    def run():
        if compact:
            return compacting_runner(config, False, 8).run(params0, data)[0]
        return fit_loop_lockstep(lambda p: objective_fn(p, data), params0,
                                 config, block(data))

    (graphed, counts, launches), (eager, eager_counts, eager_launches) = \
        graphed_and_eager(run)
    assert_fit_results_equal(graphed, eager)
    assert_graphed(counts, launches, eager_counts, eager_launches)


@pytest.mark.cuda
def test_graphed_klnmf_fit_equals_eager(cuda_device):
    """KLNMF(5).fit's loop (R=1, a cluster of 8) through make_fit_function
    from the model's own state: graphed equals eager bit for bit; every
    replay adds its graph's SPAN launches."""
    import salamander_tpu_torch as sal
    from salamander_tpu_torch.engine import fit as fit_module
    from salamander_tpu_torch.engine import make_fit_function
    from salamander_tpu_torch.models.signature_nmf import promote_objective

    model = sal.KLNMF(n_signatures=5, device="cuda", dtype="float32")
    model._setup_adata(sal.AnnData(sal.datasets.load_pcawg_sbs()))
    model._initialize()
    model._setup_fitting_parameters()
    params0, data = model._device_state()
    update_fn, objective_fn = model._build_step()
    objective_fn = promote_objective(objective_fn, params0)
    block = model._block_update_fn(params0, data)
    assert isinstance(block, cuda_klnmf.KernelBlock)

    def run():
        return make_fit_function(update_fn, objective_fn,
                                 model._fit_config(),
                                 block_update_fn=block)(params0, data)

    (graphed, counts, launches), (eager, eager_counts, eager_launches) = \
        graphed_and_eager(run)
    assert_fit_results_equal(graphed, eager)
    assert_graphed(counts, launches, eager_counts, eager_launches)
    assert counts["captures"] == 1
    blocks = -(-graphed.n_evals // fit_module.SPAN) * fit_module.SPAN
    assert launches <= blocks and counts["replays"] * fit_module.SPAN < \
        launches


@pytest.mark.cuda
def test_graphed_per_lane_x_equals_eager(cuda_device):
    """A per-lane X (R=20 PCAWG resamples, K=5, the resident kernel at
    C=4 with a lane stride): graphed equals eager bit for bit."""
    from salamander_tpu_torch.engine import FitConfig, fit_loop_lockstep

    X, _, _ = per_lane_problem(cuda_device)
    params0, data = graph_problem(cuda_device, 5, 20, X=X.cpu().numpy())
    config = FitConfig(200, 1500, 10, 1e-7)
    _, objective_fn, block = kernel_fns(params0)

    def run():
        return fit_loop_lockstep(lambda p: objective_fn(p, data), params0,
                                 config, block(data))

    (graphed, counts, launches), (eager, eager_counts, eager_launches) = \
        graphed_and_eager(run)
    assert cuda_klnmf.fused_mu_block.launches_by_x["per_lane"] > 0
    assert_fit_results_equal(graphed, eager)
    assert_graphed(counts, launches, eager_counts, eager_launches)


@pytest.mark.cuda
def test_graphed_streamed_cooperative_equals_eager(cuda_device):
    """One lane of the 96 x 10,000 catalog at K=8: the streamed kernel
    split over S=79 CTAs (a cooperative launch with a zeroed workspace in
    every replay), graphed equal to eager bit for bit."""
    from salamander_tpu_torch import datasets
    from salamander_tpu_torch.engine import FitConfig, fit_loop

    X = datasets.synthetic_catalog(96, 10_000, 8, seed=0)
    params0, data = graph_problem(cuda_device, 8, 1, X=X)
    params0 = {key: value[0] for key, value in params0.items()}
    plan = cuda_klnmf.launch_plan(data["X"], params0["W"][None])
    assert plan.variant == "streamed" and plan.cluster == 79
    update_fn, objective_fn, block = kernel_fns(params0)
    config = FitConfig(200, 1000, 10, 1e-7)

    def run():
        return fit_loop(lambda p: update_fn(p, data),
                        lambda p: objective_fn(p, data), params0, config,
                        block_update_fn=block(data))

    (graphed, counts, launches), (eager, eager_counts, eager_launches) = \
        graphed_and_eager(run)
    assert cuda_klnmf.fused_mu_block.launches_by_variant["streamed"] > 0
    assert_fit_results_equal(graphed, eager)
    assert_graphed(counts, launches, eager_counts, eager_launches)


@pytest.mark.cuda
def test_plain_route_is_not_captured(cuda_device):
    """A block whose class is not capturable runs its spans eagerly on the
    card: no capture, no replay."""
    from salamander_tpu_torch.engine import FitConfig, fit_loop_lockstep
    from salamander_tpu_torch.engine import fit as fit_module

    params0, data = graph_problem(cuda_device, 5, 4)
    _, objective_fn, _ = kernel_fns(params0)

    def plain(p, n_steps):
        W, H = cuda_klnmf.fused_mu_block_reference(data["X"], p["W"],
                                                   p["H"], n_steps)
        return {"W": W, "H": H}

    for key in fit_module.graph_counts:
        fit_module.graph_counts[key] = 0
    fit_loop_lockstep(lambda p: objective_fn(p, data), params0,
                      FitConfig(100, 400, 10, 1e-7), plain)
    assert fit_module.graph_counts == {"captures": 0, "replays": 0}


@pytest.mark.cuda
def test_a_failing_capture_raises(cuda_device):
    """A capturable block that reads the host inside its span cannot be
    captured: the fit raises, it does not carry on eagerly."""
    from salamander_tpu_torch.engine import FitConfig, fit_loop

    params0, data = graph_problem(cuda_device, 5, 1)
    params0 = {key: value[0] for key, value in params0.items()}
    update_fn, objective_fn, _ = kernel_fns(params0)

    class ReadsTheHost(cuda_klnmf.KernelBlock):
        def __call__(self, p, n_steps, **objective):
            float(p["W"].sum())  # a device-to-host copy: refused in a capture
            return super().__call__(p, n_steps, **objective)

    with pytest.raises(RuntimeError):
        fit_loop(lambda p: update_fn(p, data),
                 lambda p: objective_fn(p, data), params0,
                 FitConfig(100, 400, 10, 1e-7),
                 block_update_fn=ReadsTheHost(data))


@pytest.mark.cuda
def test_span_graphs_reuse_one_memory_pool(cuda_device):
    """Fits captured one after another within shared_span_pool(), as a
    cohort's rank groups are, share the span graphs' memory pool: the
    card's reserved memory does not grow with the captures, and once the
    scope ends an empty_cache hands the pool back. With a pool a capture
    each released graph's memory stayed cached, and a later capture could
    not reclaim it (cell 7b ran the card out of memory)."""
    from salamander_tpu_torch import datasets
    from salamander_tpu_torch.engine import (
        FitConfig,
        fit_loop_lockstep,
        shared_span_pool,
    )
    from salamander_tpu_torch.engine import fit as fit_module

    X = datasets.synthetic_catalog(96, 100_000, 5, seed=0)
    params0, data = graph_problem(cuda_device, 5, 10, X=X)
    _, objective_fn, block = kernel_fns(params0)
    config = FitConfig(80, 80, 10, 1e-7)  # two spans: one eager, one graph
    for key in fit_module.graph_counts:
        fit_module.graph_counts[key] = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reserved = []
    with shared_span_pool():
        for _ in range(4):
            fit_loop_lockstep(lambda p: objective_fn(p, data), params0,
                              config, block(data))
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved())
    assert fit_module.graph_counts["captures"] == 4
    one_temporary = 8 * 10 * X.size  # a float64 (R, V, D) tensor
    assert reserved[-1] - reserved[0] < one_temporary, reserved
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    assert after - before < one_temporary, (before, reserved, after)


# ---- the objective epilogue: a launch returns the objective of W', H' ----


def sparse_problem(device, V, K, D, R, per_lane, seed=0):
    """Counts with many zeros (Poisson of gamma(0.5) rates: about a fifth
    of the entries), one X (V, D) or one per lane (R, V, D), random W and
    H."""
    rng = np.random.default_rng(seed)
    X = rng.poisson(rng.gamma(0.5, 20.0, (R if per_lane else 1, V, D)))
    X = X.astype(np.float32) if per_lane else X[0].astype(np.float32)
    _, W, H = make_problem(V, K, D, R, seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (X, W, H))


# (V, K, D, R, one X per lane): the resident kernel at C = 1 (R = 100)
# and 8 (R = 1) and every cluster kernels_taking holds, the streamed one
# at splits above 1 (the cohort shapes through the ring), K in 2, 5, 10, 12
OBJECTIVE_SHAPES = [
    (96, 5, 192, 100, False),
    (96, 5, 192, 1, False),
    (96, 2, 192, 4, True),
    (96, 10, 192, 20, False),
    (96, 12, 192, 4, True),
    (83, 5, 17, 3, False),
    (96, 12, 10000, 20, False),
    (96, 5, 20000, 10, True),
    (96, 2, 20000, 10, True),
    (96, 10, 20000, 10, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("V, K, D, R, per_lane", OBJECTIVE_SHAPES)
def test_objective_epilogue_on_card(cuda_device, V, K, D, R, per_lane):
    """Each kernel that takes the shapes, asked for the objective, writes
    the W' and H' it writes unasked, bit for bit, and each lane's
    objective of them: float32 against make_step_functions' objective of
    the launch's own W', H' at rtol 2e-6, float64 against
    promote_objective's at rtol 1e-12, on counts with zeros."""
    from salamander_tpu_torch.models.signature_nmf import promote_objective
    from salamander_tpu_torch.ops.klnmf import make_step_functions

    X, W, H = sparse_problem(cuda_device, V, K, D, R, per_lane,
                             seed=V + K + D + R)
    assert bool((X == 0).any())
    _, objective_fn = make_step_functions()
    modes = ((torch.float32, objective_fn, 2e-6),
             (torch.float64, promote_objective(objective_fn, {"W": W}),
              1e-12))
    names = kernels_taking(X, W)
    if R in (1, 100):
        assert ("resident", 8 if R == 1 else 1) in names
    if D >= 10000:
        assert any(v == "streamed" and c > 1 for v, c in names)
    for variant, cluster in names:
        for steps in (1, 10):
            plain = cuda_klnmf._fused_mu_block_variant(X, W, H, steps,
                                                       variant, cluster)
            for dtype, objective, rtol in modes:
                W_k, H_k, value = cuda_klnmf._fused_mu_block_variant(
                    X, W, H, steps, variant, cluster, objective=dtype)
                torch.cuda.synchronize()
                assert torch.equal(W_k, plain[0]), (variant, cluster)
                assert torch.equal(H_k, plain[1]), (variant, cluster)
                assert value.dtype == dtype and value.shape == (R,)
                expected = objective({"W": W_k, "H": H_k}, {"X": X})
                torch.testing.assert_close(value, expected, rtol=rtol,
                                           atol=0, msg=lambda m: (
                                               f"{variant} {cluster} "
                                               f"{dtype} {steps}: {m}"))
    with pytest.raises(ValueError, match="after >= 1 step"):
        cuda_klnmf.fused_mu_block(X, W, H, 0, objective=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["pcawg", "cohort"])
def test_graphed_block_objective_keeps_the_iterations(cuda_device, shape):
    """A graphed lockstep fit whose blocks take their float64 objective
    from the launch stops every lane at the iteration, and with the W, H
    and evaluations, of the eager fit whose objective is the plain ops'
    (PCAWG SBS at K = 5, R = 100; ten Poisson resamples of a 96 x 20,000
    catalog at K = 5, the streamed kernel with a per-lane X); the
    histories agree to 1e-12."""
    from salamander_tpu_torch import datasets, profiling
    from salamander_tpu_torch.engine import FitConfig, fit_loop_lockstep
    from salamander_tpu_torch.engine import fit as fit_module

    if shape == "pcawg":
        params0, data = graph_problem(cuda_device, 5, 100)
        config = FitConfig(200, 3000, 10, 1e-7)
    else:
        rng = np.random.default_rng(11)
        X0 = datasets.synthetic_catalog(96, 20_000, 5, seed=11)
        X = rng.poisson(X0, (10,) + X0.shape).astype(np.float32)
        params0, data = graph_problem(cuda_device, 5, 10, X=X, seed=11)
        config = FitConfig(200, 2000, 10, 1e-7)
    _, objective_fn, block = kernel_fns(params0)

    def run(block_update_fn):
        before = dict(profiling.counters)
        result = fit_loop_lockstep(lambda p: objective_fn(p, data), params0,
                                   config, block_update_fn)
        torch.cuda.synchronize()
        return result, {name: profiling.counters.get(name, 0)
                        - before.get(name, 0) for name in
                        ("engine.block_evals",
                         "engine.block_evals_in_kernel")}

    for key in fit_module.graph_counts:
        fit_module.graph_counts[key] = 0
    kernel = block(data)
    fused, fused_counts = run(kernel)
    assert fit_module.graph_counts["replays"] >= 1
    with fit_module._eager_spans():  # a block that gives no objective
        plain, plain_counts = run(lambda p, n_steps: kernel(p, n_steps))
    assert fused_counts["engine.block_evals_in_kernel"] == \
        fused_counts["engine.block_evals"] > 0
    assert plain_counts["engine.block_evals_in_kernel"] == 0
    assert torch.equal(fused.n_iterations, plain.n_iterations)
    assert torch.equal(fused.n_evals, plain.n_evals)
    assert len(set(fused.n_iterations.tolist())) > 1  # lanes stop apart
    for key in fused.params:
        assert torch.equal(fused.params[key], plain.params[key]), key
    torch.testing.assert_close(fused.history, plain.history, rtol=1e-12,
                               atol=0, equal_nan=True)


# ---- the unrolled CorrNMF Newton solve (ops/cuda_corrnmf.py) ----


def cohort_solve_args(device, dtype, lanes=(8,), N=20_000, ns=(6, 5), m=6,
                      seed=0):
    """update_embeddings' arguments of the multimodal sample side at the
    pan-cancer cell's shape: (lanes, N) rows against sum(ns) signatures,
    one sample scaling a modality repeated over its signatures, aux the
    transposed view of compute_aux's (lanes, M, N) output."""
    rng = np.random.default_rng(seed)
    M = sum(ns)
    other = rng.normal(0.0, 0.5, lanes + (M, m))
    truth = rng.normal(0.0, 0.5, lanes + (N, m))
    tau = rng.normal(6.0, 1.0, lanes + (N, len(ns)))
    row_scal = np.concatenate([np.repeat(tau[..., [i]], k, -1)
                               for i, k in enumerate(ns)], -1)
    other_scal = rng.normal(-1.5, 0.5, lanes + (M,))
    rates = np.exp(row_scal + other_scal[..., None, :]
                   + truth @ np.swapaxes(other, -1, -2))
    aux = rng.poisson(rates).astype(np.float64)
    start = truth + rng.normal(0.0, 0.2, truth.shape)
    variance = rng.uniform(0.2, 0.4, lanes) if lanes else 0.3

    def card(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return (card(start), card(other), card(row_scal), card(other_scal),
            card(variance) if lanes else variance,
            card(np.swapaxes(aux, -1, -2)).mT)


def plain_step_terms(b, args):
    """The plain step's Armijo test at rows b (update_embeddings'
    arguments `args` but the rows): each candidate's value, which passes
    at <= 0, in _newton_step's arithmetic (float32: _armijo_by_change's
    change read term by term; float64: f(b + t d) - f(b) - 1e-4 t slope),
    and the rounding scale of that value (the sum of its terms'
    magnitudes), each (..., N, 41); the Newton direction (..., N, m); and
    the first-order rounding of that direction over machine epsilon
    (..., N): ||H^-1|| (||g's terms|| + ||H|| ||d||), the gradient's terms
    being the magnitudes of -aux O, the rates' sum and b / variance."""
    from salamander_tpu_torch.ops import corrnmf

    _, other, scal, other_scal, variance, aux = args
    dtype = b.dtype
    var_rows = torch.as_tensor(variance, dtype=dtype, device=b.device)
    var_rows = var_rows.unsqueeze(-1).unsqueeze(-1)
    offsets = (scal.unsqueeze(-1) if scal.dim() == b.dim() - 1 else scal) \
        + other_scal.unsqueeze(-2)
    linear_term = aux @ other
    rates = torch.exp(offsets + b @ other.mT)
    grad = -linear_term + rates @ other + b / var_rows
    eye = torch.eye(b.shape[-1], dtype=dtype, device=b.device)
    hess = (rates.unsqueeze(-1) * other.unsqueeze(-3)).mT \
        @ other.unsqueeze(-3) + eye / var_rows.unsqueeze(-1)
    direction = -corrnmf._solve_spd(hess, grad)
    # on the host: cusolver's batched eigensolver refuses 160,000 matrices
    eigen = torch.linalg.eigvalsh(hess.double().cpu()).abs().to(
        b.device, dtype)
    grad_terms = linear_term.abs() + rates @ other.abs() \
        + (b / var_rows).abs()
    noise = (grad_terms.norm(dim=-1) + eigen[..., -1]
             * direction.norm(dim=-1)) / eigen[..., 0]
    slope = (grad * direction).sum(-1, keepdim=True)
    ts = 0.5 ** torch.arange(corrnmf._N_BACKTRACK, dtype=dtype,
                             device=b.device)
    if dtype == torch.float32:
        terms = rates.unsqueeze(-2) * torch.expm1(
            ts.unsqueeze(-1) * (direction @ other.mT).unsqueeze(-2))
        linear = ((b / var_rows - linear_term) * direction).sum(
            -1, keepdim=True)
        quadratic = (direction * direction).sum(-1, keepdim=True) / (
            2.0 * var_rows)
        value = terms.sum(-1) + ts * (linear - 1e-4 * slope
                                      + ts * quadratic)
        scale = terms.abs().sum(-1) + ts * (linear.abs() + 1e-4 * slope.abs()
                                            + ts * quadratic)
        return value, scale, direction, noise

    def objective(x):                                   # (..., N, 41)
        return ((-(x * linear_term.unsqueeze(-2)).sum(-1)),
                torch.exp(x @ other.mT.unsqueeze(-3)
                          + offsets.unsqueeze(-2)).sum(-1),
                (x * x).sum(-1) / (2.0 * var_rows))

    candidates = b.unsqueeze(-2) + ts.unsqueeze(-1) * direction.unsqueeze(-2)
    f0 = sum(objective(b.unsqueeze(-2)))
    parts = objective(candidates)
    value = sum(parts) - (f0 + 1e-4 * ts * slope)
    return (value, sum(part.abs() for part in parts) + f0.abs(), direction,
            noise)


def first_passing_index(value):
    """Each row's candidate index k (t = 2^-k): the first that passes, or
    the floor's 40."""
    passes = value <= 0
    passes[..., -1] = True
    return passes.to(torch.int8).argmax(-1)


def step_against_plain(state, args, xtol):
    """One step of the kernel and of the plain solve from the same rows.
    Returns, per row: whether the two took other Armijo candidates; the
    largest difference over the row's largest entry before or after the
    step (a step's rows are sums b + t d, rounded relative to both); the
    summed difference (the done test's measure); whether the row is at
    its optimum to the solve's resolution (the plain step's whole Newton
    step, summed, below the stop threshold, so that every candidate
    leaves it done); |value| / scale of the plain test at the earlier of
    the two candidates (0 where the plain step's terms are all 0); and
    the first-order rounding over epsilon (plain_step_terms) of the
    direction relative to it, and of the row relative to its largest
    entry before or after the step."""
    from salamander_tpu_torch.ops import cuda_corrnmf
    from salamander_tpu_torch.ops.corrnmf import XTOL

    rest = (state, *args[1:])
    kernel = cuda_corrnmf.newton_solve(*rest, 1, xtol)
    plain = cuda_corrnmf.newton_solve_reference(*rest, 1, xtol)
    at = (plain - state).abs().argmax(-1, keepdim=True)
    moved = ((kernel - state).gather(-1, at).squeeze(-1),
             (plain - state).gather(-1, at).squeeze(-1))
    shift = torch.log2((moved[0] / moved[1]).abs()).round()
    apart = (moved[0] != moved[1]) & (shift != 0)
    diff = (kernel - plain).abs()
    row_rel = diff.amax(-1) / torch.maximum(plain.abs().amax(-1),
                                            state.abs().amax(-1))
    threshold = state.shape[-1] * XTOL if xtol is None else xtol
    value, scale, direction, noise = plain_step_terms(state, args)
    done = direction.abs().sum(-1) < torch.as_tensor(
        threshold, dtype=state.dtype, device=state.device).unsqueeze(-1)
    k_plain = first_passing_index(value)
    k_kernel = (k_plain - shift.nan_to_num(0, 64, -64).long()).clamp(0, 40)
    earlier = torch.minimum(k_plain, k_kernel).unsqueeze(-1)
    value, scale = value.gather(-1, earlier), scale.gather(-1, earlier)
    margin = torch.where(scale > 0, value.abs() / scale, 0.0).squeeze(-1)
    top = torch.maximum(plain.abs().amax(-1), state.abs().amax(-1))
    return (apart, row_rel, diff.sum(-1), done, margin,
            noise / direction.norm(dim=-1),
            (noise + state.abs().amax(-1)) / top)


# A row's Armijo pick sits within rounding of the boundary where the test
# value at a candidate is rounding-sized, as for rows near their optimum.
# The kernel sums over the others (and over m) in another order, so such a
# row may take another candidate. So the kernel's steps are held against
# the plain steps one step at a time from the plain solve's own rows:
# - a row at its optimum (its whole Newton step, summed, below the stop
#   threshold, so any candidate leaves it done; each solve's direction,
#   and so its Armijo pick, is the rounding of a gradient whose terms
#   cancel) differs by less than DONE_SPREAD = 4 thresholds, summed as the
#   done test sums;
# - a moving row that takes another candidate lies, at the earlier of the
#   two candidates, within BOUNDARY_ULPS = 16 times its direction's
#   first-order rounding (plain_step_terms: the gradient's terms, whose sum
#   cancels near the optimum, and the Hessian, carried through its
#   inverse), relative to the direction, of the test's scale from the
#   boundary: the test value moves with the direction;
# - every other row agrees, over its largest entry, to ROW_ULPS = 16 times
#   the rounding of its step (the direction's and the row's own), the
#   factor covering sums of a dozen terms in any order.
# Read on an NVIDIA H100 at the cell's shape (8 x 20,000 rows): no row took
# another candidate in steps 1-2; in step 3, 1,415 rows were at their
# optimum (apart by up to 0.21 thresholds in float32) and one moving
# float32 row took another candidate, 6.5e-6 of its scale from the
# boundary; the other rows agree to at most 0.33 times their rounding in
# both dtypes. Over all the cases here: 2.1 thresholds and 0.75 times.
ROW_ULPS = 16.0
BOUNDARY_ULPS = 16.0
DONE_SPREAD = 4.0


def assert_steps_held(args, label, xtol=None, steps=3, row_rtol=None):
    """The kernel's whole solve (one launch, counted) is finite, and each
    of its steps is held against the plain step (DONE_SPREAD;
    BOUNDARY_ULPS; ROW_ULPS, or a relative row_rtol where given). Returns
    the whole solve's rows."""
    from salamander_tpu_torch.ops import cuda_corrnmf
    from salamander_tpu_torch.ops.corrnmf import XTOL

    dtype = args[0].dtype
    eps = torch.finfo(dtype).eps
    launches = cuda_corrnmf.newton_solve.launches
    got = cuda_corrnmf.newton_solve(*args, steps, xtol)
    assert cuda_corrnmf.newton_solve.launches == launches + 1
    assert torch.isfinite(got).all()
    threshold = args[0].shape[-1] * XTOL if xtol is None else xtol
    threshold = torch.as_tensor(threshold, dtype=dtype,
                                device=got.device).unsqueeze(-1)
    for step in range(steps):
        state = cuda_corrnmf.newton_solve_reference(*args, step, xtol)
        (apart, row_rel, diff, done, margin, direction_noise,
         row_noise) = step_against_plain(state, args, xtol)
        moving_apart, moving = ~done & apart, ~done & ~apart
        ulps = margin / (eps * direction_noise)
        row_ulps = row_rel / (eps * row_noise)

        def largest(values):
            return float(values.max()) if values.numel() else 0.0

        print(f"{label} {dtype} step {step + 1}: {int(done.sum())} of "
              f"{done.numel()} rows done, apart by up to "
              f"{largest((diff / threshold)[done]):.3g} thresholds; "
              f"{int(moving_apart.sum())} moving rows took another Armijo "
              f"candidate, within {largest(margin[moving_apart]):.3g} of "
              f"their scale from the boundary "
              f"({largest(ulps[moving_apart]):.3g} times the direction's "
              f"rounding); the other moving rows' "
              f"largest difference {largest(row_rel[moving]):.3g} "
              f"({largest(row_ulps[moving]):.3g} times its rounding)")
        assert largest((diff / threshold)[done]) < DONE_SPREAD
        assert largest(ulps[moving_apart]) <= BOUNDARY_ULPS
        if row_rtol is None:
            assert largest(row_ulps[moving]) <= ROW_ULPS
        else:
            assert largest(row_rel[moving]) <= row_rtol
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_kernel_at_the_cell_shape(cuda_device, dtype):
    """(8, 20,000) rows against 11 signatures, m = 6, in both dtypes."""
    args = cohort_solve_args(cuda_device, dtype)
    assert_steps_held(args, "cell shape")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [5, 1])
def test_newton_kernel_one_fit_without_lanes(cuda_device, dtype, m):
    """One fit: no lane axes, a 0-d variance tensor, one scaling a row;
    m = 1 launches with a zero column."""
    start, other, scal, other_scal, _, aux = cohort_solve_args(
        cuda_device, dtype, lanes=(), N=3000, ns=(5,), m=m, seed=1)
    variance = torch.tensor(0.3, dtype=dtype, device=cuda_device)
    args = (start, other, scal[:, 0].contiguous(), other_scal, variance,
            aux)
    assert_steps_held(args, f"one fit, m = {m}")


def recorded_unrolled_solves(monkeypatch, run):
    """run(), recording the arguments of every unrolled solve that goes
    through ops.corrnmf.update_embeddings; also the kernel's launches
    and the counted solves in it."""
    from salamander_tpu_torch import profiling
    from salamander_tpu_torch.ops import corrnmf, cuda_corrnmf

    calls = []
    original = corrnmf.update_embeddings

    def recording(*args, **kwargs):
        if kwargs.get("max_iter", 100) <= corrnmf._UNROLL_NEWTON_LIMIT:
            calls.append((args, kwargs.get("xtol_total")))
        return original(*args, **kwargs)

    monkeypatch.setattr(corrnmf, "update_embeddings", recording)
    launches = cuda_corrnmf.newton_solve.launches
    in_kernel = profiling.counters.get("corrnmf.newton_solves_in_kernel", 0)
    run()
    torch.cuda.synchronize()
    return (calls, cuda_corrnmf.newton_solve.launches - launches,
            profiling.counters.get("corrnmf.newton_solves_in_kernel", 0)
            - in_kernel)


@pytest.mark.cuda
def test_newton_kernel_corrnmf_det_sample_side(cuda_device, monkeypatch):
    """A CorrNMFDet fit on the card runs its sample side in the kernel
    (one launch a cycle); the last one held against the plain solve."""
    from salamander_tpu_torch import AnnData, CorrNMFDet, datasets

    X = datasets.synthetic_catalog(96, 2000, 4, seed=3).T
    model = CorrNMFDet(n_signatures=4, dim_embeddings=3,
                       init_method="random", min_iterations=20,
                       max_iterations=20, device="cuda")
    calls, launches, in_kernel = recorded_unrolled_solves(
        monkeypatch, lambda: model.fit(AnnData(np.asarray(X, np.float64)),
                                       init_kwargs={"seed": 7}))
    assert len(calls) >= 20 and launches == in_kernel == len(calls)
    args, xtol = calls[-1]
    assert_steps_held(args, "CorrNMFDet", xtol)


@pytest.mark.cuda
def test_newton_kernel_m_padded_scan_lanes(cuda_device, monkeypatch):
    """The padded scan's lanes of dimensions 1..3 share one m = 3 batch
    with a per-lane stop threshold: the kernel takes their sample side,
    and each lane's padded dimensions stay exactly 0."""
    from salamander_tpu_torch import datasets
    from salamander_tpu_torch.engine import FitConfig
    from salamander_tpu_torch.ops.corrnmf import XTOL
    from salamander_tpu_torch.parallel.corrnmf_scan import rank_scan_corrnmf

    X = datasets.synthetic_catalog(96, 500, 3, seed=4).T
    calls, launches, in_kernel = recorded_unrolled_solves(
        monkeypatch, lambda: rank_scan_corrnmf(
            np.asarray(X, np.float64), [3], dim_embeddings_range=[1, 2, 3],
            n_restarts=2, config=FitConfig(10, 10, 10, 1e-7),
            init_method="random", build_models=False, device="cuda"))
    padded = [(args, xtol) for args, xtol in calls
              if isinstance(xtol, torch.Tensor)]
    assert padded and launches == in_kernel == len(calls)
    args, xtol = padded[-1]
    got = assert_steps_held(args, "m-padded", xtol)
    active = torch.round(xtol / XTOL).long()        # (lanes,)
    assert (active < got.shape[-1]).any()
    dims = torch.arange(got.shape[-1], device=got.device)
    pad = (dims >= active.reshape(active.shape + (1,))).unsqueeze(-2)
    assert got.masked_select(pad.expand_as(got)).eq(0).all()


@pytest.mark.cuda
def test_newton_kernel_floor_rows(cuda_device):
    """Rows whose Hessian fails to factor and take the diagonal floor, one
    step in float64: one other o = (2, 1), zero scalings and start, and an
    infinite variance, so the Hessian is exactly o o^T = [[4, 2], [2, 1]]
    and its second pivot exactly 0 in any order of the arithmetic. The
    floored system, [[4, 2], [2, 1]] + EPSILON diag, has a condition of
    about 4e7 and the gradient lies along o exactly (integer counts), so
    the two solves agree to 1e-7 (the condition times float64's 1.1e-16,
    with room) where they take the same Armijo candidate. (Not float32:
    there the floored system's condition times 6e-8 leaves no digit to
    compare.)"""
    rng = np.random.default_rng(5)
    lanes, N = 2, 4000
    dtype = torch.float64

    def card(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda_device)

    aux = rng.poisson(rng.uniform(0.5, 4.0, (lanes, 1, N)))
    args = (card(np.zeros((lanes, N, 2))),
            card(np.broadcast_to([[2.0, 1.0]], (lanes, 1, 2))),
            card(np.zeros((lanes, N))), card(np.zeros((lanes, 1))),
            card(np.full(lanes, np.inf)), card(aux).mT)
    hess = card(np.broadcast_to([[4.0, 2.0], [2.0, 1.0]], (lanes, N, 2, 2)))
    assert torch.linalg.cholesky_ex(hess).info.ne(0).all()
    assert_steps_held(args, "floor rows", steps=1, row_rtol=1e-7)


@pytest.mark.cuda
def test_newton_kernel_refuses_what_it_does_not_take(cuda_device):
    from salamander_tpu_torch.ops import cuda_corrnmf

    args = cohort_solve_args(cuda_device, torch.float32, N=256)
    with pytest.raises(ValueError, match="early-exit"):
        cuda_corrnmf.newton_solve(*args, 5)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_corrnmf.newton_solve(args[0].double(), *args[1:], 3)


# ---- the wide CorrNMF Newton solve (a CTA or a cluster a row) ----


def wide_solve_args(device, dtype, lanes=8, N=6, M=20_000, m=6, seed=0):
    """update_embeddings' arguments of the multimodal signature side at the
    pan-cancer cell's shape: (lanes, N) signature rows against M sample
    embeddings, one scaling a signature, aux (lanes, N, M) counts. Each
    lane starts at its own distance from the truth (0.05 to 0.8), so that
    rows stop at different steps."""
    rng = np.random.default_rng(seed)
    other = rng.normal(0.0, 0.5, (lanes, M, m))
    truth = rng.normal(0.0, 0.5, (lanes, N, m))
    row_scal = rng.normal(-1.5, 0.5, (lanes, N))
    other_scal = rng.normal(4.0, 1.0, (lanes, M))
    rates = np.exp(row_scal[..., None] + other_scal[:, None, :]
                   + truth @ np.swapaxes(other, -1, -2))
    aux = rng.poisson(rates).astype(np.float64)
    spread = np.linspace(0.05, 0.8, lanes)[:, None, None]
    start = truth + spread * rng.normal(0.0, 1.0, truth.shape)
    variance = rng.uniform(0.2, 0.4, lanes)

    def card(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return (card(start), card(other), card(row_scal), card(other_scal),
            card(variance), card(aux))


def assert_wide_held(got, want, xtol):
    """The kernel's solve against the plain one: each row's entries within
    rtol (2e-4 in float32, as the other kernels; 1e-9 in float64) plus an
    absolute term of the row's stop threshold. A row whose sums round the
    other way may stop one step apart, and a step that leaves it done
    moves it by less than the threshold, summed."""
    rows, row_steps = got
    want_rows, want_steps = want
    assert torch.isfinite(rows).all()
    rtol = 2e-4 if rows.dtype == torch.float32 else 1e-9
    threshold = torch.as_tensor(xtol, dtype=rows.dtype, device=rows.device)
    while threshold.dim() < rows.dim():
        threshold = threshold.unsqueeze(-1)
    excess = (rows - want_rows).abs() - rtol * want_rows.abs() - threshold
    apart = (row_steps.long() - want_steps.long()).abs()
    print(f"wide {rows.dtype}: steps {int(row_steps.min())}-"
          f"{int(row_steps.max())} (plain {int(want_steps.min())}-"
          f"{int(want_steps.max())}), {int(apart.gt(0).sum())} of "
          f"{apart.numel()} rows a step apart; largest difference "
          f"{float((rows - want_rows).abs().max()):.3g}")
    assert float(excess.max()) <= 0.0
    assert int(apart.max()) <= 1
    assert abs(int(row_steps.max()) - int(want_steps.max())) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [6, 5])
def test_wide_kernel_at_the_cell_shape(cuda_device, dtype, N):
    """(8, N) signature rows against 20,000 samples, m = 6, the early-exit
    cap of 100 with a per-lane stop threshold (0.1 to 10 times m * XTOL):
    the launch (counted) against the plain loop, rows and step counts."""
    from salamander_tpu_torch.ops import cuda_corrnmf
    from salamander_tpu_torch.ops.corrnmf import XTOL

    args = wide_solve_args(cuda_device, dtype, N=N)
    xtol = 6 * XTOL * torch.logspace(-1, 1, 8, dtype=dtype,
                                     device=cuda_device)
    launches = cuda_corrnmf.wide_newton_solve.launches
    got = cuda_corrnmf.wide_newton_solve(*args, 100, xtol)
    assert cuda_corrnmf.wide_newton_solve.launches == launches + 1
    want = cuda_corrnmf.wide_newton_solve_reference(*args, 100, xtol)
    assert int(got[1].min()) < int(got[1].max())  # rows stop apart
    assert_wide_held(got, want, xtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes, N, M, m, max_iter", [
    (1, 5, 512, 2, 4),      # a minibatch signature side, unrolled
    (1, 5, 4096, 2, 4),
    (2, 3, 300, 1, 100),    # m = 1 at two columns, just above OTHERS_MAX
    (30, 10, 2000, 10, 100),  # the largest m; rows fill the SMs (C = 1)
])
def test_wide_kernel_shapes(cuda_device, dtype, lanes, N, M, m, max_iter):
    from salamander_tpu_torch.ops import cuda_corrnmf
    from salamander_tpu_torch.ops.corrnmf import XTOL

    args = wide_solve_args(cuda_device, dtype, lanes=lanes, N=N, M=M, m=m,
                           seed=M)
    got = cuda_corrnmf.wide_newton_solve(*args, max_iter)
    want = cuda_corrnmf.wide_newton_solve_reference(*args, max_iter)
    assert_wide_held(got, want, m * XTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_kernel_two_launches_are_bit_equal(cuda_device, dtype):
    from salamander_tpu_torch.ops import cuda_corrnmf

    args = wide_solve_args(cuda_device, dtype, N=5, seed=2)
    first = cuda_corrnmf.wide_newton_solve(*args, 100)
    second = cuda_corrnmf.wide_newton_solve(*args, 100)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster, cached", [(2, False), (4, False),
                                             (8, False), (8, True)])
def test_wide_kernel_cluster_ctas_agree(cuda_device, dtype, cluster,
                                        cached):
    """Every CTA of a row's cluster reads the partial sums in the same
    order, so every CTA takes the same directions, candidates and stop:
    their copies of the row are bit-equal, and equal to the plain solve's
    within assert_wide_held's limits."""
    from salamander_tpu_torch.ops import cuda_corrnmf
    from salamander_tpu_torch.ops.corrnmf import XTOL

    args = wide_solve_args(cuda_device, dtype, lanes=2, N=3, seed=3)
    operands = cuda_corrnmf.kernel_operands(*args)
    copies, steps = cuda_corrnmf._launch_wide(
        operands, 100, cuda_corrnmf.WidePlan(cluster, cached))
    assert copies.shape == (2, 3, cluster, 6)
    for rank in range(1, cluster):
        assert torch.equal(copies[..., rank, :], copies[..., 0, :])
    want = cuda_corrnmf.wide_newton_solve_reference(*args, 100)
    assert_wide_held((copies[..., 0, :], steps), want, 6 * XTOL)


@pytest.mark.cuda
def test_wide_kernel_floor_rows(cuda_device):
    """Rows whose Hessian fails to factor and take the diagonal floor, one
    step in float64 at the cell's shape (8 x 6 rows, 20,000 others, m =
    6): 10,000 others at o = (2, 1, 1, 1, 1, 1) and 10,000 at 0, zero
    scalings and start and an infinite variance, so every rate is 1 and
    the Hessian exactly 10,000 o o^T, whose second pivot is exactly 0 in
    any order of the sums (integers). The floored system's condition is
    about 1e7, so the two solves agree to 1e-7 (float64's 1.1e-16 times
    it, with room), as the thread kernel's floor rows do."""
    from salamander_tpu_torch.ops import cuda_corrnmf

    rng = np.random.default_rng(5)
    lanes, N, M, m = 8, 6, 20_000, 6
    dtype = torch.float64

    def card(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda_device)

    other = np.zeros((lanes, M, m))
    other[:, : M // 2] = [2.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    aux = rng.poisson(rng.uniform(0.5, 4.0, (lanes, N, M)))
    args = (card(np.zeros((lanes, N, m))), card(other),
            card(np.zeros((lanes, N))), card(np.zeros((lanes, M))),
            card(np.full(lanes, np.inf)), card(aux))
    hess = card(np.broadcast_to(M // 2 * np.outer(other[0, 0], other[0, 0]),
                                (lanes, N, m, m)))
    assert torch.linalg.cholesky_ex(hess).info.ne(0).all()
    rows, steps = cuda_corrnmf.wide_newton_solve(*args, 1)
    want, want_steps = cuda_corrnmf.wide_newton_solve_reference(*args, 1)
    assert torch.isfinite(rows).all() and steps.eq(1).all()
    torch.testing.assert_close(rows, want, rtol=1e-7, atol=0)
    assert torch.equal(steps, want_steps)


@pytest.mark.cuda
def test_wide_kernel_refuses_what_it_does_not_take(cuda_device):
    """A launch whose cached slice outgrows shared memory (one CTA holding
    20,000 others of 7 float32 values, 560 KB) is refused and raises; so
    do narrow rows, and the thread kernel keeps its own refusals."""
    from salamander_tpu_torch.ops import cuda_corrnmf

    args = wide_solve_args(cuda_device, torch.float32, lanes=1, N=2)
    operands = cuda_corrnmf.kernel_operands(*args)
    launches = cuda_corrnmf.wide_newton_solve.launches
    with pytest.raises(RuntimeError, match="corrnmf_newton_wide_launch"):
        cuda_corrnmf._launch_wide(operands, 100,
                                  cuda_corrnmf.WidePlan(1, True))
    assert cuda_corrnmf.wide_newton_solve.launches == launches
    narrow = wide_solve_args(cuda_device, torch.float32, lanes=1, N=2,
                             M=cuda_corrnmf.OTHERS_MAX)
    with pytest.raises(ValueError, match="narrow rows"):
        cuda_corrnmf.wide_newton_solve(*narrow, 100)
    with pytest.raises(ValueError, match="others a row, above"):
        cuda_corrnmf.newton_solve(*args, 3)


@pytest.mark.cuda
def test_wide_kernel_takes_the_multimodal_signature_side(cuda_device):
    """A MultimodalCorrNMF fit of 10 cycles on the card: every
    signature-side solve (two a cycle, 2,000 samples a row) runs in the
    wide kernel and every sample-side one in the thread kernel; while
    recording, the steps are read once a signature solve, and the fit's
    ELBOs are finite."""
    from salamander_tpu_torch import (
        AnnData,
        MuData,
        MultimodalCorrNMF,
        datasets,
        profiling,
    )
    from salamander_tpu_torch.ops import cuda_corrnmf

    sbs = datasets.synthetic_catalog(96, 2000, 4, seed=1).T
    indel = datasets.synthetic_catalog(83, 2000, 3, seed=2).T
    mdata = MuData({"sbs": AnnData(np.asarray(sbs, np.float64)),
                    "indel": AnnData(np.asarray(indel, np.float64))})
    model = MultimodalCorrNMF(ns_signatures=[4, 3], init_method="random",
                              min_iterations=10, max_iterations=10,
                              conv_test_freq=5, dtype="float32",
                              device="cuda")
    before = dict(profiling.counters)
    wide = cuda_corrnmf.wide_newton_solve.launches
    thread = cuda_corrnmf.newton_solve.launches
    with profiling.recording():
        model.fit(mdata, init_kwargs={"seed": 3})
    torch.cuda.synchronize()

    def added(name):
        return profiling.counters.get(name, 0) - before.get(name, 0)

    assert added("corrnmf.newton_solves_wide") == 20
    assert added("corrnmf.newton_solves_wide_in_kernel") == 20
    assert cuda_corrnmf.wide_newton_solve.launches - wide == 20
    assert cuda_corrnmf.newton_solve.launches - thread == 10
    assert added("corrnmf.newton_solves_in_kernel") == 10
    assert added("ops.host_syncs") >= 20
    assert 20 <= added("corrnmf.newton_steps.signature") <= 2000
    elbos = model.history["objective_function"]
    assert len(elbos) >= 2 and np.isfinite(elbos).all()
