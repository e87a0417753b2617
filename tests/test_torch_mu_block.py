"""The port's fused MU block (salamander_tpu_torch/ops/cuda_klnmf.py): its
plain version against the JAX package's Pallas block (interpret mode), and
its routing. The CUDA kernel itself is tested on a card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salamander_tpu.ops import klnmf as jax_klnmf
from salamander_tpu.ops.pallas_klnmf import fused_mu_block as pallas_mu_block
from salamander_tpu_torch.ops import cuda_klnmf

torch.set_num_threads(1)


def make_problem(V, K, D, R=None, seed=0):
    rng = np.random.default_rng(seed)
    X = np.clip(rng.poisson(30, (V, D)), jax_klnmf.EPSILON, None)
    lanes = 1 if R is None else R
    W = rng.dirichlet(np.ones(V), (lanes, K)).transpose(0, 2, 1)
    H = rng.uniform(size=(lanes, K, D)) * 30
    if R is None:
        W, H = W[0], H[0]
    return (X.astype(np.float32), np.ascontiguousarray(W, np.float32),
            H.astype(np.float32))


@pytest.fixture(scope="module")
def problem():
    return make_problem(16, 3, 32)


def torch_block(X, W, H, steps):
    W_t, H_t = cuda_klnmf.fused_mu_block(
        torch.from_numpy(X), torch.from_numpy(W)[None],
        torch.from_numpy(H)[None], steps,
    )
    return W_t[0].numpy(), H_t[0].numpy()


@pytest.mark.parametrize("steps", [1, 7, 10])
def test_plain_block_matches_pallas(problem, steps):
    X, W, H = problem
    W_pl, H_pl = pallas_mu_block(X, W, H, steps, interpret=True)
    W_t, H_t = torch_block(X, W, H, steps)
    np.testing.assert_allclose(W_t, np.asarray(W_pl), rtol=1e-5)
    np.testing.assert_allclose(H_t, np.asarray(H_pl), rtol=1e-5)


def test_plain_block_runtime_step_count(problem):
    """One traced Pallas program and one torch function serve every step
    count (the engine's remainder tail)."""
    X, W, H = problem
    pallas = jax.jit(lambda s: pallas_mu_block(X, W, H, s, interpret=True))
    for steps in (2, 5):
        W_pl, H_pl = pallas(jnp.asarray(steps, jnp.int32))
        W_t, H_t = torch_block(X, W, H, steps)
        np.testing.assert_allclose(W_t, np.asarray(W_pl), rtol=1e-5)
        np.testing.assert_allclose(H_t, np.asarray(H_pl), rtol=1e-5)


def test_batched_lanes_match_single_problem():
    X, W, H = (torch.from_numpy(a) for a in make_problem(16, 3, 40, R=4))
    W_b, H_b = cuda_klnmf.fused_mu_block(X, W, H, 6)
    for lane in range(4):
        W_1, H_1 = cuda_klnmf.fused_mu_block(
            X, W[lane:lane + 1], H[lane:lane + 1], 6
        )
        torch.testing.assert_close(W_b[lane], W_1[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(H_b[lane], H_1[0], rtol=1e-6, atol=0)


def test_cpu_call_runs_plain_version_without_counting():
    X, W, H = (torch.from_numpy(a) for a in make_problem(8, 2, 12, R=2))
    before = cuda_klnmf.fused_mu_block.launches
    W_k, H_k = cuda_klnmf.fused_mu_block(X, W, H, 3)
    W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, 3)
    assert torch.equal(W_k, W_r) and torch.equal(H_k, H_r)
    assert cuda_klnmf.fused_mu_block.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["single", "shared", "per_lane"])
def test_block_update_returns_the_loop_objective(layout, dtype):
    """Asked for the objective, the block update (plain on the CPU) returns
    the params it returns unasked and, bit for bit, the engine objective of
    them: make_step_functions' own in float32, promote_objective's in
    float64; fused_mu_block returns it per lane."""
    from salamander_tpu_torch.models.signature_nmf import promote_objective
    from salamander_tpu_torch.ops import klnmf as torch_klnmf

    X, W, H = (torch.from_numpy(a) for a in make_problem(16, 3, 40, R=3))
    if layout == "per_lane":
        X = torch.stack([X + lane for lane in range(3)])
    params = {"W": W[0], "H": H[0]} if layout == "single" else \
        {"W": W, "H": H}
    data = {"X": X}
    _, objective_fn = torch_klnmf.make_step_functions()
    if dtype == torch.float64:
        objective_fn = promote_objective(objective_fn, params)
    block = cuda_klnmf.KernelBlock(data)
    plain = block(params, 4)
    fused, value = block(params, 4, objective=dtype)
    assert all(torch.equal(fused[key], plain[key]) for key in plain)
    expected = objective_fn(plain, data)
    assert value.dtype == dtype and value.shape == expected.shape
    assert torch.equal(value, expected)
    if layout != "single":
        *block, per_lane = cuda_klnmf.fused_mu_block(X, W, H, 4, dtype)
        assert torch.equal(per_lane, expected)
        assert all(torch.equal(a, b) for a, b in zip(block, plain.values()))


@pytest.mark.parametrize("steps", [1, 10])
def test_per_lane_plain_block_matches_vmapped_pallas(steps):
    """X (R, V, D), one count matrix per lane: the plain version against the
    Pallas block under vmap over X, W and H."""
    rng = np.random.default_rng(3)
    X0, W, H = make_problem(16, 3, 32, R=4)
    X = np.stack([rng.poisson(X0).astype(np.float32) + 1.0
                  for _ in range(4)])
    vmapped = jax.vmap(lambda x, w, h: pallas_mu_block(x, w, h, steps,
                                                       interpret=True))
    W_pl, H_pl = vmapped(X, W, H)
    W_t, H_t = cuda_klnmf.fused_mu_block(torch.from_numpy(X),
                                         torch.from_numpy(W),
                                         torch.from_numpy(H), steps)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_pl), rtol=1e-5)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_pl), rtol=1e-5)


def test_per_lane_block_equals_lane_by_lane():
    X0, W, H = (torch.from_numpy(a) for a in make_problem(16, 3, 40, R=3))
    X = torch.stack([X0 + lane for lane in range(3)])
    W_b, H_b = cuda_klnmf.fused_mu_block(X, W, H, 6)
    for lane in range(3):
        W_1, H_1 = cuda_klnmf.fused_mu_block(
            X[lane], W[lane:lane + 1], H[lane:lane + 1], 6)
        torch.testing.assert_close(W_b[lane], W_1[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(H_b[lane], H_1[0], rtol=1e-6, atol=0)


def test_per_lane_routing():
    """A per-lane X takes the kernel's route where its lanes match W's; the
    launch plan does not depend on whether X is shared."""
    X, W, H = (torch.from_numpy(a) for a in make_problem(16, 3, 20, R=2))
    lanes = X.expand(2, -1, -1)
    assert cuda_klnmf.unsupported_reason(lanes, W, H) == \
        cuda_klnmf.unsupported_reason(X, W, H) == \
        "the tensors are not on a CUDA device"
    assert "one lane of W per lane of X" in cuda_klnmf.unsupported_reason(
        X.expand(3, -1, -1), W, H)
    with pytest.raises(ValueError, match="one lane of W per lane"):
        cuda_klnmf._check_kernel_inputs(X.expand(3, -1, -1).contiguous(),
                                        W, H)


def _routing_case(name):
    X, W, H = (torch.from_numpy(a) for a in make_problem(16, 3, 20, R=2))
    data, n_given = {"X": X}, 0
    if name == "float64":
        X, W, H = X.double(), W.double(), H.double()
    elif name == "weights_kl":
        data["weights_kl"] = torch.ones(20)
    elif name == "weights_lhalf":
        data["weights_lhalf"] = torch.ones(20)
    elif name == "given_signatures":
        n_given = 1
    elif name == "rank_above_k_max":
        W = torch.ones(2, 16, cuda_klnmf.K_MAX + 1)
        H = torch.ones(2, cuda_klnmf.K_MAX + 1, 20)
    elif name == "shared_memory":
        W, X = torch.ones(2, 4096, 3), torch.ones(4096, 20)
    return X, W, H, data, n_given


@pytest.mark.parametrize("case, reason", [
    ("cpu", "CUDA"),
    ("float64", "float32"),
    ("weights_kl", "weights"),
    ("weights_lhalf", "weights"),
    ("given_signatures", "given"),
    ("rank_above_k_max", "K_MAX"),
    ("shared_memory", "shared memory"),
])
def test_routing_decides_before_launch(case, reason):
    """Only float32, unweighted fits without given signatures whose W fits
    in shared memory, on a card, take the kernel."""
    X, W, H, data, n_given = _routing_case(case)
    assert reason in cuda_klnmf.unsupported_reason(X, W, H, data, n_given)
    assert cuda_klnmf.klnmf_block({"W": W, "H": H}, {**data, "X": X},
                                  n_given) is None


def test_shared_bytes_bound():
    # the 96 x 10,000 cohort at K=5 and at the largest rank both fit, one
    # lane a CTA; the bound is on V (two tile slots of V rows)
    assert 0 < cuda_klnmf.shared_bytes(96, 5, 10000, 1) <= 232448
    assert 0 < cuda_klnmf.shared_bytes(96, cuda_klnmf.K_MAX, 10000, 1) \
        <= 232448
    assert cuda_klnmf.shared_bytes(4096, 3, 10000, 1) == 0
    # the resident kernel holds PCAWG SBS's X (72 KiB) with W and H
    assert 96 * 192 * 4 < cuda_klnmf.resident_shared_bytes(96, 5, 192, 1) \
        <= 232448


H100_SMS = 132


@pytest.mark.parametrize("R, V, K, D, variant, cluster", [
    (100, 96, 5, 192, "resident", 1),    # the headline: 100 lanes, 132 SMs
    (1, 96, 5, 192, "resident", 8),      # KLNMF.fit: one lane on 8 SMs
    (40, 96, 5, 192, "resident", 2),
    (20, 96, 10, 192, "resident", 4),    # the rank scan's lanes
    (1, 96, 5, 100, "resident", 4),      # >= 16 samples a CTA caps C at 4
    (20, 96, 10, 10000, "streamed", 6),  # X does not fit: streamed, 6 CTAs
    (100, 96, 32, 192, "streamed", 1),   # a lane each: 100 lanes fill it
    (1, 4096, 3, 20, None, 1),           # neither kernel takes V=4096
    (1, 96, 33, 192, None, 1),           # K above K_MAX
])
def test_launch_plan(R, V, K, D, variant, cluster):
    plan = cuda_klnmf.plan_launch(R, V, K, D, H100_SMS)
    assert (plan.variant, plan.cluster) == (variant, cluster)
    assert plan.threads == cuda_klnmf.THREADS
    if variant == "resident":
        assert plan.shared_bytes == cuda_klnmf.resident_shared_bytes(
            V, K, D, cluster)
    elif variant == "streamed":
        assert plan.shared_bytes == cuda_klnmf.shared_bytes(V, K, D, cluster)


@pytest.mark.parametrize("K", [1, 5, 8, 9, 16, 17, 32])
def test_every_planned_launch_fits_shared_memory(K):
    shapes = [(R, V, D) for R in (1, 20, 40, 100, 200)
              for V in (32, 83, 96, 200, 1000)
              for D in (1, 16, 17, 100, 192, 1000, 10000)]
    for R, V, D in shapes:
        plan = cuda_klnmf.plan_launch(R, V, K, D, H100_SMS)
        assert plan.shared_bytes <= 232448
        assert (plan.variant is None) == (plan.shared_bytes == 0)
        if plan.variant == "resident" and plan.cluster > 1:
            assert -(-D // plan.cluster) >= 16
        # support does not depend on the SM count
        assert (cuda_klnmf.plan_launch(R, V, K, D, 1).variant is None) == \
            (plan.variant is None)


COHORT_PLANS = (
    [(100, K, 10000) for K in range(2, 21)]   # cell 5: k=2..20 x 100
    + [(20, K, 10000) for K in (5, 10, 20)]   # the scan at 20 restarts
    + [(1, K, 10000) for K in (5, 8, 20, 32)]  # one cohort fit
    + [(1, 5, 200000), (10, 5, 200000),       # cell 7b: a lane, a group
       (4, 5, 9999), (1, 5, 9999)])           # no 16-byte rows


@pytest.mark.parametrize("R, K, D", COHORT_PLANS)
def test_cohort_launch_plan(R, K, D):
    """At cohort size every lane takes the streamed kernel, split over S
    CTAs: S > 1 where the lanes are too few to fill the card, R * S never
    above the SM count the plan assumes, every CTA owning samples, and the
    plan on one SM the same kernel at S = 1."""
    plan = cuda_klnmf.plan_launch(R, 96, K, D, H100_SMS)
    assert plan.variant == "streamed"
    S = plan.cluster
    assert S >= 1 and (S == 1 or R * S <= H100_SMS)
    if R <= H100_SMS // 2:
        assert S > 1
    layout = cuda_klnmf.streamed_layout(96, K, D, S)
    assert layout is not None and plan.shared_bytes == layout[0] <= 232448
    _, dc, stages = layout
    assert dc % cuda_klnmf.stream_tile(K) == 0 and (S - 1) * dc < D <= S * dc
    assert stages in (0, 2, 3)
    single = cuda_klnmf.plan_launch(R, 96, K, D, 1)
    assert (single.variant, single.cluster) == ("streamed", 1)
    assert any(name == ("streamed", S) for name in
               cuda_klnmf._kernels_taking(R, 96, K, D, H100_SMS))


def test_plain_block_matches_pallas_where_the_resident_kernel_cannot():
    """(R, V, K, D) = (2, 96, 5, 2,500), float64: a lane the resident kernel
    does not hold (the streamed kernel's shapes), the plain block against
    the Pallas block under vmap, 3 steps. The Pallas dots accumulate in
    float32 (preferred_element_type), hence rtol 1e-5."""
    assert cuda_klnmf.plan_launch(2, 96, 5, 2500, H100_SMS).variant == \
        "streamed"
    X, W, H = (a.astype(np.float64) for a in make_problem(96, 5, 2500, R=2))
    vmapped = jax.vmap(lambda w, h: pallas_mu_block(X, w, h, 3,
                                                    interpret=True))
    W_pl, H_pl = vmapped(W, H)
    W_t, H_t = cuda_klnmf.fused_mu_block(torch.from_numpy(X),
                                         torch.from_numpy(W),
                                         torch.from_numpy(H), 3)
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_pl), rtol=1e-5)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_pl), rtol=1e-5)
