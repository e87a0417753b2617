"""salamander_tpu_torch's rank scans at float64 on the CPU: the padded
(rank-masked) KLNMF scan against the unpadded one per lane identical, the
masked runner against the JAX package's on the same padded numpy params0
(rtol 1e-8), the MvNMF scan in both layouts and against the JAX
package's fed the same starts, packing and compaction invariance, the
generic rank_scan, and per-rank checkpoint resume."""

import numpy as np
import pytest
import torch

import salamander_tpu_torch as port
from salamander_tpu import datasets as jax_datasets
from salamander_tpu.engine import FitConfig as JaxFitConfig
from salamander_tpu.parallel.restarts import (
    build_klnmf_masked_runner as jax_masked_runner,
)
from salamander_tpu_torch.engine import FitConfig
from salamander_tpu_torch.ops import klnmf as port_klnmf
from salamander_tpu_torch.parallel import restarts

torch.set_num_threads(1)

N_SAMPLES = 24
CONFIG = FitConfig(min_iterations=20, max_iterations=200, conv_test_freq=10,
                   tol=1e-4)
KWARGS = dict(seed=11, config=CONFIG, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def X():
    frame = jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    return np.ascontiguousarray(frame.to_numpy().T)


def assert_same_ranks(a, b, exact=True):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k].n_iterations, b[k].n_iterations)
        assert a[k].best_index == b[k].best_index
        assert tuple(a[k].W.shape) == tuple(b[k].W.shape)
        if exact:
            np.testing.assert_array_equal(a[k].losses, b[k].losses)
            np.testing.assert_array_equal(np.asarray(a[k].W),
                                          np.asarray(b[k].W))
        else:
            np.testing.assert_allclose(a[k].losses, b[k].losses, rtol=1e-9)
            np.testing.assert_allclose(np.asarray(a[k].W),
                                       np.asarray(b[k].W), rtol=1e-7,
                                       atol=1e-12)


@pytest.mark.parametrize("layout", [
    dict(pack_points=True), dict(pack_points=False),
    dict(pack_points=True, compact=True, compact_min_bucket=2),
])
def test_padded_klnmf_scan_equals_unpadded(X, layout):
    ranks = [2, 3, 5]
    plain = port.rank_scan_klnmf(X, ranks, 4, pad_ranks=False, **KWARGS)
    padded = port.rank_scan_klnmf(X, ranks, 4, pad_ranks=True,
                                  rank_bucket=4, **layout, **KWARGS)
    assert_same_ranks(plain, padded)
    assert padded[3].W.shape == (4, 96, 3) and padded[5].H.shape == \
        (4, 5, N_SAMPLES)
    assert len({int(n) for k in plain for n in plain[k].n_iterations}) > 2


def test_unpadded_scan_compact_and_default(X):
    plain = port.rank_scan_klnmf(X, [2, 4], 8, pad_ranks=False,
                                 compact=False, **KWARGS)
    packed = port.rank_scan_klnmf(X, [2, 4], 8, pad_ranks=False,
                                  compact=True, compact_min_bucket=2,
                                  **KWARGS)
    default = port.rank_scan_klnmf(X, [2, 4], 8, **KWARGS)
    assert_same_ranks(plain, packed)
    assert_same_ranks(plain, default)
    # rank k at offset i draws from seed + 1000 * i
    single = port.fit_klnmf_restarts(X, 4, 8, seed=11 + 1000,
                                     config=CONFIG, dtype=torch.float64,
                                     device="cpu")
    np.testing.assert_array_equal(single.losses, plain[4].losses)


def test_masked_runner_matches_jax(X):
    """The rank-masked lockstep fit against the JAX package's on the same
    padded numpy params0 (ranks 2 and 3 inside Kp = 4)."""
    rng = np.random.default_rng(4)
    W_parts, H_parts, masks = [], [], []
    for k in (2, 3):
        W = rng.dirichlet(np.ones(96), (3, k)).transpose(0, 2, 1)
        H = rng.uniform(1.0, 300.0, (3, k, N_SAMPLES))
        W_pad, H_pad, mask = port_klnmf.pad_rank(torch.as_tensor(W),
                                                 torch.as_tensor(H), 4)
        W_parts.append(W_pad.numpy())
        H_parts.append(H_pad.numpy())
        masks.append(np.broadcast_to(mask.numpy(), (3, 4)))
    params0 = {"W": np.concatenate(W_parts), "H": np.concatenate(H_parts),
               "mask": np.concatenate(masks)}
    params_j, losses_j, n_iter_j = jax_masked_runner(
        JaxFitConfig(*CONFIG))(params0, {"X": X})
    runner = restarts.build_klnmf_masked_runner(CONFIG)
    params_t, losses_t, n_iter_t = runner(
        {key: torch.as_tensor(np.array(value))
         for key, value in params0.items()},
        {"X": torch.as_tensor(X)},
    )
    np.testing.assert_array_equal(n_iter_t.numpy(), np.asarray(n_iter_j))
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-8)
    for key in ("W", "H"):
        np.testing.assert_allclose(params_t[key].numpy(),
                                   np.asarray(params_j[key]), rtol=1e-8,
                                   atol=1e-300)


@pytest.mark.parametrize("layout", [dict(pad_ranks=False),
                                    dict(pack_points=False)])
def test_mvnmf_scan_layouts_agree(X, layout):
    ranks = [2, 3, 5]
    padded = port.rank_scan_mvnmf(X, ranks, 3, rank_bucket=4,
                                  pack_points=True, **KWARGS)
    other = port.rank_scan_mvnmf(X, ranks, 3, rank_bucket=4, **layout,
                                 **KWARGS)
    assert_same_ranks(padded, other, exact="pad_ranks" not in layout)
    assert len({int(n) for k in padded for n in padded[k].n_iterations}) > 1


def test_mvnmf_scan_compact_equals_plain(X):
    plain = port.rank_scan_mvnmf(X, [2, 3], 4, compact=False, **KWARGS)
    packed = port.rank_scan_mvnmf(X, [2, 3], 4, compact=True,
                                  compact_min_bucket=2, **KWARGS)
    assert_same_ranks(plain, packed)


def test_mvnmf_scan_fed_shared_starts_matches_jax(X, monkeypatch):
    """rank_scan_mvnmf against the JAX package's, both fed the same numpy
    starts in place of their own draws: equal iterations, losses at 1e-9,
    signatures at 1e-7."""
    import jax.numpy as jnp

    from salamander_tpu.ops import klnmf as jax_klnmf
    from salamander_tpu.parallel import restarts as jax_restarts

    def starts(X, k, n_restarts):
        rng = np.random.default_rng(k)
        W = rng.uniform(0.1, 1.0, (n_restarts, X.shape[0], k))
        H = rng.uniform(0.5, 1.5, (n_restarts, k, X.shape[1]))
        return W / W.sum(1, keepdims=True), H * X.sum(0) / k

    def port_init(generator, X, k, n_restarts, padded):
        W, H = (torch.as_tensor(a) for a in starts(X.numpy(), k, n_restarts))
        W, H, mask = port_klnmf.pad_rank(W, H, padded)
        return W, H, mask.expand(n_restarts, padded)

    def jax_init(key, X, k, n_restarts, padded):
        W, H = (jnp.asarray(a) for a in starts(np.asarray(X), k, n_restarts))
        W, H, mask = jax_klnmf.pad_rank(W, H, padded)
        return W, H, jnp.broadcast_to(mask, (n_restarts, padded))

    monkeypatch.setattr(restarts, "_padded_random_init", port_init)
    monkeypatch.setattr(jax_restarts, "_padded_random_init", jax_init)
    got = port.rank_scan_mvnmf(X, [2, 3, 5], 3, **KWARGS)
    expected = jax_restarts.rank_scan_mvnmf(
        X, [2, 3, 5], 3, seed=11, config=JaxFitConfig(*CONFIG),
        dtype=jnp.float64)
    for k in (2, 3, 5):
        np.testing.assert_array_equal(got[k].n_iterations,
                                      np.asarray(expected[k].n_iterations))
        np.testing.assert_allclose(got[k].losses,
                                   np.asarray(expected[k].losses), rtol=1e-9)
        np.testing.assert_allclose(np.asarray(got[k].W),
                                   np.asarray(expected[k].W), rtol=1e-7,
                                   atol=1e-12)


def test_generic_rank_scan_is_fit_best_of_per_rank(X, tmp_path):
    frame = jax_datasets.load_pcawg_sbs().iloc[:N_SAMPLES]

    def factory(k):
        return port.MvNMF(n_signatures=k, init_method="random",
                          device="cpu", min_iterations=20,
                          max_iterations=100, tol=1e-4)

    results = port.rank_scan(factory, port.AnnData(frame.copy()), [2, 3], 3,
                             base_seed=5, checkpoint_dir=tmp_path)
    assert sorted(results) == [2, 3]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rank2", "rank3"]
    model = factory(3)
    summary = port.fit_best_of(model, port.AnnData(frame.copy()), 3,
                               base_seed=1005)
    np.testing.assert_array_equal(results[3][1].losses, summary.losses)
    np.testing.assert_array_equal(results[3][0].asignatures.X,
                                  model.asignatures.X)


@pytest.mark.parametrize("scan", ["rank_scan_klnmf", "rank_scan_mvnmf"])
def test_checkpointed_scan_resumes(X, tmp_path, monkeypatch, scan):
    run = getattr(port, scan)
    baseline = run(X, [2, 3], 3, **KWARGS)
    first = run(X, [2, 3], 3, checkpoint_dir=tmp_path, **KWARGS)
    assert_same_ranks(baseline, first)
    (tmp_path / "rank3.npz").unlink()  # killed before rank 3 was stored
    calls = []
    real = getattr(restarts, scan)

    def counting(X_, ranks, *args, **kwargs):
        calls.append(list(ranks))
        return real(X_, ranks, *args, **kwargs)

    monkeypatch.setattr(restarts, scan, counting)
    resumed = run(X, [2, 3], 3, checkpoint_dir=tmp_path, **KWARGS)
    assert calls == [[3]]
    assert_same_ranks(baseline, resumed)
    assert isinstance(resumed[2].W, np.ndarray)
    np.testing.assert_array_equal(resumed[2].best_W,
                                  baseline[2].best_W)


def test_kernel_routing_refuses_rank_masks():
    """A padded (rank-masked) block never takes the kernel, which has no
    mask; the routing says so before any launch."""
    from salamander_tpu_torch.ops import cuda_klnmf

    X = torch.ones(16, 20)
    W, H = torch.ones(2, 16, 4) / 16, torch.ones(2, 4, 20)
    mask = torch.ones(2, 4, dtype=torch.bool)
    assert "rank mask" in cuda_klnmf.unsupported_reason(X, W, H, mask=mask)
    assert not cuda_klnmf.mu_block_supported(X, W, H, mask=mask)


def test_pack_auto_policy():
    """Auto packs on a card (measured faster there) and, elsewhere, only
    fixed-length runs (the JAX package's rule)."""
    fixed = FitConfig(min_iterations=100, max_iterations=100)
    assert restarts._resolve_pack(None, CONFIG, "cuda")
    assert not restarts._resolve_pack(None, CONFIG, "cpu")
    assert restarts._resolve_pack(None, fixed, "cpu")
    assert not restarts._resolve_pack(False, fixed, "cuda")


def test_mesh_is_not_ported(X):
    # both scans take meshes now: an object that is not one is refused
    for run in (port.rank_scan_klnmf, port.rank_scan_mvnmf):
        with pytest.raises(TypeError, match="DeviceMesh"):
            run(X, [2], 2, mesh=object(), **KWARGS)
