"""Stability-based rank selection of salamander_tpu_torch
(tools.signature_stability / rank_selection_table / suggest_rank),
mirroring tests/test_rank_selection.py on the port's own scans (CPU,
float64), and held against the JAX package on shared numpy stacks: the
same (R, V, K) stacks go into a JAX RestartResult and a port RestartResult
whose W is a torch tensor (the device-tensor path), and the stabilities
and tables agree at rtol 1e-12, the suggestions exactly."""

import numpy as np
import pandas as pd
import pytest
import torch

from salamander_tpu import tl as jax_tl
from salamander_tpu.parallel.corrnmf_scan import (
    CorrScanResult as JaxCorrScanResult,
)
from salamander_tpu.parallel.restarts import RestartResult as JaxRestartResult
from salamander_tpu_torch import tl
from salamander_tpu_torch.engine import FitConfig
from salamander_tpu_torch.parallel import rank_scan_klnmf
from salamander_tpu_torch.parallel.corrnmf_scan import CorrScanResult
from salamander_tpu_torch.parallel.restarts import RestartResult

RTOL = 1e-12


def _random_signatures(rng, V, k):
    W = rng.dirichlet(np.ones(V) * 0.3, size=k).T
    return W / W.sum(axis=0)


def test_stability_permutation_and_scale_invariant():
    rng = np.random.default_rng(1)
    V, k, R = 12, 4, 6
    W = _random_signatures(rng, V, k)
    stack = []
    for r in range(R):
        perm = rng.permutation(k)
        scales = rng.uniform(0.5, 2.0, size=k)
        stack.append(W[:, perm] * scales)
    per_sig, matched = tl.signature_stability(np.stack(stack))
    np.testing.assert_allclose(per_sig, 1.0, atol=1e-12)
    np.testing.assert_allclose(matched, 1.0, atol=1e-12)


def test_stability_detects_noise_component():
    rng = np.random.default_rng(2)
    V, k, R = 24, 3, 8
    W = _random_signatures(rng, V, k)
    stack = []
    for r in range(R):
        noisy = W.copy()
        # the last column is restart-specific noise; the others reproduce
        noisy[:, -1] = rng.dirichlet(np.ones(V))
        stack.append(noisy)
    per_sig, _ = tl.signature_stability(np.stack(stack))
    assert np.all(per_sig[:-1] > 0.999)
    assert per_sig[-1] < 0.9


def test_stability_single_restart_is_nan():
    rng = np.random.default_rng(3)
    per_sig, matched = tl.signature_stability(
        _random_signatures(rng, 10, 2)[None]
    )
    assert np.isnan(per_sig).all()
    np.testing.assert_array_equal(matched, 1.0)


def test_stability_rejects_2d():
    with pytest.raises(ValueError, match="n_restarts"):
        tl.signature_stability(np.ones((4, 3)))


@pytest.fixture(scope="module")
def planted_scan():
    rng = np.random.default_rng(0)
    V, D, k_true = 24, 150, 3
    W = rng.dirichlet(np.ones(V) * 0.3, size=k_true).T
    H = rng.gamma(2.0, 120.0, size=(k_true, D))
    X = rng.poisson(W @ H).astype(np.float64) + 1e-9
    cfg = FitConfig(min_iterations=100, max_iterations=2000,
                    conv_test_freq=10, tol=1e-6)
    return rank_scan_klnmf(X, range(2, 6), 8, seed=0, config=cfg,
                           dtype=torch.float64, device="cpu")


def test_rank_selection_table_shape_and_loss(planted_scan):
    table = tl.rank_selection_table(planted_scan)
    assert list(table.index) == [2, 3, 4, 5]
    # more parameters always fit better: best_loss strictly decreases,
    # which is exactly why loss alone cannot pick the rank
    assert np.all(np.diff(table["best_loss"].to_numpy()) < 0)
    assert np.isnan(table["loss_improvement"].iloc[0])
    assert table["loss_improvement"].iloc[1] > table["loss_improvement"].iloc[2]
    # the planted rank is the stability optimum
    assert table["min_stability"].idxmax() == 3


def test_suggest_rank_recovers_planted_truth(planted_scan):
    assert tl.suggest_rank(planted_scan) == 3


def test_suggest_rank_raises_when_first_rank_unstable(planted_scan):
    with pytest.raises(ValueError, match="smallest scanned rank"):
        tl.suggest_rank(planted_scan, min_stability=0.9999)


def test_rank_selection_corrnmf_scan():
    """CorrScanResult flavor: the scan exposes every restart's signature
    matrix, rank_selection_table handles ELBO maximization (positive
    loss_improvement still means 'fits better'), and suggest_rank works
    on scalar-keyed CorrNMF scans."""
    from salamander_tpu_torch.parallel import rank_scan_corrnmf

    rng = np.random.default_rng(5)
    V, D, k_true = 16, 60, 2
    W = rng.dirichlet(np.ones(V) * 0.3, size=k_true).T
    H = rng.gamma(2.0, 60.0, size=(k_true, D))
    X = rng.poisson(W @ H).astype(np.float64).T + 1e-9  # (D, V) samples-rows

    cfg = FitConfig(min_iterations=30, max_iterations=200,
                    conv_test_freq=10, tol=1e-5)
    res = rank_scan_corrnmf(X, range(2, 4), dim_embeddings=2, n_restarts=4,
                            base_seed=0, config=cfg, build_models=False,
                            device="cpu")

    for k, point in res.items():
        assert point.signatures.shape == (4, V, k)  # same orientation as W
    table = tl.rank_selection_table(res)
    assert list(table.index) == [2, 3]
    # ELBO is maximized: best_loss must increase with rank, and the
    # improvement column must still read positive
    assert table["best_loss"].iloc[1] > table["best_loss"].iloc[0]
    assert table["loss_improvement"].iloc[1] > 0
    assert ((table["min_stability"] >= -1)
            & (table["min_stability"] <= 1 + 1e-12)).all()
    assert tl.suggest_rank(res, min_stability=0.0) in (2, 3)

    # (k, m) grid keys: the rule runs per m and returns {m: suggested_k}
    grid = {(2, 2): res[2], (3, 2): res[3], (2, 3): res[2]}
    per_m = tl.suggest_rank(grid, min_stability=0.0)
    assert set(per_m) == {2, 3}
    assert per_m[2] in (2, 3) and per_m[3] == 2

    with pytest.raises(ValueError, match="takes"):
        tl.suggest_rank({"not-a-key": res[2]})


def test_plot_rank_selection_smoke(planted_scan):
    import matplotlib

    matplotlib.use("Agg")
    from salamander_tpu_torch import pl

    table = tl.rank_selection_table(planted_scan)
    ax = pl.rank_selection(table)
    assert ax.get_xlabel() == "n_signatures"
    # twin axis carries the stability curves
    assert len(ax.figure.axes) == 2
    import matplotlib.pyplot as plt

    plt.close(ax.figure)


def test_grid_table_multiindex_and_per_m_improvement(planted_scan):
    """(k, m) grid tables use a (n_signatures, dim_embeddings) MultiIndex
    and chain loss_improvement within each m only."""
    grid = {(2, 2): planted_scan[2], (3, 2): planted_scan[3],
            (2, 3): planted_scan[2], (3, 3): planted_scan[3]}
    table = tl.rank_selection_table(grid)
    assert list(table.index.names) == ["n_signatures", "dim_embeddings"]
    for m in (2, 3):
        part = table.xs(m, level="dim_embeddings")
        assert np.isnan(part["loss_improvement"].iloc[0])  # first k of each m
        assert part["loss_improvement"].iloc[1] > 0

    from salamander_tpu_torch import pl

    with pytest.raises(ValueError, match="one embedding dimension"):
        pl.rank_selection(table)


def test_table_zero_previous_loss_is_nan():
    """A rank whose predecessor reached best_loss == 0 (exact
    reconstruction) reports NaN improvement instead of crashing."""
    rng = np.random.default_rng(9)

    def point(k, losses):
        W = np.stack([rng.dirichlet(np.ones(10), size=k).T for _ in range(3)])
        return RestartResult(W=torch.as_tensor(W), H=None,
                             losses=np.asarray(losses),
                             n_iterations=np.ones(3, int), best_index=0)

    table = tl.rank_selection_table(
        {2: point(2, [0.0, 1.0, 2.0]), 3: point(3, [5.0, 6.0, 7.0])}
    )
    assert table["best_loss"].iloc[0] == 0.0
    assert np.isnan(table["loss_improvement"].iloc[1])


def test_suggest_rank_single_restart_diagnosis():
    rng = np.random.default_rng(11)
    W = rng.dirichlet(np.ones(10), size=2).T[None]  # one restart
    res = RestartResult(W=torch.as_tensor(W), H=None,
                        losses=np.asarray([1.0]),
                        n_iterations=np.ones(1, int), best_index=0)
    with pytest.raises(ValueError, match="n_restarts >= 2"):
        tl.suggest_rank({2: res})


def test_multistart_summary_signature_stack():
    """fit_best_of exposes every restart's signatures as (R, V, K) for all
    families ({mod: stack} for multimodal), feeding signature_stability
    without a rank scan."""
    from salamander_tpu_torch.containers import AnnData, MuData
    from salamander_tpu_torch.models import (
        KLNMF,
        CorrNMFDet,
        MultimodalCorrNMF,
    )
    from salamander_tpu_torch.parallel import fit_best_of

    rng = np.random.default_rng(4)
    V, D, k = 12, 40, 3
    W = rng.dirichlet(np.ones(V) * 0.4, size=k).T
    H = rng.gamma(2.0, 50.0, size=(k, D))
    X = rng.poisson(W @ H).astype(np.float64).T + 1e-9  # samples as rows

    klnmf = KLNMF(n_signatures=k, init_method="random", min_iterations=10,
                  max_iterations=100, conv_test_freq=10, tol=1e-5,
                  device="cpu")
    summary = fit_best_of(klnmf, AnnData(X.copy()), 4, base_seed=0)
    assert summary.signatures.shape == (4, V, k)
    per_sig, _ = tl.signature_stability(summary.signatures,
                                        summary.best_index)
    assert per_sig.shape == (k,)
    assert np.all((per_sig >= -1) & (per_sig <= 1 + 1e-12))
    # the best lane's stack column matches the fitted model's signatures
    np.testing.assert_allclose(
        np.asarray(summary.signatures[summary.best_index]).T,
        klnmf.signatures.values, rtol=1e-6)

    corr = CorrNMFDet(n_signatures=2, dim_embeddings=2, init_method="random",
                      min_iterations=10, max_iterations=60,
                      conv_test_freq=10, tol=1e-5, device="cpu")
    summary = fit_best_of(corr, AnnData(X.copy()), 3, base_seed=0)
    assert summary.signatures.shape == (3, V, 2)

    mm = MultimodalCorrNMF(ns_signatures=[2, 2], dim_embeddings=2,
                           init_method="random", min_iterations=10,
                           max_iterations=60, conv_test_freq=10, tol=1e-5,
                           device="cpu")
    mdata = MuData({"a": AnnData(X.copy()), "b": AnnData(X.copy())})
    summary = fit_best_of(mm, mdata, 3, base_seed=0)
    assert set(summary.signatures) == {"a", "b"}
    assert summary.signatures["a"].shape == (3, V, 2)


# ---------------------------------------------------------------------- #
# against the JAX package on shared numpy stacks
# ---------------------------------------------------------------------- #

def _stack(rng, R, V, k, noisy_columns):
    """R restarts of k signatures, the last `noisy_columns` redrawn in
    every restart, the rest permuted and rescaled copies."""
    W = _random_signatures(rng, V, k)
    stack = []
    for _ in range(R):
        lane = W[:, rng.permutation(k)] * rng.uniform(0.5, 2.0, size=k)
        for j in range(k - noisy_columns, k):
            lane[:, j] = rng.dirichlet(np.ones(V))
        stack.append(lane)
    return np.stack(stack)


def _scan_points(seed, ranks=(2, 3, 4, 5), R=6, V=16):
    """{k: (W stack, losses, best_index)}: stable up to k=3, then one
    noise column a rank more."""
    rng = np.random.default_rng(seed)
    points = {}
    for k in ranks:
        losses = rng.uniform(100.0, 110.0, size=R) - 10.0 * k
        points[k] = (_stack(rng, R, V, k, max(0, k - 3)), losses,
                     int(np.argmin(losses)))
    return points


def _restart_results(points):
    jax = {k: JaxRestartResult(W=W, H=None, losses=losses,
                               n_iterations=np.ones(len(losses), int),
                               best_index=best)
           for k, (W, losses, best) in points.items()}
    port = {k: RestartResult(W=torch.as_tensor(W), H=None, losses=losses,
                             n_iterations=np.ones(len(losses), int),
                             best_index=best)
            for k, (W, losses, best) in points.items()}
    return jax, port


def _corr_results(points):
    def fields(W, losses):
        elbo = -losses
        return dict(losses=elbo, n_iterations=np.ones(len(elbo), int),
                    best_index=int(np.argmax(elbo)), best_params={},
                    signatures=W)

    jax = {k: JaxCorrScanResult(**fields(W, losses))
           for k, (W, losses, _) in points.items()}
    port = {k: CorrScanResult(**fields(W, losses))
            for k, (W, losses, _) in points.items()}
    return jax, port


def assert_tables_equal(table, expected):
    assert list(table.columns) == list(expected.columns)
    pd.testing.assert_index_equal(table.index, expected.index)
    np.testing.assert_allclose(table.to_numpy(), expected.to_numpy(),
                               rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signature_stability_matches_jax(seed):
    W, _, best = _scan_points(seed)[5]
    per_sig, matched = tl.signature_stability(torch.as_tensor(W), best)
    jax_per_sig, jax_matched = jax_tl.signature_stability(W, best)
    np.testing.assert_allclose(per_sig, jax_per_sig, rtol=RTOL)
    np.testing.assert_allclose(matched, jax_matched, rtol=RTOL)


@pytest.mark.parametrize("kind", ["restarts", "corrnmf"])
def test_tables_and_suggestions_match_jax(kind):
    points = _scan_points(7)
    jax, port = (_restart_results if kind == "restarts"
                 else _corr_results)(points)
    assert_tables_equal(tl.rank_selection_table(port),
                        jax_tl.rank_selection_table(jax))
    for threshold in (0.0, 0.9, 0.99):
        assert tl.suggest_rank(port, threshold) == \
            jax_tl.suggest_rank(jax, threshold)
    with pytest.raises(ValueError) as port_error:
        tl.suggest_rank(port, 1.5)
    with pytest.raises(ValueError) as jax_error:
        jax_tl.suggest_rank(jax, 1.5)
    assert str(port_error.value) == str(jax_error.value)


def test_grid_tables_and_suggestions_match_jax():
    """A (k, m) CorrScanResult grid: the MultiIndex table and the
    per-m suggestions equal the JAX package's."""
    jax_points, port_points = {}, {}
    for m, seed in ((2, 3), (3, 4)):
        jax, port = _corr_results(_scan_points(seed, ranks=(2, 3, 4)))
        jax_points.update({(k, m): r for k, r in jax.items()})
        port_points.update({(k, m): r for k, r in port.items()})
    assert_tables_equal(tl.rank_selection_table(port_points),
                        jax_tl.rank_selection_table(jax_points))
    for threshold in (0.0, 0.9):
        assert tl.suggest_rank(port_points, threshold) == \
            jax_tl.suggest_rank(jax_points, threshold)
