"""The plain reference on hand-made cases."""

import numpy as np
import pytest
import torch

from portbench.reference import assign, extraction, klnmf


def test_kl_known_value():
    X = torch.tensor([[2.0, 0.0]], dtype=torch.float64)
    W = torch.tensor([[1.0]], dtype=torch.float64)
    H = torch.tensor([[1.0, 3.0]], dtype=torch.float64)
    # 2 ln 2 - 2 + 1, and the zero count contributes its WH = 3
    assert float(klnmf.kl(X, W, H)) == pytest.approx(2 * np.log(2) - 1 + 3)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-11],
                     dtype=torch.float32)
    got = klnmf.round_tf32(x).tolist()
    # kept, kept, ties-to-even down, ties-to-even up
    assert got == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9]


def test_mu_steps_lower_the_loss_and_keep_columns_stochastic():
    gen = torch.Generator().manual_seed(0)
    X = torch.rand((12, 30), generator=gen, dtype=torch.float64) * 10
    W0, H0 = klnmf.restart_init(X.float(), 3, 4, 1)
    W, H, losses, iterations = klnmf.fit_lanes(
        X, W0, H0, 100, 100, 10, 1e-7, klnmf.FLOAT64)
    start = klnmf.kl(X, W0.double(), H0.double()).numpy()
    assert np.all(losses < start)
    assert torch.allclose(W.sum(1), torch.ones(4, 3, dtype=torch.float64))
    assert list(iterations) == [100] * 4


def test_converged_lanes_stop():
    gen = torch.Generator().manual_seed(1)
    X = torch.rand((6, 8), generator=gen, dtype=torch.float64) * 10
    W0, H0 = klnmf.restart_init(X.float(), 2, 3, 5)
    W, H, losses, _ = klnmf.fit_lanes(X, W0, H0, 3000, 3000, 10, 0.0,
                                      klnmf.FLOAT64)
    # from a converged state the first tested block stops every lane
    _, _, again, iterations = klnmf.fit_lanes(X, W, H, 20, 1000, 10, 1e-6,
                                              klnmf.FLOAT64)
    assert list(iterations) == [20, 20, 20]
    assert np.allclose(again, losses, rtol=1e-6)


def test_multinomial_resamples_keep_totals():
    X = torch.tensor([[5.0, 1.0], [3.0, 0.0], [2.0, 9.0]])
    gen = torch.Generator().manual_seed(3)
    draws = extraction.multinomial_resamples(X, gen, 4)
    assert draws.shape == (4, 3, 2)
    assert torch.equal(draws.sum(1), X.double().sum(0).expand(4, 2))
    assert torch.all(draws[:, 1, 1] == 0)


def test_clustering_recovers_permuted_signatures():
    rng = np.random.default_rng(0)
    truth = rng.dirichlet(np.ones(20), size=3)
    stack = np.stack([truth[rng.permutation(3)] for _ in range(5)])
    consensus, matched = extraction.consensus_cluster(stack, 0)
    assert np.allclose(np.sort(consensus, axis=0), np.sort(truth, axis=0))
    assert np.allclose(extraction.silhouettes(matched), 1.0)


def test_suggest_rank_largest_stable():
    assert extraction.suggest_rank([2, 3, 4], [0.9, 0.5, 0.85]) == 4
    assert extraction.suggest_rank([2, 3], [0.1, 0.2]) is None


def test_elimination_keeps_only_what_the_counts_need():
    W = np.array([[0.7, 0.1], [0.2, 0.1], [0.1, 0.8]])
    X = np.outer(W[:, 0], [100.0, 200.0, 50.0])  # signature 0 alone
    out = assign.eliminate(X, W, 0.02)
    assert out["mask"][:, :].sum(0).tolist() == [1, 1, 1]
    assert out["mask"][0].all()
    assert np.all(out["kl_sparse"] <= 1.02 * out["kl_dense"] + 1e-12)
