"""Tests that need an NVIDIA GPU: the port's CUDA kernel against its plain
PyTorch version. They skip without a card.

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


def assert_kernel_close(actual, expected):
    """rtol 2e-4 (float32 sums in another order, amplified over the steps;
    the JAX package's on-chip check uses the same), with an absolute floor
    of 1e-6 of the tensor's largest entry for entries at the eps clip."""
    atol = 1e-6 * float(expected.abs().max())
    torch.testing.assert_close(actual, expected, rtol=2e-4, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("V, K, D, R", [
    (96, 5, 192, 100),   # PCAWG SBS headline shape
    (96, 5, 192, 1),
    (83, 5, 192, 4),     # indel channels
    (32, 5, 192, 4),     # SV channels
    (96, 1, 192, 4),
    (96, 20, 192, 4),
    (96, 5, 100, 4),     # D not a multiple of the tile
])
def test_kernel_matches_plain_on_card(cuda_device, V, K, D, R):
    X, W, H = (torch.from_numpy(a).to(cuda_device)
               for a in make_problem(V, K, D, R, seed=V + K + D + R))
    for steps in (1, 7, 10, 3):
        before = cuda_klnmf.fused_mu_block.launches
        W_k, H_k = cuda_klnmf.fused_mu_block(X, W, H, steps)
        torch.cuda.synchronize()
        assert cuda_klnmf.fused_mu_block.launches == before + 1
        W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
        assert_kernel_close(W_k, W_r)
        assert_kernel_close(H_k, H_r)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    X, W, H = (torch.from_numpy(a).to(cuda_device)
               for a in make_problem(16, 3, 20, 2))
    with pytest.raises(ValueError, match="float32"):
        cuda_klnmf.fused_mu_block(X.double(), W.double(), H.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_klnmf.fused_mu_block(X, W.transpose(1, 2).contiguous()
                                  .transpose(1, 2), H, 2)
