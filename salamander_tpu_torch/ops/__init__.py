"""Numeric ops on tensors (layer L0): plain PyTorch functions batched over a
leading restart axis, and the hand-written CUDA kernel of the fused
multiplicative-update block (cuda_klnmf, built at first use)."""

from . import (  # noqa: F401
    ardnmf,
    corrnmf,
    cuda_klnmf,
    klnmf,
    mvnmf,
    precision,
    svi,
)
from .klnmf import EPSILON  # noqa: F401
