"""Numeric ops on tensors (layer L0): plain PyTorch functions batched over a
leading restart axis, and the hand-written CUDA kernel of the fused
multiplicative-update block (cuda_klnmf, built at first use)."""

from . import cuda_klnmf, klnmf, mvnmf, precision  # noqa: F401
from .klnmf import EPSILON  # noqa: F401
