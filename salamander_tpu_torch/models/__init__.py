"""Model layer (L2): the public NMF model families ported so far."""

from .klnmf import KLNMF  # noqa: F401
from .mvnmf import MvNMF  # noqa: F401

__all__ = ["KLNMF", "MvNMF"]
