"""Model layer (L2): the public NMF model families ported so far."""

from .ardnmf import ARDNMF  # noqa: F401
from .corrnmf import CorrNMF  # noqa: F401
from .corrnmf_det import CorrNMFDet  # noqa: F401
from .klnmf import KLNMF  # noqa: F401
from .mvnmf import MvNMF  # noqa: F401

__all__ = ["ARDNMF", "CorrNMF", "CorrNMFDet", "KLNMF", "MvNMF"]
