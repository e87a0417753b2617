"""salamander_tpu_torch: the PyTorch / CUDA port of salamander_tpu.

Mutational-signature NMF on PyTorch tensors, with the fused
multiplicative-update block as a hand-written CUDA kernel for Hopper. The
modules mirror salamander_tpu's paths, each held against the file of the
same name there; this package imports neither jax nor salamander_tpu.

Ported so far: containers, datasets, the KLNMF ops and kernel, the
convergence engine, initialization, the KLNMF, MvNMF, ARDNMF and
CorrNMFDet models, the batched multi-start fits (fit_best_of, lane
compaction, checkpointed chunks), the KLNMF/MvNMF rank scans and the
padded CorrNMF (k, m) scan.
"""

from . import (  # noqa: F401
    checkpoint,
    consts,
    containers,
    datasets,
    engine,
    initialization,
    models,
    ops,
    parallel,
    utils,
)
from .containers import AnnData, MuData  # noqa: F401
from .engine import FitConfig  # noqa: F401
from .models import ARDNMF, KLNMF, CorrNMFDet, MvNMF  # noqa: F401
from .parallel import (  # noqa: F401
    CorrScanResult,
    MultiStartSummary,
    RestartResult,
    build_klnmf_restart_runner,
    fit_best_of,
    fit_klnmf_restarts,
    rank_scan,
    rank_scan_corrnmf,
    rank_scan_klnmf,
    rank_scan_mvnmf,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "ARDNMF",
    "AnnData",
    "CorrNMFDet",
    "CorrScanResult",
    "FitConfig",
    "KLNMF",
    "MuData",
    "MultiStartSummary",
    "MvNMF",
    "RestartResult",
    "build_klnmf_restart_runner",
    "checkpoint",
    "consts",
    "containers",
    "datasets",
    "engine",
    "fit_best_of",
    "fit_klnmf_restarts",
    "initialization",
    "models",
    "ops",
    "parallel",
    "rank_scan",
    "rank_scan_corrnmf",
    "rank_scan_klnmf",
    "rank_scan_mvnmf",
    "utils",
]
