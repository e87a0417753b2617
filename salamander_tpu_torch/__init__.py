"""salamander_tpu_torch: the PyTorch / CUDA port of salamander_tpu.

Mutational-signature NMF on PyTorch tensors, with the fused
multiplicative-update block as a hand-written CUDA kernel for Hopper. The
modules mirror salamander_tpu's paths, each held against the file of the
same name there; this package imports neither jax nor salamander_tpu.

Ported so far: containers, datasets (PCAWG, COSMIC), the KLNMF ops and
kernel, the convergence engine, initialization, the KLNMF, MvNMF, ARDNMF,
CorrNMFDet and MultimodalCorrNMF models, the batched multi-start fits (fit_best_of, lane
compaction, checkpointed chunks), the KLNMF/MvNMF rank scans, the padded
CorrNMF (k, m) scan, catalog assignment (dense, sparse, bootstrap), de
novo consensus extraction, bootstrap stability and the catalog
decomposition of signatures.
"""

from . import (  # noqa: F401
    assign,
    checkpoint,
    consts,
    containers,
    datasets,
    engine,
    extraction,
    initialization,
    io,
    models,
    ops,
    parallel,
    tools,
    utils,
)
from .assign import (  # noqa: F401
    AssignmentResult,
    BootstrapExposuresResult,
    assign_exposures,
    assign_signatures,
    bootstrap_exposures,
)
from .containers import AnnData, MuData  # noqa: F401
from .engine import FitConfig  # noqa: F401
from .extraction import ExtractionResult, extract_signatures  # noqa: F401
from .models import (  # noqa: F401
    ARDNMF,
    KLNMF,
    CorrNMFDet,
    MultimodalCorrNMF,
    MvNMF,
)
from .parallel import (  # noqa: F401
    BootstrapResult,
    CorrScanResult,
    MultiStartSummary,
    RestartResult,
    bootstrap_stability,
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
    "AssignmentResult",
    "BootstrapExposuresResult",
    "BootstrapResult",
    "CorrNMFDet",
    "CorrScanResult",
    "ExtractionResult",
    "FitConfig",
    "KLNMF",
    "MuData",
    "MultiStartSummary",
    "MultimodalCorrNMF",
    "MvNMF",
    "RestartResult",
    "assign",
    "assign_exposures",
    "assign_signatures",
    "bootstrap_exposures",
    "bootstrap_stability",
    "build_klnmf_restart_runner",
    "checkpoint",
    "consts",
    "containers",
    "datasets",
    "engine",
    "extract_signatures",
    "extraction",
    "fit_best_of",
    "fit_klnmf_restarts",
    "initialization",
    "io",
    "models",
    "ops",
    "parallel",
    "rank_scan",
    "rank_scan_corrnmf",
    "rank_scan_klnmf",
    "rank_scan_mvnmf",
    "tools",
    "utils",
]
