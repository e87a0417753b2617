"""salamander_tpu_torch: the PyTorch / CUDA port of salamander_tpu.

Mutational-signature NMF on PyTorch tensors, with the fused
multiplicative-update block as a hand-written CUDA kernel for Hopper. The
modules mirror salamander_tpu's paths, each held against the file of the
same name there; this package imports neither jax nor salamander_tpu.

Ported: containers, datasets (PCAWG, COSMIC, HRDetect), the KLNMF ops
and kernel, the convergence engine, initialization, the KLNMF, MvNMF,
ARDNMF, CorrNMFDet and MultimodalCorrNMF models, the batched multi-start
fits (fit_best_of, lane compaction, checkpointed chunks), the KLNMF/MvNMF
rank scans, the padded CorrNMF (k, m) scan, minibatch fitting and host
streaming, catalog assignment (dense, sparse, bootstrap), de novo
consensus extraction, bootstrap stability, the analysis tools (`tl`), the
plots (`pl`, when matplotlib and seaborn are installed), model and
extraction checkpoints (`io`), profiling and the command line
(``python -m salamander_tpu_torch``), and (restarts, samples) meshes over
torch.distributed (`make_mesh`, `init_distributed`: one process per card)
for the KLNMF fits and the restart axis of every multi-start fit.
"""

from . import (  # noqa: F401
    assign,
    checkpoint,
    cli,
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
    profiling,
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
from .io import (  # noqa: F401
    load_extraction,
    load_model,
    save_extraction,
    save_model,
)
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
    hybrid_mesh_shape,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    rank_scan,
    rank_scan_corrnmf,
    rank_scan_klnmf,
    rank_scan_mvnmf,
    restart_sharding,
    slice_groups,
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
    "cli",
    "consts",
    "containers",
    "datasets",
    "engine",
    "extract_signatures",
    "extraction",
    "fit_best_of",
    "fit_klnmf_restarts",
    "hybrid_mesh_shape",
    "init_distributed",
    "initialization",
    "io",
    "load_extraction",
    "load_model",
    "make_hybrid_mesh",
    "make_mesh",
    "models",
    "ops",
    "parallel",
    "profiling",
    "rank_scan",
    "rank_scan_corrnmf",
    "rank_scan_klnmf",
    "rank_scan_mvnmf",
    "restart_sharding",
    "save_extraction",
    "save_model",
    "slice_groups",
    "tl",
    "tools",
    "utils",
]

tl = tools

try:  # plotting style applied on import, as in the JAX package's facade;
    # matplotlib and seaborn are optional (the card's machine may lack them)
    from . import plot as pl  # noqa: F401

    pl.set_salamander_style()
    __all__.append("pl")
except ImportError:
    pass
