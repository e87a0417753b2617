"""salamander_tpu_torch: the PyTorch / CUDA port of salamander_tpu.

Mutational-signature NMF on PyTorch tensors, with the fused
multiplicative-update block as a hand-written CUDA kernel for Hopper. The
modules mirror salamander_tpu's paths, each held against the file of the
same name there; this package imports neither jax nor salamander_tpu.

Ported so far (the KLNMF slice): containers, datasets, the KLNMF ops and
kernel, the convergence engine, initialization, the KLNMF model and the
batched multi-start fit.
"""

from . import (  # noqa: F401
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
from .models import KLNMF  # noqa: F401
from .parallel import (  # noqa: F401
    RestartResult,
    build_klnmf_restart_runner,
    fit_klnmf_restarts,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "AnnData",
    "FitConfig",
    "KLNMF",
    "MuData",
    "RestartResult",
    "build_klnmf_restart_runner",
    "consts",
    "containers",
    "datasets",
    "engine",
    "fit_klnmf_restarts",
    "initialization",
    "models",
    "ops",
    "parallel",
    "utils",
]
