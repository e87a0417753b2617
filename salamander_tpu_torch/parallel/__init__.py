"""Scaling layer: batched multi-start fits (restart axis as a tensor axis),
lane compaction, rank scans and bootstrap stability."""

from .bootstrap import BootstrapResult, bootstrap_stability  # noqa: F401
from .compaction import CompactingRunner, resolve_compact  # noqa: F401
from .corrnmf_scan import CorrScanResult, rank_scan_corrnmf  # noqa: F401
from .multistart import MultiStartSummary, fit_best_of  # noqa: F401
from .restarts import (  # noqa: F401
    RestartResult,
    build_klnmf_masked_runner,
    build_klnmf_restart_runner,
    fit_klnmf_restarts,
    rank_scan,
    rank_scan_klnmf,
    rank_scan_mvnmf,
)
