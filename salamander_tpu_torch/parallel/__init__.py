"""Scaling layer: batched multi-start fits (restart axis as a tensor axis)."""

from .restarts import (  # noqa: F401
    RestartResult,
    build_klnmf_restart_runner,
    fit_klnmf_restarts,
)
