"""The fit engine: the shared convergence loop, its state on the device,
driven span by span (CUDA graphs for a capturable block)."""

from .fit import (  # noqa: F401
    FitConfig,
    FitResult,
    LockstepState,
    effective_tolerance,
    finish_lockstep,
    fit_loop,
    fit_loop_lockstep,
    graph_counts,
    init_lockstep_state,
    make_fit_function,
    run_lockstep_segment,
    shared_span_pool,
    tolerance_floor,
)
from .transfer import (  # noqa: F401
    params_from_numpy,
    params_to_numpy,
    svi_state_from_numpy,
    svi_state_to_numpy,
)
