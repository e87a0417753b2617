"""Batched multi-start KLNMF fits, held against
salamander_tpu/parallel/restarts.py.

All restarts of one rank advance together: the batched init draws on the
device, every lane steps in lockstep blocks of the convergence engine
(finished lanes frozen), and only the loss table returns to the host. On a
card a float32, unweighted fit runs each block as one launch of the fused
CUDA kernel over all lanes (ops/cuda_klnmf.py).

Not ported yet: lane compaction (compact=True), meshes (mesh=) and the
rank scans.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..engine import FitConfig, fit_loop_lockstep
from ..initialization.methods import random_init_batch
from ..ops import cuda_klnmf
from ..ops import klnmf as ops
from ..ops.precision import require_ieee_float32


class RestartResult(NamedTuple):
    """Outcome of a batched multi-start fit.

    W and H stay on the device; losses/n_iterations are host arrays."""

    W: Any            # (R, V, K) signatures per restart
    H: Any            # (R, K, D) exposures per restart
    losses: Any       # (R,) final objective per restart
    n_iterations: Any # (R,) iterations run per restart
    best_index: int

    @property
    def best_loss(self) -> float:
        return float(self.losses[self.best_index])

    @property
    def best_W(self) -> np.ndarray:
        return self.W[self.best_index].cpu().numpy()

    @property
    def best_H(self) -> np.ndarray:
        return self.H[self.best_index].cpu().numpy()


def build_klnmf_restart_runner(config: FitConfig):
    """The batched multi-start KLNMF fit.

    Returns a function (params0, data) -> (params, losses, n_iterations)
    where params0 = {"W": (R, V, K), "H": (R, K, D)} and data = {"X": (V, D)}
    plus any 'weights_kl'/'weights_lhalf' entries. The block update is
    chosen per call from the tensors (cuda_klnmf.mu_block_supported).
    """
    update_fn, objective_fn = ops.make_step_functions()

    def run(params0, data):
        if cuda_klnmf.mu_block_supported(data["X"], params0["W"],
                                         params0["H"], data):
            def block(params, n_steps):
                return cuda_klnmf.fused_block_update(params, data, n_steps)
        else:
            def block(params, n_steps):
                for _ in range(n_steps):
                    params = update_fn(params, data)
                return params

        def objective(params):
            return objective_fn(params, data)

        result = fit_loop_lockstep(objective, params0, config, block)
        final_loss = objective(result.params)
        return result.params, final_loss, result.n_iterations

    return run


def fit_klnmf_restarts(
    X,
    n_signatures: int,
    n_restarts: int,
    seed: int = 0,
    config: FitConfig | None = None,
    weights_kl=None,
    weights_lhalf=None,
    mesh=None,
    dtype=torch.float32,
    device=None,
    runner=None,
    compact: bool | None = None,
) -> RestartResult:
    """Fit `n_restarts` random-initialized KLNMF models at once.

    X is (n_features, n_samples) in kernel orientation. device=None means
    the first CUDA device when one is available, else the CPU. The initial
    draws come from a torch.Generator seeded with `seed` on that device.
    Pass a prebuilt `runner` (build_klnmf_restart_runner) to reuse one
    across calls. compact=None resolves to no lane compaction;
    compact=True and mesh= are not ported yet.
    """
    if compact:
        raise NotImplementedError("lane compaction is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported to PyTorch yet")
    config = config or FitConfig()
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        require_ieee_float32()
    X = torch.as_tensor(np.ascontiguousarray(X), dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    W0, H0 = random_init_batch(generator, X, n_signatures, n_restarts, dtype)

    data = {"X": X}
    if weights_kl is not None:
        data["weights_kl"] = torch.as_tensor(np.asarray(weights_kl),
                                             dtype=dtype, device=device)
    if weights_lhalf is not None:
        data["weights_lhalf"] = torch.as_tensor(np.asarray(weights_lhalf),
                                                dtype=dtype, device=device)

    if runner is None:
        runner = build_klnmf_restart_runner(config)
    params, losses, n_iterations = runner({"W": W0, "H": H0}, data)
    losses_host = losses.cpu().numpy()
    return RestartResult(
        W=params["W"],
        H=params["H"],
        losses=losses_host,
        n_iterations=n_iterations.cpu().numpy(),
        best_index=int(np.argmin(losses_host)),
    )
