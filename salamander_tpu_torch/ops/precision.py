"""Matmul precision policy of the PyTorch port (held against
salamander_tpu/ops/precision.py).

Multiplicative updates iterate ``aux = X / (W @ H)`` thousands of times, so
a matmul that rounds its inputs shifts the update's fixed points, and a
convergence test on a noisy objective stops at the wrong block. The JAX
package measured this on its accelerator: a one-pass bf16 float32 matmul
stopped the PCAWG SBS k=5 KLNMF fit at 1790 iterations with a wrong KL,
where full float32 stops at 4680 (salamander_tpu/ops/precision.py:11-16).

On Hopper the analogue of that bf16 pass is TF32 (10 mantissa bits). This
package therefore runs every float32 product in IEEE float32, the update
path and the decisions (objectives, convergence tests) alike. That is
PyTorch's default for matmuls - ``torch.backends.cuda.matmul.allow_tf32``
False and ``torch.get_float32_matmul_precision() == "highest"`` - and the
port REQUIRES it: :func:`require_ieee_float32` raises when a caller has
switched TF32 on, and the fits call it before they run on a card. The
hand-written kernels (ops/cuda_klnmf.py) use plain float32 FMAs and no
tensor cores.

``mm`` (bulk update path) and ``omm`` (decisions) are kept apart, as in the
JAX package, so that a faster tier for the update path can be chosen later
by measurement on the card without touching the decisions.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "omm", "require_ieee_float32"]


def mm(a, b):
    """Matmul of the bulk update path (IEEE float32 for float32 inputs)."""
    return torch.matmul(a, b)


def omm(a, b):
    """Matmul of decisions: objectives, convergence tests, acceptance."""
    return torch.matmul(a, b)


def require_ieee_float32() -> None:
    """Raise when PyTorch is set to round float32 matmuls to TF32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "salamander_tpu_torch needs IEEE float32 matmuls: TF32 shifts "
            "the multiplicative-update fixed points (see ops/precision.py). "
            "Set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')."
        )
