"""The modules a benchmark process may not hold: JAX and the JAX package
are not measured, and the reference holds nothing of the port. Names are
compared by their top level, whole: salamander_tpu_torch is not
salamander_tpu."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "salamander_tpu"})
PROGRAM = "salamander_tpu_torch"


def top_levels(names) -> set[str]:
    return {name.split(".", 1)[0] for name in names}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted(top_levels(names) & set(forbidden))
