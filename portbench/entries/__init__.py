"""The job kinds a traffic mix names. Each module gives

- ``prepare(config, traffic, seed, device)``: the cell's inputs, made from
  the seed, on the device;
- ``warm(state)``: one small job on the cell's own path (its shapes, its
  kernels, its graph captures);
- ``job(state, seed)``: one whole job through the port's public entry,
  results on the host: a record with ``work`` (what it did, counted from
  its results), ``counters`` (the program's counters, read around it) and
  ``output`` (what the check compares);
- ``check(state, records, seed, arith)``: the sampled outputs against the
  plain reference, as [(name, value)] pairs that the cell's limits judge.
"""

from __future__ import annotations


def program_counters() -> dict:
    """The port's own counters: kernel launches (graph replays counted)
    and CUDA graphs captured and replayed."""
    from salamander_tpu_torch.engine import graph_counts
    from salamander_tpu_torch.ops.cuda_klnmf import fused_mu_block

    return {"launches": fused_mu_block.launches,
            "captures": graph_counts["captures"],
            "replays": graph_counts["replays"]}


def counted(fn):
    """fn()'s result and the change in program_counters() over it."""
    before = program_counters()
    out = fn()
    after = program_counters()
    return out, {key: after[key] - before[key] for key in after}


def rel_gap(a, b) -> float:
    """|a - b| / |b| at its worst over the elements."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def sampled(records, seed: int, n: int):
    """n finished records drawn from the seed (all of them if fewer)."""
    import numpy as np

    done = [record for record in records if not record["failed"]]
    if len(done) <= n:
        return done
    rng = np.random.default_rng(int(seed))
    picks = sorted(rng.choice(len(done), size=n, replace=False))
    return [done[i] for i in picks]
