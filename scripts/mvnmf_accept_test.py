#!/usr/bin/env python3
"""Time MvNMF de novo extraction at pan-cancer scale and read the line
search's float32 accept test against float64, on one NVIDIA GPU.

    python3 scripts/mvnmf_accept_test.py [--seed N] [--max-iterations N]
        [--shadow-max-iterations N] [--scan] [--scan-max-iterations N]
        [--out FILE]

The cohort is portbench's ``pancancer_sbs_20k_breast`` configuration
(96 x 20,000, the planted breast mix) drawn from --seed, and the job the
benchmark's MvNMF cell runs: ``extract_signatures(cohort, range(2, 11),
n_bootstraps=10, model="mvnmf", lam=1, delta=1, float32)`` at min 500,
every 10, tol 1e-7 and --max-iterations.

1. ``job``: one job, timed to completion, with the program's counters
   (search rounds, lane trials) and the lanes' iterations.
2. ``shadow``: the same job again at --shadow-max-iterations with the
   masked line search replaced by a copy that decides by whole float32
   objectives (a trial worse than the start where its objective is
   larger: the test before the port's term-by-term one, and the JAX
   package's) and, for every trial of a searching lane, also evaluates
   the trial and the objective it starts from in float64 from the same
   float32 factors: the trials per lane-step, the share of searches that
   end at GAMMA_FLOOR with the trial still worse, and how often the
   whole float32 test disagrees with the float64 test of the same trial,
   by stretch of iterations.
3. with --scan, ``rank_scan``: ``rank_scan_klnmf(X, range(2, 21), 20)`` on
   ``pancancer_sbs_20k``'s cohort at the port's defaults but
   --scan-max-iterations, timed.

One JSON line a part, on standard output and appended to --out. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STRETCHES = (0, 500, 1000, 2000, 5000, 10**9)  # iterations of the batch


def emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as handle:
            handle.write(line + "\n")


def cohort(name: str, seed: int):
    from portbench import inputs

    path = ROOT / "portbench" / "configs" / f"{name}.json"
    return inputs.counts(json.loads(path.read_text()), seed, ROOT)


def extract(X, seed, max_iterations, device):
    from salamander_tpu_torch import extract_signatures

    return extract_signatures(
        X, range(2, 11), n_bootstraps=10, model="mvnmf", lam=1.0, delta=1.0,
        seed=seed, min_iterations=500, max_iterations=max_iterations,
        conv_test_freq=10, tol=1e-7, dtype="float32", device=device)


def counters():
    from salamander_tpu_torch import profiling

    return dict(profiling.counters)


def delta(after, before):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after
            if after.get(k, 0) != before.get(k, 0)}


class Shadow:
    """The masked line search by whole float32 objectives, every trial's
    test held against float64's (module docstring, part 2)."""

    def __init__(self):
        self.calls = 0
        self.stats = [dict(lane_steps=0, trials=0, rounds=0, searches=0,
                           floor_stops=0, disagree=0, false_worse=0,
                           false_better=0, ties32=0)
                      for _ in STRETCHES[:-1]]

    def bucket(self):
        for i, hi in enumerate(STRETCHES[1:]):
            if self.calls < hi:
                return self.stats[i]
        return self.stats[-1]

    def __call__(self, X, W, H, lam, delta, gamma, W_unconstrained, mask,
                 reduce_samples=None, prev_objective=None, start_product=None):
        import torch

        from salamander_tpu_torch.ops import mvnmf as mv

        stats = self.bucket()
        self.calls += 1
        gamma = mv._as_gamma(gamma, W)
        if prev_objective is None:
            prev_objective = mv.kl_divergence_penalized_masked(
                X, W, H, lam, delta, mask)
        X64 = X.double()
        prev64 = mv.kl_divergence_penalized_masked(
            X64, W.double(), H.double(), lam, delta, mask)

        def renormalize(W_trial):
            return mv._renormalized_objective_masked(X, W_trial, H, lam,
                                                     delta, mask)

        def read(searching, of32, W_t, H_t):
            of64 = mv.kl_divergence_penalized_masked(
                X64, W_t.double(), H_t.double(), lam, delta, mask)
            worse32 = of32 > prev_objective
            worse64 = of64 > prev64
            return torch.stack((
                searching.sum(),
                (searching & (worse32 != worse64)).sum(),
                (searching & worse32 & ~worse64).sum(),
                (searching & ~worse32 & worse64).sum(),
                (searching & (of32 == prev_objective)).sum())).tolist()

        lanes = W.shape[0]
        stats["lane_steps"] += lanes
        stats["searches"] += lanes
        W_new, H_new, of_value = renormalize(W_unconstrained)
        g = gamma
        n, d, fw, fb, ties = read(torch.ones_like(of_value, dtype=bool),
                                  of_value, W_new, H_new)
        stats["trials"] += n
        stats["disagree"] += d
        stats["false_worse"] += fw
        stats["false_better"] += fb
        stats["ties32"] += ties
        searching = (of_value > prev_objective) & (g > mv.GAMMA_FLOOR)
        stats["floor_stops"] += int(((of_value > prev_objective)
                                     & ~searching).sum())
        while bool(searching.any()):
            stats["rounds"] += 1
            g = torch.where(searching, g * 0.8, g)
            g_lanes = mv._lanes(g, W)
            W_trial = (1.0 - g_lanes) * W + g_lanes * W_unconstrained
            W_t, H_t, of_t = renormalize(W_trial)
            n, d, fw, fb, ties = read(searching, of_t, W_t, H_t)
            stats["trials"] += n
            stats["disagree"] += d
            stats["false_worse"] += fw
            stats["false_better"] += fb
            stats["ties32"] += ties
            W_new = torch.where(mv._lanes(searching, W_new), W_t, W_new)
            H_new = torch.where(mv._lanes(searching, H_new), H_t, H_new)
            of_value = torch.where(searching, of_t, of_value)
            before = searching
            searching = (of_value > prev_objective) & (g > mv.GAMMA_FLOOR)
            stats["floor_stops"] += int((before & ~searching
                                         & (of_value > prev_objective))
                                        .sum())
        return W_new, H_new, torch.clamp_max(1.2 * g, 1.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2147483901)
    parser.add_argument("--max-iterations", type=int, default=10000)
    parser.add_argument("--shadow-max-iterations", type=int, default=10000)
    parser.add_argument("--scan", action="store_true")
    parser.add_argument("--scan-max-iterations", type=int, default=10000)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    X = cohort("pancancer_sbs_20k_breast", args.seed)

    extract(X, 0, 80, device)  # warm-up: every rank's shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    start = time.perf_counter()
    result = extract(X, args.seed, args.max_iterations, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    its = {k: [int(i) for i in v]
           for k, v in result.replicate_iterations.items()}
    emit({"part": "job", "card": card.strip(), "seed": args.seed,
          "max_iterations": args.max_iterations, "wall_s": wall,
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "layout": result.layout, "suggested": result.suggested_rank,
          "lane_iterations": int(sum(sum(v) for v in its.values())),
          "iterations": its,
          "min_silhouette": {k: float(np.min(v))
                             for k, v in result.silhouettes.items()},
          "losses": {k: [float(x) for x in v]
                     for k, v in result.replicate_losses.items()},
          "counters": delta(counters(), before)}, args.out)

    if args.shadow_max_iterations:
        from salamander_tpu_torch.ops import mvnmf as mv

        shadow = Shadow()
        real = mv.line_search_masked
        mv.line_search_masked = shadow
        try:
            start = time.perf_counter()
            extract(X, args.seed, args.shadow_max_iterations, device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            mv.line_search_masked = real
        emit({"part": "shadow", "card": card.strip(), "seed": args.seed,
              "max_iterations": args.shadow_max_iterations, "wall_s": wall,
              "stretches": [[lo, hi] for lo, hi in
                            zip(STRETCHES[:-1], STRETCHES[1:])],
              "stats": shadow.stats}, args.out)

    if args.scan:
        from salamander_tpu_torch import FitConfig, rank_scan_klnmf

        X20 = torch.as_tensor(cohort("pancancer_sbs_20k",
                                     args.seed).to_numpy().T,
                              dtype=torch.float32, device=device)
        rank_scan_klnmf(X20, range(2, 21), 20, seed=0,
                        config=FitConfig(40, 80, 10, 1e-7))
        torch.cuda.synchronize()
        start = time.perf_counter()
        scan = rank_scan_klnmf(X20, range(2, 21), 20, seed=args.seed,
                               config=FitConfig(500, args.scan_max_iterations,
                                                10, 1e-7))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        emit({"part": "rank_scan", "card": card.strip(), "seed": args.seed,
              "max_iterations": args.scan_max_iterations, "wall_s": wall,
              "iterations": {k: [int(i) for i in r.n_iterations]
                             for k, r in scan.items()},
              "lane_iterations": int(sum(r.n_iterations.sum()
                                         for r in scan.values()))},
             args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
