#!/usr/bin/env python3
"""Time the routes of the unrolled CorrNMF Newton solve across the shapes
its callers give it, and fit_minibatch end to end in one or more
checkouts, on one NVIDIA GPU.

    python3 scripts/time_corrnmf_route.py solves [--out FILE]
    python3 scripts/time_corrnmf_route.py minibatch CHECKOUT [CHECKOUT ...]
                                          [--out FILE]

``solves`` times one unrolled solve of max_iter 4 (the minibatch
signature side's cap) by the two kernels of csrc/corrnmf_newton.cu and by
their plain PyTorch steps, by CUDA events, on random rows near their
optimum: N rows of dimension m against M others, in float32 and float64,
over M from 16 to 20,000 (at one lane and 5 rows, M = 512, 4,096 and
20,000 are the minibatch signature side at those batch sizes). The thread
kernel runs a thread per row, and each thread loops over the M others
serially, so at few rows its time grows with M; the wide kernel spreads a
row's others over a CTA or a cluster; the plain steps spread them over the
card. Each line names the route update_embeddings takes there
(cuda_corrnmf.route), so the cut between the kernels at OTHERS_MAX is a
measurement. One JSON line per shape.

``minibatch`` runs, in a process per checkout and then again in reverse
order, CorrNMFDet(5, dim_embeddings=2).fit_minibatch in float32 on the
96 x 20,000 synthetic catalog (seed 0) at batch_size 128, 512, 4,096 and
20,000, and on PCAWG SBS (192 samples) at 128 and 192, after a warm-up
fit, and prints the steps a second of each. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOLVE_STEPS = 4
OTHERS = (16, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 20_000)
ROWS = ((1, 5), (1, 20), (8, 20))   # (lanes, rows)
DIM = 2
# (catalog, batch_size, steps)
MINIBATCH_CASES = (("synthetic", 128, 400), ("synthetic", 512, 400),
                   ("synthetic", 4096, 200), ("synthetic", 20_000, 40),
                   ("pcawg", 128, 400), ("pcawg", 192, 400))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def solve_args(torch, lanes, N, M, m, dtype, seed=0):
    """update_embeddings' arguments for N random rows against M others
    (aux given transposed, as the models give it), the rows near their
    optimum so that Newton steps matter."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape, mean, std):
        return mean + std * torch.randn(shape, generator=g, device="cuda",
                                        dtype=torch.float64)

    other = normal(lanes + (M, m), 0.0, 0.6)
    truth = normal(lanes + (N, m), 0.0, 0.6)
    row_scal = normal(lanes + (N,), 2.0, 0.5)
    other_scal = normal(lanes + (M,), -1.0, 0.5)
    rate = torch.exp(row_scal[..., None] + other_scal[..., None, :]
                     + truth @ other.mT)
    aux = torch.poisson(rate, generator=g)
    start = truth + normal(truth.shape, 0.0, 0.3)
    variance = torch.full(lanes, 1.3, device="cuda", dtype=torch.float64)
    cast = [t.to(dtype) for t in (start, other, row_scal, other_scal,
                                   variance)]
    return (*cast, aux.to(dtype).mT.contiguous().mT)


def time_ms(torch, fn, repeats: int = 7) -> float:
    fn()
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def solves(out) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from salamander_tpu_torch.ops import cuda_corrnmf

    for dtype in (torch.float32, torch.float64):
        for lanes, N in ROWS:
            for M in OTHERS:
                args = solve_args(torch, (lanes,), N, M, DIM, dtype)
                operands = cuda_corrnmf.kernel_operands(*args)
                kernel = time_ms(torch, lambda: cuda_corrnmf._launch(
                    operands, SOLVE_STEPS))
                wide = time_ms(torch, lambda: cuda_corrnmf._launch_wide(
                    operands, SOLVE_STEPS))
                plain = time_ms(torch, lambda: (
                    cuda_corrnmf.newton_solve_reference(*args,
                                                        SOLVE_STEPS)))
                got = cuda_corrnmf._launch(operands, SOLVE_STEPS)
                got_wide = cuda_corrnmf._launch_wide(
                    operands, SOLVE_STEPS)[0][..., 0, :]
                want = cuda_corrnmf.newton_solve_reference(*args,
                                                           SOLVE_STEPS)
                line = {"dtype": str(dtype).split(".")[-1], "lanes": lanes,
                        "rows": N, "others": M, "m": DIM,
                        "steps": SOLVE_STEPS,
                        "route": cuda_corrnmf.route(*args, SOLVE_STEPS),
                        "kernel_ms": kernel, "wide_ms": wide,
                        "plain_ms": plain, "kernel_over_plain":
                        kernel / plain, "wide_over_plain": wide / plain,
                        "max_abs_diff": float((got - want).abs().max()),
                        "wide_max_abs_diff":
                        float((got_wide - want).abs().max())}
                print(json.dumps(line), file=out, flush=True)


def minibatch_one(out) -> None:
    """The fit_minibatch cases in this process, with the code of the
    checkout it runs in (its working directory)."""
    import time

    import numpy as np
    import torch

    checkout = Path.cwd()
    sys.path.insert(0, str(checkout))
    import salamander_tpu_torch as sal
    try:
        from salamander_tpu_torch.ops.cuda_corrnmf import newton_solve
    except ImportError:   # a checkout without the kernel
        newton_solve = None
    try:
        from salamander_tpu_torch.ops.cuda_corrnmf import wide_newton_solve
    except ImportError:   # a checkout without the wide kernel
        wide_newton_solve = None

    catalogs = {
        "synthetic": np.ascontiguousarray(sal.datasets.synthetic_catalog(
            96, 20_000, 5, seed=0).T, dtype=np.float32),
        "pcawg": sal.datasets.load_pcawg_sbs().to_numpy().T.astype(
            np.float32)}

    def fit(name, batch_size, steps):
        np.random.seed(0)
        model = sal.CorrNMFDet(n_signatures=5, dim_embeddings=2,
                               device="cuda", dtype="float32")
        model.fit_minibatch(sal.AnnData(catalogs[name].copy()),
                            batch_size=batch_size, n_steps=steps,
                            eval_freq=0, seed=0)

    for name, batch_size, _ in MINIBATCH_CASES:
        fit(name, batch_size, 5)   # warm: build, first launches
    for name, batch_size, steps in MINIBATCH_CASES:
        launches = newton_solve.launches if newton_solve else 0
        wide = wide_newton_solve.launches if wide_newton_solve else 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit(name, batch_size, steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        print(json.dumps({
            "checkout": str(checkout), "catalog": name,
            "batch_size": batch_size, "steps": steps, "seconds": seconds,
            "steps_per_s": steps / seconds, "kernel_launches":
            (newton_solve.launches - launches) if newton_solve else None,
            "wide_kernel_launches": (wide_newton_solve.launches - wide)
            if wide_newton_solve else None}), file=out, flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("solves", "minibatch",
                                         "minibatch-one"))
    parser.add_argument("checkouts", nargs="*")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_corrnmf_route: no CUDA device", file=sys.stderr)
        return 1
    out = open(args.out, "a") if args.out else sys.stdout
    print(json.dumps({"card": card_line()}), file=out, flush=True)
    if args.what == "solves":
        solves(out)
    elif args.what == "minibatch-one":
        minibatch_one(out)
    else:
        order = [Path(c).resolve() for c in args.checkouts]
        for checkout in order + order[::-1]:
            command = [sys.executable, str(Path(__file__).resolve()),
                       "minibatch-one"]
            if args.out:
                command += ["--out", str(args.out.resolve())]
            subprocess.run(command, check=True, cwd=checkout,
                           env=dict(os.environ, PYTHONPATH=str(checkout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
