#!/usr/bin/env python3
"""Time the fused KLNMF MU block at cohort shapes on one NVIDIA GPU: the
kernel the launch plan picks against the plain PyTorch block, per 10-step
block, for one or more checkouts of the port in turns.

    python3 scripts/time_mu_block.py [--tree DIR ...] [--out FILE]
                                     [--objective]

Each ``--tree`` is the root of a checkout (default: this one); the trees
run one after another, each in a process of its own, in the order given,
so ``--tree build/parent --tree . --tree . --tree build/parent`` times a
parent commit and this one in turns on one card. The shapes, the check
and the bound are this checkout's ``chip_smoke.py`` (COHORT_SHARED on the
96 x 10,000 catalog, COHORT_7B's resamples, hold_kernel, block_bound),
whatever tree the port is imported from. Per tree and shape it prints one
JSON line: the plan (kernel and split), the kernel's and the plain block's
ms per block by CUDA events, the largest error against the plain block
(rtol 2e-4 is checked), the largest elementwise relative error of each
against the plain block run in float64, and the bound. Where the plan
splits a lane over more than 8 CTAs it also times the kernel at 8 CTAs a
lane. Exits non-zero without a CUDA device.

With ``--objective`` it times the objective epilogue instead, at PCAWG
SBS (K = 5, R = 100, the resident kernel) and at ten Poisson resamples of
a 96 x 20,000 catalog (one X per lane, K = 2, 5 and 10, the streamed
kernel): per tree and shape, the planned launch's ms per block with no
objective, with the float32 and with the float64 objective, and the plain
ops' objective of one block's W, H in float32 and promoted to float64
(what the engine ran after each block before the epilogue), each timed
over replays of a CUDA graph of 20 calls, so no host time lies between
them. A tree whose launch takes no objective reports the plain times
alone.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This checkout's chip_smoke.py (its shapes, check, timer and bound),
    whatever tree the worker imports the port from."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def relative_errors(actual, exact) -> dict:
    """The largest elementwise |actual - exact| / |exact| of W and H."""
    return {name: float(((a.double() - e).abs() / e.abs()).max())
            for name, a, e in zip("WH", actual, exact)}


def worker(tree: Path, label: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_mu_block: no CUDA device", file=sys.stderr)
        return 1
    smoke = chip_smoke()
    sys.path.insert(0, str(tree))
    from salamander_tpu_torch import datasets
    from salamander_tpu_torch.initialization.methods import random_init_batch
    from salamander_tpu_torch.ops import cuda_klnmf

    start = time.perf_counter()
    cuda_klnmf._library()
    print(json.dumps({"tree": label, "build_s": time.perf_counter() - start,
                      "card": smoke.card_line()}), flush=True)
    block = smoke.BLOCK
    shared = torch.as_tensor(datasets.synthetic_catalog(96, 10_000, 8, seed=0),
                             dtype=torch.float32, device="cuda")
    cases = [(shared, K, R) for K, R in smoke.COHORT_SHARED]
    cases.append((smoke.cohort_7b_lanes(torch, datasets),
                  *smoke.COHORT_7B[:2]))
    for X, K, R in cases:
        V, D = X.shape[-2:]
        per_lane = X.dim() == 3
        generator = torch.Generator(device="cuda").manual_seed(K * 1000 + R)
        W, H = random_init_batch(generator, X[0] if per_lane else X, K, R)
        plan = cuda_klnmf.launch_plan(X, W)
        plain = cuda_klnmf.fused_mu_block_reference(X, W, H, block)
        error = smoke.hold_kernel(torch, cuda_klnmf, X, W, H, block,
                                  "planned", plan.cluster, plain,
                                  f"{label} V={V} D={D} K={K} R={R}")
        exact = cuda_klnmf.fused_mu_block_reference(
            X.double(), W.double(), H.double(), block)
        row = {"tree": label, "K": K, "R": R, "V": V, "D": D,
               "x": "per_lane" if per_lane else "shared",
               "variant": plan.variant, "split": plan.cluster,
               "max_abs_err": error,
               "kernel_rel_err_f64": relative_errors(
                   cuda_klnmf.fused_mu_block(X, W, H, block), exact),
               "plain_rel_err_f64": relative_errors(plain, exact)}
        del plain, exact
        repeats = 3 if per_lane else 10  # as chip_smoke.py's phase 3
        row["kernel_ms"] = smoke.time_ms(
            torch, lambda: cuda_klnmf.fused_mu_block(X, W, H, block), repeats)
        row["plain_ms"] = smoke.time_ms(
            torch, lambda: cuda_klnmf.fused_mu_block_reference(X, W, H, block),
            repeats)
        if plan.variant == "streamed" and plan.cluster > 8:
            row["split_8_ms"] = smoke.time_ms(
                torch, lambda: cuda_klnmf._fused_mu_block_variant(
                    X, W, H, block, "streamed", 8), repeats)
        row["bound_ms"], row["bound_by"] = smoke.block_bound(
            R, V, K, D, block, per_lane_x=per_lane)
        print(json.dumps(row), flush=True)
    return 0


def graphed_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Milliseconds per call of fn by CUDA events over replays of one CUDA
    graph of `calls` calls, after a warm-up on a side stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def objective_worker(tree: Path, label: str) -> int:
    import inspect

    import torch

    if not torch.cuda.is_available():
        print("time_mu_block: no CUDA device", file=sys.stderr)
        return 1
    smoke = chip_smoke()
    sys.path.insert(0, str(tree))
    from salamander_tpu_torch import datasets
    from salamander_tpu_torch.initialization.methods import random_init_batch
    from salamander_tpu_torch.models.signature_nmf import promote_objective
    from salamander_tpu_torch.ops import cuda_klnmf
    from salamander_tpu_torch.ops.klnmf import make_step_functions

    cuda_klnmf._library()
    print(json.dumps({"tree": label, "card": smoke.card_line()}), flush=True)
    block = smoke.BLOCK
    epilogue = "objective" in inspect.signature(
        cuda_klnmf.fused_mu_block).parameters
    pcawg = torch.as_tensor(datasets.load_pcawg_sbs().to_numpy().T,
                            dtype=torch.float32, device="cuda").contiguous()
    catalog = torch.as_tensor(datasets.synthetic_catalog(96, 20_000, 5,
                                                         seed=0),
                              dtype=torch.float32, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(0)
    lanes = torch.poisson(catalog.expand(10, -1, -1).contiguous(),
                          generator=generator)
    _, objective_fn = make_step_functions()
    for X, K, R in ((pcawg, 5, 100), (lanes, 2, 10), (lanes, 5, 10),
                    (lanes, 10, 10)):
        per_lane = X.dim() == 3
        generator = torch.Generator(device="cuda").manual_seed(K * 1000 + R)
        W, H = random_init_batch(generator, X[0] if per_lane else X, K, R)
        plan = cuda_klnmf.launch_plan(X, W)
        W1, H1 = cuda_klnmf.fused_mu_block(X, W, H, block)
        params, data = {"W": W1, "H": H1}, {"X": X}
        promoted = promote_objective(objective_fn, params)
        row = {"tree": label, "K": K, "R": R, "V": X.shape[-2],
               "D": X.shape[-1], "x": "per_lane" if per_lane else "shared",
               "variant": plan.variant, "split": plan.cluster}
        if epilogue:
            for name, dtype in (("none", None), ("float32", torch.float32),
                                ("float64", torch.float64)):
                row[f"kernel_ms.{name}"] = graphed_ms(
                    torch, lambda: cuda_klnmf.fused_mu_block(
                        X, W, H, block, objective=dtype))
        else:
            row["kernel_ms.none"] = graphed_ms(
                torch, lambda: cuda_klnmf.fused_mu_block(X, W, H, block))
        row["plain_objective_ms.float32"] = graphed_ms(
            torch, lambda: objective_fn(params, data))
        row["plain_objective_ms.float64"] = graphed_ms(
            torch, lambda: promoted(params, data))
        print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[])
    parser.add_argument("--out", default=None)
    parser.add_argument("--objective", action="store_true",
                        help="time the objective epilogue")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        run_worker = objective_worker if args.objective else worker
        return run_worker(Path(args.worker).resolve(), args.worker)
    lines = []
    for tree in args.tree or ["."]:
        command = [sys.executable, __file__, "--worker", tree]
        if args.objective:
            command.append("--objective")
        run = subprocess.run(command, capture_output=True, text=True,
                             cwd=ROOT)
        sys.stdout.write(run.stdout)
        sys.stderr.write(run.stderr[-4000:])
        lines += [line for line in run.stdout.splitlines()
                  if line.startswith("{")]
        if run.returncode != 0:
            return run.returncode
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
