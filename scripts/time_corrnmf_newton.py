#!/usr/bin/env python3
"""Time the CorrNMF Newton solve on one NVIDIA GPU: the two kernels of
csrc/corrnmf_newton.cu against their plain PyTorch steps, at the sample
and the signature side of the multimodal pan-cancer cell.

    python3 scripts/time_corrnmf_newton.py [--seed N] [--cycles C]
                                           [--out FILE]

It builds the kernels (and prints ptxas's registers and spills for each
compiled instance), then fits best-of-8 ``MultimodalCorrNMF([6, 5])`` for
C joint cycles on the 20,000 genomes that ``portbench/mm_inputs.py`` plants
from the seed (the configuration of
``portbench/configs/pancancer_sbs_id_20k.json``) and keeps the arguments
of the last sample-side solve, (8, 20,000) rows against M = 11
signatures, and of the last signature-side solve of each modality, (8, 6)
and (8, 5) rows against M = 20,000 samples, m = 6. On those, in float32
and cast to float64, it prints one JSON line each. The sample side (the
thread kernel, 3 steps): the kernel's and the plain solve's ms per solve
by CUDA events, the bytes bound (the rows in and out, aux and the row
scalings read once, at 3.35 TB/s), the rows whose first step took another
Armijo step than the plain one, and the largest differences after the
full 3 steps. The signature side (the wide kernel, early exit at 100
steps): ms per solve and per step (over the most steps a row ran) of the
kernel and of the plain loop, each row's steps on both, the largest
difference, and the kernel's bound: the largest of its bytes (the others,
their scalings and aux read once, at 3.35 TB/s), its exponentials (each
row's steps, one pass for the rates and one candidate a step, expm1 too
in float32, at the SFU rate of 4.18e12 a second) and its operations (at
67 TFLOP/s). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
SFU_PER_S = 16 * 132 * 1.98e9   # exponentials a second (16 a clock an SM)
F32_FLOP_PER_S = 67e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """(kernel instance, registers, spill stores, spill loads) per entry
    function of ptxas's -v report."""
    rows, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name:
            rows.append([name, None, int(spill.group(1)),
                         int(spill.group(2))])
        used = re.search(r"Used (\d+) registers", line)
        if used and rows and rows[-1][0] == name and rows[-1][1] is None:
            rows[-1][1] = int(used.group(1))
    return rows


def capture(torch, seed: int, cycles: int):
    """The arguments of the last sample-side (unrolled) solve of a
    best-of-8 fit of the cell's configuration, and of the last
    signature-side (early-exit) solve of each width of rows."""
    sys.path.insert(0, str(ROOT))
    from portbench import mm_inputs
    from salamander_tpu_torch import (
        AnnData,
        MuData,
        MultimodalCorrNMF,
        fit_best_of,
    )
    from salamander_tpu_torch.ops import corrnmf

    with open(ROOT / "portbench" / "configs" /
              "pancancer_sbs_id_20k.json") as handle:
        config = json.load(handle)
    counts = mm_inputs.cohort(config, seed)
    model = MultimodalCorrNMF(
        ns_signatures=[int(k) for k in config["ns_signatures"]],
        init_method="random", min_iterations=cycles,
        max_iterations=cycles, conv_test_freq=10, tol=1e-7,
        dtype="float32", device="cuda")
    mdata = MuData({name: AnnData(frame.to_numpy(copy=True))
                    for name, frame in counts.items()})
    captured, signature = [], {}
    original = corrnmf.update_embeddings

    def recording(*args, **kwargs):
        if kwargs.get("max_iter", 100) <= corrnmf._UNROLL_NEWTON_LIMIT:
            captured[:] = [args]
        else:
            signature[args[0].shape[-2]] = args
        return original(*args, **kwargs)

    corrnmf.update_embeddings = recording
    try:
        fit_best_of(model, mdata, n_restarts=8, base_seed=seed)
    finally:
        corrnmf.update_embeddings = original
    torch.cuda.synchronize()
    return captured[0], signature


def wide_bound_ms(args, row_steps) -> tuple:
    """(ms, what bounds it): the least time of the wide kernel's work on
    these rows: each row's own steps, each a pass for the rates, gradient
    and Hessian and one Armijo candidate."""
    b, others, _, scal_other, _, aux = args
    size = b.element_size()
    M, m = others.shape[-2:]
    pair_steps = int(row_steps.sum()) * M
    n_bytes = size * (others.numel() + scal_other.numel() + aux.numel()
                      + 2 * b.numel())
    exps = pair_steps * (3 if b.dtype.itemsize < 8 else 2)
    # the rates, gradient, Hessian and rate sum; a candidate's product,
    # exponent and sum
    flops = pair_steps * ((2 * m + 1) + 2 * m + (m + 2 * m * m) + 1
                          + (2 * m + 3))
    # float64 at half float32's rate outside the tensor cores
    times = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "exponentials": exps / SFU_PER_S,
             "operations": flops * (size // 4) / F32_FLOP_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def time_ms(torch, fn, repeats: int) -> float:
    """Mean milliseconds per call by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def steps_apart(torch, b0, kernel, plain) -> int:
    """Rows whose one step differs by a power of two between the two
    solves (another Armijo candidate): log2 of the ratio of their moves
    along the row's largest component, rounded."""
    moved_plain = plain - b0
    at = moved_plain.abs().argmax(-1, keepdim=True)
    ratio = ((kernel - b0).gather(-1, at) / moved_plain.gather(-1, at))
    apart = torch.log2(ratio.abs()).round() != 0
    return int(apart.sum())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2**31 + 1919)
    parser.add_argument("--cycles", type=int, default=40)
    parser.add_argument("--out", type=Path)
    options = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_corrnmf_newton: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from salamander_tpu_torch.ops import cuda_corrnmf

    lines = []

    def emit(row):
        text = json.dumps(row)
        print(text, flush=True)
        lines.append(text)

    start = time.perf_counter()
    library = cuda_corrnmf.build()
    cuda_corrnmf._library()
    emit({"card": card_line(), "torch": torch.__version__,
          "build_s": time.perf_counter() - start,
          "ptxas": ptxas_report(library.with_suffix(".log").read_text())})

    launches = cuda_corrnmf.newton_solve.launches
    wide_launches = cuda_corrnmf.wide_newton_solve.launches
    args, signature = capture(torch, options.seed, options.cycles)
    emit({"fit_cycles": options.cycles, "seed": options.seed,
          "kernel_launches_in_fit":
              cuda_corrnmf.newton_solve.launches - launches,
          "wide_kernel_launches_in_fit":
              cuda_corrnmf.wide_newton_solve.launches - wide_launches,
          "shapes": [list(a.shape) if isinstance(a, torch.Tensor) else a
                     for a in args]})
    for dtype in (torch.float32, torch.float64):
        cast = [a.to(dtype) if isinstance(a, torch.Tensor) else a
                for a in args]

        def kernel(steps=3):
            return cuda_corrnmf.newton_solve(*cast, steps)

        def plain(steps=3):
            return cuda_corrnmf.newton_solve_reference(*cast, steps)

        got, want = kernel(), plain()
        diff = (got - want).abs()
        row_rel = (diff.amax(-1) / want.abs().amax(-1)).flatten()
        exact = cuda_corrnmf.newton_solve_reference(
            *[a.double() if isinstance(a, torch.Tensor) else a
              for a in args], 3)
        b0 = cast[0]
        nbytes = sum(t.numel() * t.element_size()
                     for t in (cast[2], cast[5])) + 2 * (
            got.numel() * got.element_size())
        emit({
            "side": "sample",
            "dtype": str(dtype).removeprefix("torch."),
            "rows": int(row_rel.numel()),
            "kernel_ms": time_ms(torch, kernel, 200),
            "plain_ms": time_ms(torch, plain, 20),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_bytes": nbytes,
            "first_step_t_apart": steps_apart(torch, b0, kernel(1),
                                              plain(1)),
            "max_abs_diff": float(diff.max()),
            "row_rel_diff_quantiles": [
                float(q) for q in torch.quantile(
                    row_rel.double()[:100000],
                    torch.tensor([0.5, 0.99, 0.999, 1.0],
                                 dtype=torch.float64, device="cuda"))],
            "rows_rel_diff_over": {str(x): int((row_rel > x).sum())
                                   for x in (1e-6, 1e-4, 1e-2)},
            "kernel_max_abs_err_f64": float((got.double() - exact).abs()
                                            .max()),
            "plain_max_abs_err_f64": float((want.double() - exact).abs()
                                           .max()),
        })
    for dtype in (torch.float32, torch.float64):
        for rows, captured in sorted(signature.items(), reverse=True):
            cast = [a.to(dtype) if isinstance(a, torch.Tensor) else a
                    for a in captured]

            def kernel():
                return cuda_corrnmf.wide_newton_solve(*cast, 100)

            def plain():
                return cuda_corrnmf.wide_newton_solve_reference(*cast, 100)

            (got, steps), (want, plain_steps) = kernel(), plain()
            kernel_ms, plain_ms = time_ms(torch, kernel, 200), \
                time_ms(torch, plain, 10)
            bound_ms, bound_by = wide_bound_ms(cast, steps)
            most, plain_most = int(steps.max()), int(plain_steps.max())
            emit({
                "side": "signature",
                "dtype": str(dtype).removeprefix("torch."),
                "rows": list(got.shape[:-1]),
                "others": int(cast[1].shape[-2]),
                "kernel_ms": kernel_ms,
                "plain_ms": plain_ms,
                "steps": most, "plain_steps": plain_most,
                "row_steps": steps.flatten().tolist(),
                "rows_a_step_apart": int((steps - plain_steps).ne(0).sum()),
                "kernel_ms_per_step": kernel_ms / max(most, 1),
                "plain_ms_per_step": plain_ms / max(plain_most, 1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / kernel_ms,
                "max_abs_diff": float((got - want).abs().max()),
            })
    if options.out:
        options.out.parent.mkdir(parents=True, exist_ok=True)
        options.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
