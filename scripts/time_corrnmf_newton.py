#!/usr/bin/env python3
"""Time the unrolled CorrNMF Newton solve on one NVIDIA GPU: the kernel of
csrc/corrnmf_newton.cu against its plain PyTorch steps, at the sample side
of the multimodal pan-cancer cell.

    python3 scripts/time_corrnmf_newton.py [--seed N] [--cycles C]
                                           [--out FILE]

It builds the kernel (and prints ptxas's registers and spills for each
compiled instance), then fits best-of-8 ``MultimodalCorrNMF([6, 5])`` for
C joint cycles on the 20,000 genomes that ``portbench/mm_inputs.py`` plants
from the seed (the configuration of
``portbench/configs/pancancer_sbs_id_20k.json``) and keeps the arguments
of the last sample-side solve: (8, 20,000) rows, M = 11 signatures, m = 6.
On those, in float32 and cast to float64, it prints one JSON line each:
the kernel's and the plain solve's ms per solve by CUDA events, the bytes
bound (the rows in and out, aux and the row scalings read once, at 3.35
TB/s), the rows whose first step took another Armijo step than the plain
one, and the largest differences after the full 3 steps. Exits non-zero
without a CUDA device.
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
    best-of-8 fit of the cell's configuration."""
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
    captured = []
    original = corrnmf.update_embeddings

    def recording(*args, **kwargs):
        if kwargs.get("max_iter", 100) <= corrnmf._UNROLL_NEWTON_LIMIT:
            captured[:] = [args]
        return original(*args, **kwargs)

    corrnmf.update_embeddings = recording
    try:
        fit_best_of(model, mdata, n_restarts=8, base_seed=seed)
    finally:
        corrnmf.update_embeddings = original
    torch.cuda.synchronize()
    return captured[0]


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
    args = capture(torch, options.seed, options.cycles)
    emit({"fit_cycles": options.cycles, "seed": options.seed,
          "kernel_launches_in_fit":
              cuda_corrnmf.newton_solve.launches - launches,
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
    if options.out:
        options.out.parent.mkdir(parents=True, exist_ok=True)
        options.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
