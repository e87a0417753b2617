#!/usr/bin/env python3
"""Smoke test of the PyTorch port (salamander_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases (each prints its lines; any failed
check raises, so the script exits non-zero and prints no result):

1. environment: torch, CUDA, nvcc, triton, pandas/sklearn, the card's name
   and power limit. Exits 1 at once without a CUDA device.
2. build csrc/mu_block.cu with nvcc (timed; ptxas's registers and
   spills of both kernels).
3. the fused MU block against its plain PyTorch version on the card, at
   rtol 2e-4: the planned kernel, the resident kernel at every cluster
   size that holds a lane (1, 2, 4, 8 all held) and the streamed kernel,
   at the shapes the main path gives it (PCAWG SBS 96x192, K=5, R=100,
   R=1; the scan's R=20 up to K=10), at edge shapes and on the 96 x 10,000
   catalog (streamed); then resident and streamed timed in turns (r, s, s,
   r) per 10-step block at R=100, R=1 and R=20 K=10, beside the plain
   version and the block's bound. Then a per-lane X (R=20 PCAWG SBS
   resamples, K=5): every kernel against the plain version, lanes copying
   one X bit-equal to the shared-X launch, and the block timed with a
   per-lane and a shared X in turns.
4. the main path: KLNMF(n_signatures=5).fit(adata) on PCAWG SBS, float32
   on the card, which must run through the kernel; the same fit again from
   the same init with the plain block must agree.
5. the multi-start headline: fit_klnmf_restarts R=100, k=5 over a fixed
   5,000-iteration window; the best loss must be within 1e-4 of 20414.
   Aggregate MU iterations/s of the kernel and the plain path, best of 3.
6. the README quick start: fit_best_of(KLNMF(5, init_method="random"),
   PCAWG SBS, n_restarts=100, base_seed=0), compacted and monolithic in
   turns (walls printed); both launch the kernel, their best losses agree
   at rtol 1e-4, and so does the same lanes' plain-block run from the same
   params0.
7. MvNMF(n_signatures=5).fit in float32 must stop below the 10,000 cap
   with finite, column-normalized signatures (line-search evaluations per
   iteration and the cost of one trial round printed); then
   fit_best_of(MvNMF(5, random), n_restarts=10) compacted and monolithic
   (one run each), best losses at rtol 1e-4.
8. rank_scan_klnmf(X, range(2, 11), 20, seed=0) unpadded (with and without
   compaction; launches the kernel) and padded (packed and one point per
   call; plain ops), one run each; best loss per rank at rtol 1e-4.
9. CorrNMFDet(n_signatures=5, dim_embeddings=2, min 100, max 2000,
   tol 1e-7).fit on PCAWG SBS in float32 (np.random.seed(0)): EM cycles,
   wall, cycles/s, final ELBO, signature-side Newton steps per cycle; the
   ELBO is finite and its history never falls by more than float32 noise.
   Then fit_best_of(CorrNMFDet(5, dim_embeddings=2, random, max 500),
   n_restarts=16) compacted and monolithic, one run each, best ELBO at
   rtol 1e-4.
10. ARDNMF(n_signatures=20, a=5, min 500, max 20000).fit on the synthetic
   96 x 10,000 catalog with 8 planted signatures: the inferred rank is 8;
   then fit_best_of(ARDNMF(20, random), n_restarts=8) compacted and
   monolithic, best objective at rtol 1e-4, inferred rank 8.
11. rank_scan_corrnmf(PCAWG SBS, range(2, 8), n_restarts=4,
   dim_embeddings=2) over a fixed 100-cycle window, unpadded, padded and
   packed, and padded one point per call, one run each; best ELBO per rank
   at rtol 1e-4.
Phases 9-11 run plain PyTorch ops (neither family reaches the kernel).
12. extract_signatures(PCAWG SBS, range(2, 11), n_bootstraps=20, seed=0)
   grouped (each rank's lanes through the kernel with a per-lane X) and
   padded (one rank-masked batch of plain ops), one run each: walls, lane
   iterations, launches, suggested rank, min stabilities; each rank's best
   replicate loss agrees across the layouts at rtol 1e-4.
13. assign_exposures and assign_signatures(rel_tol=0.02) of PCAWG SBS
   against COSMIC-79 (fails on any sample over the reported budget), then
   decompose_signatures of phase 12's rank-5 consensus.
14. bootstrap_stability(KLNMF(5).fit(PCAWG SBS), 20) through the kernel
   (per-lane X) and the plain block, best loss at rtol 1e-4; then
   bootstrap_exposures(PCAWG SBS, COSMIC-79, 50).
15. MultimodalCorrNMF in float32, plain PyTorch ops (no kernel launches):
   ([5, 4, 3], dim_embeddings=3, min 100, max 1000).fit on PCAWG breast
   {sbs 96, indel 83, sv 32} x 192 (np.random.seed(0)): wall, EM cycles,
   cycles/s, final ELBO; the ELBO trace never falls by more than float32
   noise and its last value equals objective_function() on the absorbed
   state at rtol 1e-5. fit_best_of(random init, max 500, R=16,
   base_seed=0) compacted and monolithic (one run each), best ELBO at rtol
   1e-4. The synthetic {96, 83} x 100,000 cohort (default_rng(1)),
   ns_signatures [4, 3], R=4, 100 cycles, tol 1e-6: the bytes reckoned
   first, then wall, aggregate joint cycles/s, best ELBO, peak allocated
   memory. bootstrap_stability(the fitted model, 4 replicates of at most
   500 cycles): wall, mean stability per modality. Then 20 cycles of the cohort best-of-4 and 50 cycles of
   the first fit under torch.profiler: device busy share (traced device
   time over the untraced wall), kernels per EM cycle and the kernels that
   take most of the device time.

16. Stochastic (minibatch) fitting and host streaming (ops/svi.py), float32
   on the card, plain PyTorch ops: the phase launches no hand kernel, and
   that is checked. (a) fit_minibatch resident against streaming at one
   seed for KLNMF (weights_kl and weights_lhalf), CorrNMFDet(5, m=2) and
   MultimodalCorrNMF([5, 4, 3], m=3) on the PCAWG data, batch_size 48 and
   50 (50 divides no epoch), 200 steps, eval_freq 50: every absorbed
   parameter bit-equal, traces at rtol 1e-5, streaming prefetch 1, 2 and 4
   bit-equal. (b) The synthetic 96 x 200,000 cohort, CorrNMFDet k=5 m=2,
   init seed 1: 50 full-batch EM cycles, then 2,000 minibatch steps at
   B=4,096, delay 50, no evaluations, resident and streaming in turns (r,
   s, s, r): steps/s, sample updates/s, peak allocated memory of each
   placement, the four final states bit-equal, the ELBO after the steps
   finite and above the initial one; one resident and one core step under
   torch.cuda.set_sync_debug_mode("error") (a step makes no host sync);
   kernels a step and the device busy share over 50 steps of each
   placement. (c) Streaming at cohort size: uint16 host counts 2,000,000 x
   96 (384 MB, from a seed), the CorrNMF core, B=16,384, delay 20, 20 warm
   and 100 timed steps: steps/s, samples/s, MB/s uploaded, peak allocated
   memory; the host array is still uint16; a streamed log-likelihood probe
   of 262,144 samples rises. (d) 20 lockstep cycles of
   fit_best_of(CorrNMFDet(5, m=2, random), 96 x 200,000, R=8): the bytes
   reckoned first, then ms a cycle, peak allocated memory, busy share.

Each of phases 4-16 runs with the kernel's launch counts (in all, by
kernel and by shared or per-lane X) set to 0 just before it and read just
after. The last two lines are the per-kernel JSON
record and
{"ok": true, "device": {...}}; the card's name and power limit precede
them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from importlib import metadata, util
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SBS_BEST_OF_100 = 20414.0   # PCAWG SBS k=5 best-of-100 KL over 5,000 iterations
KERNEL_RTOL = 2e-4          # float32 sums in another order, over 10 steps
FIT_RTOL = 1e-4             # final objective, kernel vs plain fit
BLOCK = 10                  # conv_test_freq: steps per kernel launch
WINDOW = 5000               # iterations of every headline lane
F32_NOISE = 64 * float(np.finfo(np.float32).eps)  # relative ELBO fall
F32_PEAK = 67e12            # H100 SXM float32 FLOP/s outside tensor cores
HBM_RATE = 3.35e12          # H100 SXM device memory bytes/s


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"check failed: {message}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def package_version(name: str) -> str:
    if util.find_spec(name) is None:
        return "absent"
    return metadata.version("scikit-learn" if name == "sklearn" else name)


def phase_environment(torch) -> None:
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    from salamander_tpu_torch.ops import cuda_klnmf

    nvcc = subprocess.run([cuda_klnmf._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[1] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print("[1] " + ", ".join(f"{name} {package_version(name)}"
                             for name in ("triton", "pandas", "sklearn")))
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls must be IEEE (no TF32)")
    print(f"[1] nvidia-smi: {card_line()}")
    from salamander_tpu_torch import assign

    total = torch.cuda.get_device_properties(0).total_memory
    budget = assign._memory_budget(torch.device("cuda"))
    check(budget == int(assign._DEVICE_MEMORY_SHARE * total),
          "the memory budget is not a fixed share of the total memory")
    print(f"[1] device memory {total / 1e9:.2f} GB in all; memory budget of "
          f"a batch's working tensors {budget / 1e9:.2f} GB "
          f"({assign._DEVICE_MEMORY_SHARE} of it, whatever is free)")


def ptxas_report(log: str):
    """[(kernel, registers, spill store bytes, spill load bytes, stack
    bytes)] from ptxas -v output."""
    import re

    rows, kernel, frame = [], None, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            args = re.findall(r"Li(\d+)E", name)
            kernel = ("mu_block_resident_kernel<" + ", ".join(args) + ">"
                      if "resident" in name else "mu_block_streamed_kernel")
        sizes = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if sizes:
            frame = [int(x) for x in sizes.groups()]
        used = re.search(r"Used (\d+) registers", line)
        if used and kernel is not None and frame is not None:
            rows.append((kernel, int(used.group(1)), frame[1], frame[2],
                         frame[0]))
            kernel, frame = None, None
    return rows


def phase_build(cuda_klnmf):
    start = time.perf_counter()
    library = cuda_klnmf.build()
    cuda_klnmf._library()
    seconds = time.perf_counter() - start
    print(f"[2] built {library.relative_to(ROOT)} in {seconds:.2f} s")
    rows = ptxas_report(library.with_suffix(".log").read_text())
    for kernel, registers, stores, loads, stack in rows:
        print(f"[2] ptxas {kernel}: {registers} registers, {stores} B spill "
              f"stores, {loads} B spill loads, {stack} B stack frame")
    expected = 1 + sum(len(cuda_klnmf.chunk_counts(rank))
                       for rank in cuda_klnmf._RANK_PARTS)
    check(len(rows) == expected,
          f"ptxas reported {len(rows)} kernels, not {expected}")
    check(all(row[2] == row[3] == 0 for row in rows), "a kernel spills")


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


def block_bound(R: int, V: int, K: int, D: int, steps: int,
                per_lane_x: bool = False):
    """(ms, "operations" or "bytes"): the least time an H100 could take
    for `steps` joint updates of R lanes. Per step and lane 6*V*D*K FLOP of
    the three depth-K contractions, V*D divisions, ~4*V*K (W') and 2*K*D
    (H') elementwise operations, at the 67 TFLOP/s float32 peak outside
    the tensor cores; bytes: X (one, or one per lane) read once, W and H
    read and written once, at 3.35 TB/s."""
    flops = steps * R * (6 * V * D * K + V * D + 4 * V * K + 2 * K * D)
    n_x = R if per_lane_x else 1
    n_bytes = 4 * (n_x * V * D + 2 * R * V * K + 2 * R * K * D)
    ops_ms, bytes_ms = 1e3 * flops / F32_PEAK, 1e3 * n_bytes / HBM_RATE
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def phase_kernel(torch, cuda_klnmf, datasets, random_init_batch):
    """Both kernels against the plain version on the card; the resident
    and streamed kernels timed in turns. Returns (max_abs_err, timings)."""
    catalogs = {
        "sbs": datasets.load_pcawg_sbs().to_numpy().T,
        "indel": datasets.load_pcawg_indel().to_numpy().T,
        "sv": datasets.load_pcawg_sv().to_numpy().T,
        "synthetic": datasets.synthetic_catalog(96, 10_000, 8, seed=0),
    }
    counts = {key: torch.as_tensor(np.ascontiguousarray(array),
                                   dtype=torch.float32, device="cuda")
              for key, array in catalogs.items()}
    cases = [  # (catalog, K, R, samples, step counts)
        ("sbs", 5, 100, None, (1, 7, 10, 3, 0)),
        ("sbs", 5, 1, None, (10,)),
        ("sbs", 5, 20, None, (10,)),
        ("sbs", 5, 40, None, (10,)),
        ("sbs", 10, 20, None, (10,)),
        ("indel", 5, 4, None, (10,)),
        ("sv", 5, 4, None, (10,)),
        ("sbs", 1, 4, None, (10,)),
        ("sbs", 20, 4, None, (10,)),
        ("sbs", 5, 4, 100, (10,)),  # D = 100: not a multiple of the tile
        ("sbs", 5, 1, 100, (10,)),  # D = 100 caps the cluster at 4
        ("synthetic", 5, 20, None, (10,)),  # 96 x 10,000: streamed
    ]
    print(f"[3] tolerance: rtol {KERNEL_RTOL}, atol 1e-6 x max|plain| per "
          "tensor (entries at the eps clip)")
    max_abs_err = 0.0
    clusters_held = set()
    for key, K, R, samples, step_counts in cases:
        X = counts[key] if samples is None else \
            counts[key][:, :samples].contiguous()
        V, D = X.shape
        generator = torch.Generator(device="cuda").manual_seed(K * 1000 + R)
        W, H = random_init_batch(generator, X, K, R)
        plan = cuda_klnmf.launch_plan(X, W)
        names = [("planned", plan.cluster)] + cuda_klnmf._kernels_taking(
            V, K, D)
        for steps in step_counts:
            W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
            for variant, cluster in names:
                if variant == "planned":
                    W_k, H_k = cuda_klnmf.fused_mu_block(X, W, H, steps)
                else:
                    W_k, H_k = cuda_klnmf._fused_mu_block_variant(
                        X, W, H, steps, variant, cluster)
                    if variant == "resident":
                        clusters_held.add(cluster)
                torch.cuda.synchronize()
                errors = []
                for name, actual, expected in (("W", W_k, W_r),
                                               ("H", H_k, H_r)):
                    check(bool(torch.isfinite(actual).all()),
                          f"non-finite kernel {name}")
                    atol = 1e-6 * float(expected.abs().max())
                    torch.testing.assert_close(actual, expected,
                                               rtol=KERNEL_RTOL, atol=atol)
                    error = float((actual - expected).abs().max())
                    relative = float(((actual - expected).abs()
                                      / expected.abs()).max())
                    max_abs_err = max(max_abs_err, error)
                    errors.append(f"{name} abs {error:.3e} rel "
                                  f"{relative:.3e}")
                label = (f"planned {plan.variant} C={plan.cluster}"
                         if variant == "planned" else
                         f"{variant} C={cluster}")
                print(f"[3] {key} V={V} D={D} K={K} R={R} steps={steps} "
                      f"{label}: max err {'; '.join(errors)}")
    check(clusters_held == {1, 2, 4, 8},
          f"the resident kernel was held at clusters {clusters_held}")
    check(cuda_klnmf.launch_plan(counts["sbs"], torch.empty(
        100, 96, 5, device="cuda")).variant == "resident",
        "the headline shape does not take the resident kernel")

    timings = {}
    X = counts["sbs"]
    V, D = X.shape
    for K, R in ((5, 100), (5, 1), (10, 20)):
        generator = torch.Generator(device="cuda").manual_seed(R)
        W, H = random_init_batch(generator, X, K, R)
        plan = cuda_klnmf.launch_plan(X, W)
        check(plan.variant == "resident", f"K={K} R={R} is not resident")
        runs = {"resident": [], "streamed": []}
        for variant in ("resident", "streamed", "streamed", "resident"):
            runs[variant].append(time_ms(
                torch, lambda: cuda_klnmf._fused_mu_block_variant(
                    X, W, H, BLOCK, variant, plan.cluster if variant ==
                    "resident" else 1), 200))
        plain = time_ms(
            torch,
            lambda: cuda_klnmf.fused_mu_block_reference(X, W, H, BLOCK), 50)
        bound_ms, bound_by = block_bound(R, V, K, D, BLOCK)
        timings[(K, R)] = {
            "K": K, "R": R, "cluster": plan.cluster,
            "resident_ms": runs["resident"], "streamed_ms": runs["streamed"],
            "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / min(runs["resident"]),
        }
        print(f"[3] one block of {BLOCK} steps, PCAWG SBS K={K} R={R}: "
              f"resident (C={plan.cluster}) "
              f"{', '.join(f'{t:.4f}' for t in runs['resident'])} ms, "
              f"streamed {', '.join(f'{t:.4f}' for t in runs['streamed'])} "
              f"ms (in turns r, s, s, r), plain {plain:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}), resident at "
              f"{100 * bound_ms / min(runs['resident']):.1f}% of the bound")
    per_lane_err, timings["per_lane"] = phase_kernel_per_lane_x(
        torch, cuda_klnmf, catalogs["sbs"])
    return max(max_abs_err, per_lane_err), timings


def resamples(counts: np.ndarray, R: int, seed: int) -> np.ndarray:
    """R multinomial resamples (R, V, D) of a (V, D) count matrix, each
    sample's total kept, EPSILON-clipped as a fit clips its counts."""
    rng = np.random.default_rng(seed)
    totals = counts.sum(0).astype(np.int64)
    lanes = np.stack([
        np.stack([rng.multinomial(n, column / column.sum())
                  for n, column in zip(totals, counts.T)], axis=1)
        for _ in range(R)])
    return np.clip(lanes, np.finfo(np.float32).eps, None)


def phase_kernel_per_lane_x(torch, cuda_klnmf, counts_host):
    """X (R, V, D), one count matrix per lane (the bootstrap and extraction
    lanes): R = 20 PCAWG SBS resamples at K = 5, the resident kernel at
    every cluster size that holds a lane and the streamed kernel, against
    the plain version at rtol 2e-4; lanes that all copy one X give the
    bits of the shared-X (lane stride 0) launch. Then the planned kernel
    timed with a per-lane and a shared X in turns. Returns (max_abs_err,
    timing)."""
    from salamander_tpu_torch.initialization.methods import (
        random_init_batch,
    )

    R, K = 20, 5
    X = torch.as_tensor(resamples(counts_host, R, seed=0),
                        dtype=torch.float32, device="cuda")
    V, D = X.shape[1:]
    generator = torch.Generator(device="cuda").manual_seed(20)
    W, H = random_init_batch(generator, X[0], K, R)
    names = cuda_klnmf._kernels_taking(V, K, D)
    check({c for v, c in names if v == "resident"} == {1, 2, 4, 8}
          and ("streamed", 1) in names,
          f"per-lane X: the kernels taking it are {names}")
    max_abs_err = 0.0
    for steps in (1, 10):
        W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
        for variant, cluster in names:
            W_k, H_k = cuda_klnmf._fused_mu_block_variant(
                X, W, H, steps, variant, cluster)
            torch.cuda.synchronize()
            errors = []
            for name, actual, expected in (("W", W_k, W_r), ("H", H_k, H_r)):
                check(bool(torch.isfinite(actual).all()),
                      f"per-lane X: non-finite kernel {name}")
                torch.testing.assert_close(
                    actual, expected, rtol=KERNEL_RTOL,
                    atol=1e-6 * float(expected.abs().max()))
                error = float((actual - expected).abs().max())
                relative = float(((actual - expected).abs()
                                  / expected.abs()).max())
                max_abs_err = max(max_abs_err, error)
                errors.append(f"{name} abs {error:.3e} rel {relative:.3e}")
            print(f"[3] per-lane X (R={R}, {V}x{D} resamples) K={K} "
                  f"steps={steps} {variant} C={cluster}: max err "
                  f"{'; '.join(errors)}")
    shared = X[0].contiguous()
    copies = shared.expand_as(X).contiguous()
    for variant, cluster in names:
        one = cuda_klnmf._fused_mu_block_variant(shared, W, H, BLOCK, variant,
                                                 cluster)
        lanes = cuda_klnmf._fused_mu_block_variant(copies, W, H, BLOCK,
                                                   variant, cluster)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(one, lanes)),
              f"per-lane copies of X differ from the shared X ({variant} "
              f"C={cluster})")
    print(f"[3] per-lane X: lanes copying one X equal the shared-X launch "
          f"bit for bit in all {len(names)} kernels")

    plan = cuda_klnmf.launch_plan(X, W)
    check(plan.variant == "resident", "per-lane X R=20 is not resident")
    runs = {"per_lane": [], "shared": []}
    for which in ("per_lane", "shared", "shared", "per_lane"):
        source = X if which == "per_lane" else shared
        runs[which].append(time_ms(
            torch, lambda: cuda_klnmf.fused_mu_block(source, W, H, BLOCK),
            200))
    plain = time_ms(
        torch, lambda: cuda_klnmf.fused_mu_block_reference(X, W, H, BLOCK), 50)
    bound_ms, bound_by = block_bound(R, V, K, D, BLOCK, per_lane_x=True)
    per_lane_ms = ", ".join(f"{t:.4f}" for t in runs["per_lane"])
    shared_ms = ", ".join(f"{t:.4f}" for t in runs["shared"])
    print(f"[3] one block of {BLOCK} steps, per-lane X K={K} R={R}: resident "
          f"(C={plan.cluster}) {per_lane_ms} ms, shared X {shared_ms} ms "
          f"(in turns p, s, s, p), plain {plain:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}), per-lane at "
          f"{100 * bound_ms / min(runs['per_lane']):.1f}% of the bound")
    return max_abs_err, {
        "K": K, "R": R, "x": "per_lane", "cluster": plan.cluster,
        "resident_ms": runs["per_lane"], "shared_x_ms": runs["shared"],
        "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / min(runs["per_lane"]),
    }


def phase_main_path(sal, cuda_klnmf):
    from salamander_tpu_torch.engine import fit_loop
    from salamander_tpu_torch.models.signature_nmf import promote_objective

    def adata():
        return sal.AnnData(sal.datasets.load_pcawg_sbs())

    launches = cuda_klnmf.fused_mu_block.launches
    model = sal.KLNMF(n_signatures=5, device="cuda", dtype="float32")
    start = time.perf_counter()
    model.fit(adata())
    seconds = time.perf_counter() - start
    n_iterations = model.history["n_iterations"]
    final = float(model.history["objective_function"][-1])
    fit_launches = cuda_klnmf.fused_mu_block.launches - launches
    W = model.asignatures.X
    print(f"[4] KLNMF(n_signatures=5).fit: {n_iterations} iterations, "
          f"final KL {final:.4f}, {seconds:.3f} s, {fit_launches} kernel "
          "launches")
    check(fit_launches > 0, "the fit did not launch the kernel")
    check(n_iterations < 10000, "the fit ran into the iteration cap")
    check(W.shape == (5, 96) and model.adata.obsm["exposures"].shape
          == (192, 5), "fitted shapes")
    check(bool(np.isfinite(W).all()
               and np.isfinite(model.adata.obsm["exposures"]).all()),
          "non-finite parameters")
    check(np.allclose(W.sum(axis=1), 1.0, atol=1e-4),
          "signatures do not sum to one")

    reference = sal.KLNMF(n_signatures=5, device="cuda", dtype="float32")
    reference._setup_adata(adata())
    reference._initialize()
    reference._setup_fitting_parameters()
    params0, data = reference._device_state()
    update_fn, objective_fn = reference._build_step()
    objective_fn = promote_objective(objective_fn, params0)
    X = data["X"]

    def plain_block(params, n_steps):
        W_new, H_new = cuda_klnmf.fused_mu_block_reference(
            X, params["W"][None], params["H"][None], n_steps)
        return {"W": W_new[0], "H": H_new[0]}

    start = time.perf_counter()
    result = fit_loop(lambda p: update_fn(p, data),
                      lambda p: objective_fn(p, data), params0,
                      reference._fit_config(), block_update_fn=plain_block)
    plain_seconds = time.perf_counter() - start
    plain_final = float(result.history[result.n_evals - 1])
    print(f"[4] same fit, plain block: {result.n_iterations} iterations, "
          f"final KL {plain_final:.4f}, {plain_seconds:.3f} s")
    check(abs(final - plain_final) <= FIT_RTOL * abs(plain_final),
          "final objective differs from the plain fit")
    check(abs(n_iterations - result.n_iterations)
          <= 0.05 * result.n_iterations,
          "iteration count differs from the plain fit by over 5%")


def phase_headline(torch, sal, cuda_klnmf, random_init_batch, X_host):
    from salamander_tpu_torch.engine import FitConfig, fit_loop_lockstep
    from salamander_tpu_torch.ops.klnmf import make_step_functions

    R, K = 100, 5
    config = FitConfig(WINDOW, WINDOW, BLOCK, 1e-7)
    _, objective_fn = make_step_functions()
    X = torch.as_tensor(X_host, dtype=torch.float32, device="cuda")
    data = {"X": X}

    def kernel_run():
        result = sal.fit_klnmf_restarts(X_host, K, R, seed=0, config=config,
                                        device="cuda")
        return result.losses, result.n_iterations

    def plain_run():
        generator = torch.Generator(device="cuda").manual_seed(0)
        W0, H0 = random_init_batch(generator, X, K, R, torch.float32)

        def block(params, n_steps):
            W, H = cuda_klnmf.fused_mu_block_reference(
                X, params["W"], params["H"], n_steps)
            return {"W": W, "H": H}

        result = fit_loop_lockstep(lambda p: objective_fn(p, data),
                                   {"W": W0, "H": H0}, config, block)
        losses = objective_fn(result.params, data)
        return losses.cpu().numpy(), result.n_iterations.cpu().numpy()

    rates, best = {}, {}
    for name, run in (("kernel", kernel_run), ("plain", plain_run)):
        seconds = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            losses, n_iterations = run()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
        check(bool(np.isfinite(losses).all()), f"{name}: non-finite losses")
        check(bool((n_iterations == WINDOW).all()),
              f"{name}: every lane runs the {WINDOW}-iteration window")
        best[name] = float(np.min(losses))
        rates[name] = R * WINDOW / min(seconds)
        print(f"[5] {name} path: best-of-{R} KL {best[name]:.4f}, "
              f"{min(seconds):.4f} s best of 3 "
              f"({', '.join(f'{s:.4f}' for s in seconds)}), "
              f"{rates[name]:.1f} aggregate MU it/s")
    check(abs(best["kernel"] - SBS_BEST_OF_100)
          <= FIT_RTOL * SBS_BEST_OF_100,
          f"best-of-100 loss {best['kernel']} not within 1e-4 of 20414")
    check(abs(best["kernel"] - best["plain"]) <= FIT_RTOL * best["plain"],
          "kernel and plain best-of-100 losses differ")
    return rates


def timed(torch, fn):
    """(result, seconds) of fn() on the host clock, ending in a sync."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - start


def sbs_adata(sal):
    return sal.AnnData(sal.datasets.load_pcawg_sbs())


def check_best_agree(name: str, a: float, b: float) -> None:
    check(abs(a - b) <= FIT_RTOL * abs(b),
          f"{name}: best losses {a} and {b} differ by more than {FIT_RTOL}")


def phase_quickstart(torch, sal, cuda_klnmf):
    """The README quick start: fit_best_of(KLNMF(5, random), PCAWG SBS,
    n_restarts=100, base_seed=0), compacted and monolithic in turns, and
    the same lanes through the plain block from the same params0."""
    from salamander_tpu_torch.engine import fit_loop_lockstep
    from salamander_tpu_torch.models.signature_nmf import promote_objective
    from salamander_tpu_torch.parallel.multistart import _device_init_batch

    def model():
        return sal.KLNMF(n_signatures=5, init_method="random",
                         device="cuda", dtype="float32")

    walls = {True: [], False: []}
    best = {}
    for compact in (True, False, False, True):
        before = cuda_klnmf.fused_mu_block.launches
        summary, seconds = timed(torch, lambda: sal.fit_best_of(
            model(), sbs_adata(sal), n_restarts=100, base_seed=0,
            compact=compact))
        launches = cuda_klnmf.fused_mu_block.launches - before
        check(launches > 0, f"fit_best_of(compact={compact}) launched no "
              "kernel")
        check(bool(np.isfinite(summary.losses).all()), "non-finite losses")
        walls[compact].append(seconds)
        best[compact] = float(summary.losses.min())
        print(f"[6] fit_best_of(KLNMF(5), R=100, compact={compact}): "
              f"{seconds:.4f} s, best KL {best[compact]:.4f}, iterations "
              f"{summary.n_iterations.min()}..{summary.n_iterations.max()} "
              f"(mean {summary.n_iterations.mean():.1f}), {launches} "
              "kernel launches")
    check_best_agree("[6] compacted vs monolithic", best[True], best[False])

    reference = model()
    reference._setup_adata(sbs_adata(sal))
    reference._initialize(init_kwargs={"seed": 0})
    reference._setup_fitting_parameters()
    _, data = reference._device_state()
    params0 = _device_init_batch(reference, data, 100, 0)
    _, objective_fn = reference._build_step()
    objective_fn = promote_objective(objective_fn, params0)

    def plain_block(params, n_steps):
        W, H = cuda_klnmf.fused_mu_block_reference(
            data["X"], params["W"], params["H"], n_steps)
        return {"W": W, "H": H}

    result, seconds = timed(torch, lambda: fit_loop_lockstep(
        lambda p: objective_fn(p, data), params0, reference._fit_config(),
        plain_block))
    plain_best = float(objective_fn(result.params, data).min())
    print(f"[6] the same lanes, plain block: {seconds:.4f} s, best KL "
          f"{plain_best:.4f}")
    check_best_agree("[6] kernel vs plain", best[False], plain_best)
    print(f"[6] walls: compacted {', '.join(f'{s:.4f}' for s in walls[True])}"
          f" s; monolithic {', '.join(f'{s:.4f}' for s in walls[False])} s")


def phase_mvnmf(torch, sal):
    """MvNMF(5).fit on PCAWG SBS in float32 (line-search trials counted),
    the cost of one trial round, and fit_best_of(MvNMF(5, random), R=10)
    compacted and monolithic, one run each."""
    from salamander_tpu_torch.ops import mvnmf as mv_ops

    trials = [0]
    real = mv_ops._renormalized_objective

    def counting(*args):
        trials[0] += 1
        return real(*args)

    mv_ops._renormalized_objective = counting
    try:
        model = sal.MvNMF(n_signatures=5, device="cuda", dtype="float32")
        _, seconds = timed(torch, lambda: model.fit(sbs_adata(sal)))
    finally:
        mv_ops._renormalized_objective = real
    n_iterations = model.history["n_iterations"]
    W = model.asignatures.X
    print(f"[7] MvNMF(n_signatures=5).fit: {n_iterations} iterations, final "
          f"objective {model.history['objective_function'][-1]:.4f}, "
          f"{seconds:.3f} s, {trials[0]} line-search evaluations "
          f"({trials[0] / n_iterations:.3f} per iteration)")
    check(n_iterations < 10000, "the MvNMF fit ran into the iteration cap")
    check(bool(np.isfinite(W).all()
               and np.isfinite(model.adata.obsm["exposures"]).all()),
          "non-finite MvNMF parameters")
    check(np.allclose(W.sum(axis=1), 1.0, atol=1e-4),
          "MvNMF signatures do not sum to one")

    params, data = model._device_state()
    for lanes in (1, 50):
        # columns summing to 0.5: every renormalized trial is worse, so the
        # search backtracks 166 rounds to the gamma floor
        W_half = (0.5 * params["W"]).expand(lanes, -1, -1).contiguous()
        H_double = (2.0 * params["H"]).expand(lanes, -1, -1).contiguous()
        gamma = torch.ones(lanes, dtype=torch.float32, device="cuda")

        def search():
            return mv_ops.line_search(data["X"], W_half, H_double,
                                      model.lam, model.delta, gamma, W_half)

        search()
        (_, _, g), seconds = timed(torch, search)
        check(bool((g < 1.2e-16).all()), "the search did not reach the floor")
        print(f"[7] one line-search trial round at R={lanes}: "
              f"{1000 * seconds / 166:.4f} ms (166 rounds in "
              f"{seconds:.4f} s)")

    walls = {True: [], False: []}
    best = {}
    # one run of each layout at R=10: the whole script, phase 16 included,
    # stays near ten minutes
    mv_restarts = 10
    for compact in (True, False):
        trials[0] = 0
        mv_ops._renormalized_objective = counting
        try:
            summary, seconds = timed(torch, lambda: sal.fit_best_of(
                sal.MvNMF(n_signatures=5, init_method="random",
                          device="cuda", dtype="float32"),
                sbs_adata(sal), n_restarts=mv_restarts, base_seed=0,
                compact=compact))
        finally:
            mv_ops._renormalized_objective = real
        check(bool(np.isfinite(summary.losses).all()), "non-finite losses")
        walls[compact].append(seconds)
        best[compact] = float(summary.losses.min())
        print(f"[7] fit_best_of(MvNMF(5), R={mv_restarts}, "
              f"compact={compact}): "
              f"{seconds:.3f} s, best objective {best[compact]:.4f}, "
              f"iterations {summary.n_iterations.min()}.."
              f"{summary.n_iterations.max()} "
              f"(mean {summary.n_iterations.mean():.1f}), {trials[0]} "
              "batched line-search evaluations")
    check_best_agree("[7] compacted vs monolithic", best[True], best[False])
    print(f"[7] walls: compacted {', '.join(f'{s:.3f}' for s in walls[True])}"
          f" s; monolithic {', '.join(f'{s:.3f}' for s in walls[False])} s")


def phase_scan(torch, sal, cuda_klnmf, X_host):
    """rank_scan_klnmf(X, range(2, 11), 20, seed=0) in every layout, one
    run each; best loss per rank against the unpadded scan at rtol 1e-4."""
    layouts = {
        "unpadded": dict(pad_ranks=False, compact=False),
        "unpadded compacted": dict(pad_ranks=False, compact=True),
        "padded packed": dict(pad_ranks=True, pack_points=True),
        "padded per point": dict(pad_ranks=True, pack_points=False),
    }
    walls = {name: [] for name in layouts}
    best = {}
    for name in layouts:  # one run each
        before = cuda_klnmf.fused_mu_block.launches
        results, seconds = timed(torch, lambda: sal.rank_scan_klnmf(
            X_host, range(2, 11), 20, seed=0, device="cuda",
            **layouts[name]))
        launches = cuda_klnmf.fused_mu_block.launches - before
        walls[name].append(seconds)
        best[name] = {k: result.best_loss for k, result in results.items()}
        print(f"[8] rank_scan_klnmf k=2..10 R=20 {name}: {seconds:.3f} s, "
              f"{launches} kernel launches, best per rank "
              + ", ".join(f"{k}:{loss:.2f}" for k, loss in best[name].items()))
        if name.startswith("unpadded"):
            check(launches > 0, f"the {name} scan launched no kernel")
        else:
            check(launches == 0, "the padded scan has no kernel to launch")
    for name in layouts:
        for k, loss in best[name].items():
            check_best_agree(f"[8] {name} k={k}", loss, best["unpadded"][k])
    print("[8] walls: " + "; ".join(
        f"{name} {', '.join(f'{s:.3f}' for s in walls[name])} s"
        for name in layouts))


def elbo_trace_check(trace) -> float:
    """The largest fall of a maximized objective trace, relative to the
    value it fell from; checks it stays within float32 noise."""
    trace = np.asarray(trace, dtype=float)
    falls = (trace[:-1] - trace[1:]) / np.abs(trace[:-1])
    worst = float(max(falls.max(), 0.0)) if falls.size else 0.0
    check(worst <= F32_NOISE, f"the ELBO fell by {worst:.3e} relative")
    return worst


def phase_corrnmf(torch, sal):
    """CorrNMFDet(5, dim_embeddings=2).fit on PCAWG SBS in float32, then
    fit_best_of(R=16) compacted and monolithic, one run each."""
    from salamander_tpu_torch.ops import corrnmf as corr_ops

    calls = {"steps": 0, "solves": 0}
    real_step, real_update = corr_ops._newton_step, corr_ops.update_embeddings

    def counting_step(*args):
        calls["steps"] += 1
        return real_step(*args)

    def counting_update(*args, **kwargs):
        calls["solves"] += 1
        return real_update(*args, **kwargs)

    hyper = dict(n_signatures=5, dim_embeddings=2, min_iterations=100,
                 tol=1e-7, device="cuda", dtype="float32")
    np.random.seed(0)
    model = sal.CorrNMFDet(max_iterations=2000, **hyper)
    corr_ops._newton_step = counting_step
    corr_ops.update_embeddings = counting_update
    try:
        _, seconds = timed(torch, lambda: model.fit(sbs_adata(sal)))
    finally:
        corr_ops._newton_step = real_step
        corr_ops.update_embeddings = real_update
    cycles = model.history["n_iterations"]
    trace = model.history["objective_function"]
    final = float(trace[-1])
    check(calls["solves"] == 2 * cycles, "one Newton solve per side and cycle")
    signature_steps = (calls["steps"] - 3 * cycles) / cycles
    worst = elbo_trace_check(trace)
    check(np.isfinite(final), "non-finite ELBO")
    check(bool(np.isfinite(model.asignatures.X).all()
               and np.isfinite(model.adata.obsm["embeddings"]).all()),
          "non-finite CorrNMF parameters")
    print(f"[9] CorrNMFDet(5, dim_embeddings=2).fit: {cycles} EM cycles, "
          f"{seconds:.3f} s, {cycles / seconds:.1f} cycles/s, final ELBO "
          f"{final:.4f}, {signature_steps:.3f} signature-side Newton steps "
          f"per cycle, largest ELBO fall {worst:.3e} relative")

    walls = {True: [], False: []}
    best = {}
    for compact in (True, False):
        summary, seconds = timed(torch, lambda: sal.fit_best_of(
            sal.CorrNMFDet(init_method="random", max_iterations=500,
                           **hyper),
            sbs_adata(sal), n_restarts=16, base_seed=0, compact=compact))
        check(bool(np.isfinite(summary.losses).all()), "non-finite ELBOs")
        walls[compact].append(seconds)
        best[compact] = float(summary.losses.max())
        print(f"[9] fit_best_of(CorrNMFDet(5), R=16, compact={compact}): "
              f"{seconds:.3f} s, best ELBO {best[compact]:.4f}, cycles "
              f"{summary.n_iterations.min()}..{summary.n_iterations.max()} "
              f"(mean {summary.n_iterations.mean():.1f})")
    check_best_agree("[9] compacted vs monolithic", best[True], best[False])
    print(f"[9] walls: compacted {', '.join(f'{s:.3f}' for s in walls[True])}"
          f" s; monolithic {', '.join(f'{s:.3f}' for s in walls[False])} s")


def phase_ardnmf(torch, sal):
    """ARDNMF(20, a=5) rank inference on the planted-rank-8 synthetic
    96 x 10,000 catalog: one fit, then fit_best_of(R=8) compacted and
    monolithic."""
    X = sal.datasets.synthetic_catalog(96, 10_000, 8, seed=0)

    def adata():
        return sal.AnnData(X.T.copy())

    hyper = dict(n_signatures=20, a=5.0, min_iterations=500,
                 max_iterations=20000, device="cuda", dtype="float32")
    model = sal.ARDNMF(**hyper)
    _, seconds = timed(torch, lambda: model.fit(adata(),
                                                init_kwargs={"seed": 1}))
    n_iterations = model.history["n_iterations"]
    final = float(model.history["objective_function"][-1])
    print(f"[10] ARDNMF(20, a=5).fit on 96 x 10,000 (planted rank 8): "
          f"{n_iterations} iterations, {seconds:.3f} s, "
          f"{n_iterations / seconds:.1f} it/s, final objective {final:.4f}, "
          f"inferred rank {model.n_active_signatures}")
    check(np.isfinite(final), "non-finite ARD objective")
    check(model.n_active_signatures == 8, "the single fit missed rank 8")

    best = {}
    for compact in (True, False):
        multi = sal.ARDNMF(init_method="random", **hyper)
        summary, seconds = timed(torch, lambda: sal.fit_best_of(
            multi, adata(), n_restarts=8, base_seed=0, compact=compact))
        check(bool(np.isfinite(summary.losses).all()), "non-finite losses")
        best[compact] = float(summary.losses.min())
        print(f"[10] fit_best_of(ARDNMF(20), R=8, compact={compact}): "
              f"{seconds:.3f} s, best objective {best[compact]:.4f}, "
              f"iterations {summary.n_iterations.min()}.."
              f"{summary.n_iterations.max()}, inferred rank "
              f"{multi.n_active_signatures}")
        check(multi.n_active_signatures == 8,
              f"best-of-8 (compact={compact}) missed rank 8")
    check_best_agree("[10] compacted vs monolithic", best[True], best[False])


def phase_corrnmf_scan(torch, sal, X_samples):
    """rank_scan_corrnmf(PCAWG SBS, range(2, 8), 4 restarts, m=2) over a
    fixed 100-cycle window in every layout, one run each."""
    from salamander_tpu_torch.engine import FitConfig

    layouts = {
        "unpadded": dict(pad_ranks=False),
        "padded packed": dict(pad_ranks=True, pack_points=True),
        "padded per point": dict(pad_ranks=True, pack_points=False),
    }
    walls = {name: [] for name in layouts}
    best = {}
    for name in layouts:  # one run each
        results, seconds = timed(torch, lambda: sal.rank_scan_corrnmf(
            X_samples, range(2, 8), dim_embeddings=2, n_restarts=4,
            config=FitConfig(100, 100, BLOCK, 1e-7), device="cuda",
            dtype="float32", **layouts[name]))
        walls[name].append(seconds)
        best[name] = {k: result.best_loss for k, result in results.items()}
        check(all(np.isfinite(loss) for loss in best[name].values()),
              "non-finite scan ELBO")
        print(f"[11] rank_scan_corrnmf k=2..7 R=4 m=2 {name}: "
              f"{seconds:.3f} s, best ELBO per rank "
              + ", ".join(f"{k}:{loss:.2f}" for k, loss in best[name].items()))
    for name in layouts:
        for k, loss in best[name].items():
            check_best_agree(f"[11] {name} k={k}", loss, best["unpadded"][k])
    print("[11] walls: " + "; ".join(
        f"{name} {', '.join(f'{s:.3f}' for s in walls[name])} s"
        for name in layouts))


def per_lane_launches(cuda_klnmf) -> int:
    return cuda_klnmf.fused_mu_block.launches_by_x["per_lane"]


def phase_extraction(torch, sal, cuda_klnmf):
    """Cell 7: extract_signatures(PCAWG SBS, range(2, 11), n_bootstraps=20,
    seed=0) in the grouped layout (each rank's lanes through the kernel
    with a per-lane X) and the padded one (one rank-masked batch of plain
    ops), one run each; each rank's best replicate loss agrees across them
    at rtol 1e-4. Returns the grouped run's result."""
    from salamander_tpu_torch import extraction

    data = sal.datasets.load_pcawg_sbs()
    choose = extraction._choose_layout
    results, walls = {}, {"grouped": [], "padded": []}
    for layout in ("grouped", "padded"):  # one run each
        if layout == "padded":
            extraction._choose_layout = lambda *args: "padded"
        launches, per_lane = (cuda_klnmf.fused_mu_block.launches,
                              per_lane_launches(cuda_klnmf))
        try:
            result, seconds = timed(torch, lambda: sal.extract_signatures(
                data, range(2, 11), n_bootstraps=20, seed=0, device="cuda"))
        finally:
            extraction._choose_layout = choose
        launches = cuda_klnmf.fused_mu_block.launches - launches
        per_lane = per_lane_launches(cuda_klnmf) - per_lane
        check(result.layout == layout, f"ran {result.layout}, not {layout}")
        if layout == "grouped":
            check(launches > 0 and per_lane == launches,
                  "the grouped extraction did not launch the kernel with a "
                  "per-lane X")
        else:
            check(launches == 0, "the padded extraction has no kernel")
        table = result.table
        check(bool(np.isfinite(table.to_numpy()).all()),
              "non-finite extraction table")
        iterations = np.concatenate(list(
            result.replicate_iterations.values()))
        walls[layout].append(seconds)
        results[layout] = result
        print(f"[12] extract_signatures(PCAWG SBS, k=2..10, B=20) {layout}: "
              f"{seconds:.3f} s, {launches} kernel launches ({per_lane} with "
              f"a per-lane X), lane iterations {iterations.min()}.."
              f"{iterations.max()} (sum {iterations.sum()}), suggested rank "
              f"{result.suggested_rank}")
        print(f"[12] {layout} min stability per rank: " + ", ".join(
            f"{k}:{s:.4f}" for k, s in table["min_stability"].items()))
        print(f"[12] {layout} best replicate loss per rank: " + ", ".join(
            f"{k}:{losses.min():.3f}"
            for k, losses in result.replicate_losses.items()))
    grouped, padded = results["grouped"], results["padded"]
    for k in grouped.replicate_losses:
        check_best_agree(f"[12] k={k} grouped vs padded",
                         float(grouped.replicate_losses[k].min()),
                         float(padded.replicate_losses[k].min()))
    print("[12] walls: " + "; ".join(
        f"{name} {', '.join(f'{s:.3f}' for s in walls[name])} s"
        for name in walls))
    return grouped


def phase_assignment(torch, sal, consensus):
    """Cell 8: assign_exposures and assign_signatures(rel_tol=0.02) of PCAWG
    SBS against COSMIC v3.3.1 (79 signatures), then decompose_signatures
    of the extraction's rank-5 consensus. Fails on any sample over the
    reported budget."""
    data = sal.datasets.load_pcawg_sbs()
    catalog = sal.datasets.load_cosmic_sbs_catalog()
    dense, seconds = timed(torch, lambda: sal.assign_exposures(
        data, catalog, device="cuda"))
    check(dense.shape == (data.shape[0], catalog.shape[0])
          and bool(np.isfinite(dense.to_numpy()).all()), "dense exposures")
    print(f"[13] assign_exposures(PCAWG SBS x COSMIC-79): {seconds:.3f} s")
    rel_tol = 0.02
    result, seconds = timed(torch, lambda: sal.assign_signatures(
        data, catalog, rel_tol=rel_tol, device="cuda"))
    kl_dense = result.kl_dense.to_numpy()
    kl_sparse = result.kl_sparse.to_numpy()
    over = int(np.sum(kl_sparse > (1.0 + rel_tol) * kl_dense))
    support = result.n_active.to_numpy()
    print(f"[13] assign_signatures(rel_tol={rel_tol}): {seconds:.3f} s, "
          f"{result.meta['n_rounds']} rounds, mean support "
          f"{support.mean():.3f} ({support.min()}..{support.max()}) of 79, "
          f"{len(result.assigned_signatures())} signatures used, {over} "
          "samples over the budget, mean kl_sparse / kl_dense "
          f"{np.mean(kl_sparse / kl_dense):.6f}")
    check(bool(np.isfinite(kl_sparse).all()), "non-finite kl_sparse")
    check(over == 0, f"{over} samples over the reported budget")
    exposures = result.exposures.to_numpy()
    check(bool((exposures[~result.active.to_numpy()] == 0).all()),
          "exposures off the support")
    decomposition, seconds = timed(torch, lambda: sal.tools
                                   .decompose_signatures(consensus, catalog,
                                                         device="cuda"))
    check(bool(np.isfinite(decomposition.weights.to_numpy()).all()),
          "non-finite decomposition")
    print(f"[13] decompose_signatures(rank-5 consensus): {seconds:.3f} s, "
          f"{decomposition!r}")
    for name, row in decomposition.weights.iterrows():
        parts = row[row > 0].sort_values(ascending=False)
        print(f"[13] {name} = " + " + ".join(
            f"{w:.3f}*{c}" for c, w in parts.iloc[:4].items())
            + f" + ... ({len(parts)} components)")


def phase_bootstrap(torch, sal, cuda_klnmf):
    """bootstrap_stability(KLNMF(5).fit(PCAWG SBS), 20): the replicates
    through the kernel with a per-lane X, then through the plain block;
    best loss at rtol 1e-4. Then bootstrap_exposures(PCAWG SBS, COSMIC-79,
    50)."""
    model = sal.KLNMF(n_signatures=5, device="cuda", dtype="float32")
    model.fit(sbs_adata(sal))
    KLNMF = type(model)
    fused = KLNMF._block_update_fn
    best, walls = {}, {}
    for route in ("kernel", "plain"):
        if route == "plain":
            KLNMF._block_update_fn = lambda self, *args: None
        launches = per_lane_launches(cuda_klnmf)
        try:
            result, seconds = timed(torch, lambda: sal.bootstrap_stability(
                model, 20))
        finally:
            KLNMF._block_update_fn = fused
        launches = per_lane_launches(cuda_klnmf) - launches
        if route == "kernel":
            check(launches > 0, "bootstrap_stability did not launch the "
                  "kernel with a per-lane X")
        check(bool(np.isfinite(result.losses).all()), "non-finite losses")
        best[route], walls[route] = float(result.losses.min()), seconds
        print(f"[14] bootstrap_stability(KLNMF(5), 20) {route}: "
              f"{seconds:.3f} s, {launches} per-lane kernel launches, best "
              f"loss {best[route]:.4f}, stability " + ", ".join(
                  f"{s:.4f}" for s in result.stability))
    check_best_agree("[14] kernel vs plain", best["kernel"], best["plain"])
    catalog = sal.datasets.load_cosmic_sbs_catalog()
    result, seconds = timed(torch, lambda: sal.bootstrap_exposures(
        sal.datasets.load_pcawg_sbs(), catalog, 50, device="cuda"))
    check(bool(np.isfinite(result.std.to_numpy()).all()),
          "non-finite bootstrap spread")
    present = (result.presence.to_numpy() >= 0.95).sum(axis=1)
    print(f"[14] bootstrap_exposures(PCAWG SBS x COSMIC-79, 50): "
          f"{seconds:.3f} s, signatures present in >= 95% of replicates per "
          f"sample {present.mean():.3f} ({present.min()}..{present.max()})")


def pcawg_mdata(sal):
    """PCAWG breast {sbs 96, indel 83, sv 32} x 192 from the vendored
    CSVs."""
    return sal.MuData({
        "sbs": sal.AnnData(sal.datasets.load_pcawg_sbs()),
        "indel": sal.AnnData(sal.datasets.load_pcawg_indel()),
        "sv": sal.AnnData(sal.datasets.load_pcawg_sv()),
    })


def synthetic_cohort(n_samples: int = 100_000) -> dict:
    """The {96, 83} x n_samples planted cohort of the JAX package's
    multimodal cohort benchmark, drawn as it draws it (default_rng(1))."""
    rng = np.random.default_rng(1)
    mods = {}
    for name, V, K in (("sbs", 96, 4), ("indel", 83, 3)):
        W = rng.dirichlet(np.ones(V) * 0.3, size=K)
        H = rng.gamma(2.0, 25.0, size=(n_samples, K))
        mods[name] = rng.poisson(H @ W).astype(np.float32) + np.float32(1.0)
    return mods


def device_busy(torch, fn, n_cycles: int, top: int = 0):
    """Device busy share of fn(): fn runs once on the host clock, then once
    under torch.profiler (CUDA activity only; its wall is not used, since
    tracing thousands of launches slows the host). Returns a dict: busy
    (device time of the traced run over the untraced wall), kernels and
    wall_ms and device_ms per cycle, and the `top` kernels by device time
    as (name, share of device time); None when the profiler saw no
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    _, wall = timed(torch, fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [event for event in prof.events()
               if event.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(event.device_time for event in kernels)  # microseconds
    if not kernels or device_us <= 0:
        return None
    by_name: dict[str, float] = {}
    for event in kernels:
        by_name[event.name] = by_name.get(event.name, 0.0) + event.device_time
    ranked = sorted(by_name.items(), key=lambda item: -item[1])[:top]
    return {
        "busy": device_us / 1e6 / wall,
        "kernels": len(kernels) / n_cycles,
        "wall_ms": 1000 * wall / n_cycles,
        "device_ms": device_us / 1000 / n_cycles,
        "top": [(name[:60], time_us / device_us) for name, time_us in ranked],
    }


def print_busy(tag: str, label: str, busy, unit: str = "cycle") -> None:
    """One device_busy reading, with its kernels by device time."""
    if busy is None:
        print(f"[{tag}] {label}: torch.profiler recorded no device time: "
              "busy share not measured")
        return
    print(f"[{tag}] {label}, untraced wall against traced device time: "
          f"device busy {100 * busy['busy']:.1f}%, {busy['kernels']:.0f} "
          f"kernels a {unit}, {busy['wall_ms']:.3f} ms of wall and "
          f"{busy['device_ms']:.3f} ms of device time a {unit}")
    for name, share in busy["top"]:
        print(f"[{tag}]   {100 * share:5.1f}% of device time: {name}")


def phase_multimodal(torch, sal):
    """MultimodalCorrNMF: the PCAWG breast fit, its best-of-16 in both
    layouts, the 100,000-sample cohort best-of-4, the joint bootstrap and
    the cycle's device busy share. Float32 on the card, plain ops."""
    from salamander_tpu_torch.ops import corrnmf as corr_ops

    hyper = dict(ns_signatures=[5, 4, 3], dim_embeddings=3,
                 min_iterations=100, device="cuda", dtype="float32")
    calls = {"steps": 0}
    real_step = corr_ops._newton_step

    def counting_step(*args):
        calls["steps"] += 1
        return real_step(*args)

    np.random.seed(0)
    model = sal.MultimodalCorrNMF(max_iterations=1000, **hyper)
    corr_ops._newton_step = counting_step
    try:
        _, seconds = timed(torch, lambda: model.fit(pcawg_mdata(sal)))
    finally:
        corr_ops._newton_step = real_step
    cycles = model.history["n_iterations"]
    trace = model.history["objective_function"]
    final = float(trace[-1])
    worst = elbo_trace_check(trace)
    check(np.isfinite(final), "non-finite ELBO")
    absorbed = model.objective_function()
    check(cycles % BLOCK != 0
          or abs(final - absorbed) <= 1e-5 * abs(absorbed),
          f"final ELBO {final} is not objective_function() {absorbed} on "
          "the absorbed state")
    for name in model.mod_names:
        check(bool(np.isfinite(model.asignatures[name].X).all()
                   and np.isfinite(model.mdata[name].obsm["exposures"]).all()),
              f"non-finite {name} parameters")
    signature_steps = (calls["steps"] - 3 * cycles) / cycles
    print(f"[15] MultimodalCorrNMF([5, 4, 3], dim_embeddings=3).fit on "
          f"PCAWG sbs/indel/sv x {model.mdata.n_obs}: {cycles} EM cycles, "
          f"{seconds:.3f} s, {cycles / seconds:.1f} cycles/s, final ELBO "
          f"{final:.4f} (objective_function() {absorbed:.4f}), "
          f"{signature_steps:.3f} signature-side Newton steps per cycle "
          f"over the 3 modalities, largest ELBO fall {worst:.3e} relative, "
          f"variance {model.variance:.4f}")

    walls = {True: [], False: []}
    best = {}
    for compact in (True, False):
        summary, seconds = timed(torch, lambda: sal.fit_best_of(
            sal.MultimodalCorrNMF(init_method="random", max_iterations=500,
                                  tol=1e-7, **hyper),
            pcawg_mdata(sal), n_restarts=16, base_seed=0, compact=compact))
        check(bool(np.isfinite(summary.losses).all()), "non-finite ELBOs")
        walls[compact].append(seconds)
        best[compact] = float(summary.losses.max())
        print(f"[15] fit_best_of(MultimodalCorrNMF, R=16, compact="
              f"{compact}): {seconds:.3f} s, best ELBO {best[compact]:.4f}, "
              f"cycles {summary.n_iterations.min()}.."
              f"{summary.n_iterations.max()} (mean "
              f"{summary.n_iterations.mean():.1f}), "
              f"{summary.n_iterations.sum() / seconds:.1f} aggregate "
              "cycles/s")
    check_best_agree("[15] compacted vs monolithic", best[True], best[False])
    print(f"[15] walls: compacted "
          f"{', '.join(f'{s:.3f}' for s in walls[True])} s; monolithic "
          f"{', '.join(f'{s:.3f}' for s in walls[False])} s")

    # the cohort cell: reckon the bytes before running
    D, R, sum_k, n_backtrack = 100_000, 4, 7, 41
    x_bytes = 4 * D * (96 + 83)
    candidate_bytes = 4 * D * n_backtrack * sum_k
    print(f"[15] cohort {{96, 83}} x {D}: X {x_bytes / 1e6:.1f} MB "
          f"(float64 for an ELBO evaluation {2 * x_bytes / 1e6:.1f} MB); the "
          f"joint sample Newton step's Armijo candidates (R, D, "
          f"{n_backtrack}, {sum_k}) float32 {candidate_bytes / 1e6:.1f} MB a "
          f"lane, {R * candidate_bytes / 1e6:.1f} MB for R={R}")
    cohort, seconds = timed(torch, synthetic_cohort)
    print(f"[15] cohort drawn on the host in {seconds:.3f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cohort_model = sal.MultimodalCorrNMF(
        ns_signatures=[4, 3], dim_embeddings=3, init_method="random",
        min_iterations=100, max_iterations=100, conv_test_freq=10, tol=1e-6,
        device="cuda", dtype="float32")
    summary, seconds = timed(torch, lambda: sal.fit_best_of(
        cohort_model,
        sal.MuData({k: sal.AnnData(v.copy()) for k, v in cohort.items()}),
        R, base_seed=0))
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.isfinite(summary.losses).all()),
          "non-finite cohort ELBOs")
    check(peak < 40e9, f"the cohort cell allocated {peak / 1e9:.1f} GB")
    total = int(summary.n_iterations.sum())
    print(f"[15] fit_best_of(MultimodalCorrNMF([4, 3]), cohort, R={R}): "
          f"{seconds:.3f} s, {total} joint cycles "
          f"({summary.n_iterations.min()}..{summary.n_iterations.max()}), "
          f"{total / seconds:.1f} aggregate joint cycles/s, best ELBO "
          f"{float(summary.losses.max()):.1f}, peak allocated "
          f"{peak / 1e9:.3f} GB")
    cohort_cycles = 20

    def cohort_probe():
        sal.fit_best_of(
            sal.MultimodalCorrNMF(
                ns_signatures=[4, 3], dim_embeddings=3, init_method="random",
                min_iterations=cohort_cycles, max_iterations=cohort_cycles,
                tol=1e-6, device="cuda", dtype="float32"),
            sal.MuData({k: sal.AnnData(v.copy()) for k, v in cohort.items()}),
            R, base_seed=0)

    included = "(set-up, init and the float64 ELBO evaluations included)"
    print_busy("15", f"cohort best-of-{R} under torch.profiler, "
               f"{cohort_cycles} cycles {included}",
               device_busy(torch, cohort_probe, cohort_cycles, top=6))
    del cohort, cohort_model, summary
    torch.cuda.empty_cache()

    n_replicates = 4
    model.max_iterations = 500  # the replicates' cap; the fit above ran 1000
    result, seconds = timed(torch, lambda: sal.bootstrap_stability(
        model, n_replicates))
    model.max_iterations = 1000
    check(bool(np.isfinite(result.losses).all()),
          "non-finite bootstrap ELBOs")
    columns = list(result.similarities.columns)
    offset, per_mod = 0, []
    for name, k in zip(model.mod_names, model.ns_signatures):
        share = result.stability.iloc[offset:offset + k]
        check(list(share.index) == columns[offset:offset + k]
              and all(label.startswith(name) for label in share.index),
              f"stability columns of {name} out of order")
        per_mod.append(f"{name} {share.mean():.4f}")
        offset += k
    print(f"[15] bootstrap_stability(MultimodalCorrNMF, {n_replicates}): "
          f"{seconds:.3f} s, "
          f"mean stability " + ", ".join(per_mod) + f", best ELBO "
          f"{float(result.losses.max()):.4f}")

    probe_cycles = 50
    probe = sal.MultimodalCorrNMF(
        max_iterations=probe_cycles,
        **dict(hyper, min_iterations=probe_cycles))

    def pcawg_probe():
        np.random.seed(0)
        probe.fit(pcawg_mdata(sal))

    print_busy("15", f"PCAWG fit under torch.profiler, {probe_cycles} "
               f"cycles {included}",
               device_busy(torch, pcawg_probe, probe_cycles, top=4))


def fitted_arrays(model) -> dict:
    """Every absorbed parameter of a fitted model, by name."""
    if hasattr(model, "mdata"):
        out = {"embeddings": model.mdata.obsm["embeddings"],
               "variance": np.asarray(model.variance)}
        for name in model.mod_names:
            asigs, adata = model.asignatures[name], model.mdata[name]
            out.update({
                f"{name}/signatures": asigs.X,
                f"{name}/signature_scalings": np.asarray(
                    asigs.obs["scalings"]),
                f"{name}/signature_embeddings": asigs.obsm["embeddings"],
                f"{name}/sample_scalings": np.asarray(adata.obs["scalings"]),
                f"{name}/exposures": adata.obsm["exposures"],
            })
        return out
    out = {"signatures": model.asignatures.X,
           "exposures": model.adata.obsm["exposures"]}
    if hasattr(model, "variance"):
        out.update({
            "signature_scalings": np.asarray(
                model.asignatures.obs["scalings"]),
            "signature_embeddings": model.asignatures.obsm["embeddings"],
            "sample_scalings": np.asarray(model.adata.obs["scalings"]),
            "sample_embeddings": model.adata.obsm["embeddings"],
            "variance": np.asarray(model.variance),
        })
    return out


def check_bit_equal(torch, label: str, a: dict, b: dict) -> None:
    check(list(a) == list(b), f"{label}: parameter names differ")
    for name in a:
        check(torch.equal(torch.as_tensor(np.array(a[name])),
                          torch.as_tensor(np.array(b[name]))),
              f"{label}: {name} is not bit-equal")


TRACE_RTOL = 1e-5  # the chunked objective sums in another order, float32


def float_counts(sal, adata):
    """The container with its counts as floats: a streaming fit leaves an
    integer matrix unclipped on the host, its initializer included, so
    only float counts start both placements from the same parameters."""
    return sal.AnnData(adata.to_df().astype(float))


def phase_svi_equality(torch, sal):
    """fit_minibatch resident against streaming at one seed, float32 on
    the card, for the three families on the PCAWG data: every absorbed
    parameter bit-equal, traces at rtol 1e-5, prefetch 1, 2 and 4 equal."""
    import functools

    from salamander_tpu_torch.ops import svi

    weights = np.random.default_rng(9).uniform(0.5, 2.0, 192)
    families = {
        "KLNMF(5), weights_kl and weights_lhalf": (
            lambda: sal.KLNMF(n_signatures=5, device="cuda",
                              dtype="float32"),
            lambda: float_counts(sal, sbs_adata(sal)),
            dict(fitting_kwargs={"weights_kl": weights.copy(),
                                 "weights_lhalf": 0.1})),
        "CorrNMFDet(5, m=2)": (
            lambda: sal.CorrNMFDet(n_signatures=5, dim_embeddings=2,
                                   device="cuda", dtype="float32"),
            lambda: float_counts(sal, sbs_adata(sal)), {}),
        "MultimodalCorrNMF([5, 4, 3], m=3)": (
            lambda: sal.MultimodalCorrNMF(
                ns_signatures=[5, 4, 3], dim_embeddings=3, device="cuda",
                dtype="float32"),
            lambda: sal.MuData({
                name: float_counts(sal, adata)
                for name, adata in pcawg_mdata(sal).mod.items()}), {}),
    }
    real = svi.run_svi_streaming

    def fit(make_model, make_data, extra, batch_size, streaming, prefetch):
        np.random.seed(0)  # the CorrNMF embedding init draws from it
        model = make_model()
        svi.run_svi_streaming = functools.partial(real, prefetch=prefetch)
        try:
            _, seconds = timed(torch, lambda: model.fit_minibatch(
                make_data(), batch_size=batch_size, n_steps=200,
                eval_freq=50, seed=0, init_kwargs={"seed": 0},
                streaming=streaming, **extra))
        finally:
            svi.run_svi_streaming = real
        trace = np.asarray(model.history["objective_function"], dtype=float)
        check(trace.shape == (4,) and bool(np.isfinite(trace).all()),
              "the trace has 4 finite evaluations")
        return fitted_arrays(model), trace, seconds

    for label, (make_model, make_data, extra) in families.items():
        for batch_size in (48, 50):
            resident, trace_r, wall_r = fit(make_model, make_data, extra,
                                            batch_size, False, 2)
            walls = []
            for prefetch in (2, 1, 4) if batch_size == 50 else (2,):
                streamed, trace_s, wall_s = fit(make_model, make_data, extra,
                                                batch_size, True, prefetch)
                check_bit_equal(
                    torch, f"{label} B={batch_size} prefetch={prefetch}",
                    resident, streamed)
                check(bool(np.allclose(trace_s, trace_r, rtol=TRACE_RTOL,
                                       atol=0.0)),
                      f"{label} B={batch_size}: traces {trace_s} and "
                      f"{trace_r} differ by more than {TRACE_RTOL}")
                walls.append(f"prefetch {prefetch} {wall_s:.3f} s")
            for values in resident.values():
                check(bool(np.isfinite(values).all()),
                      f"{label}: non-finite parameters")
            print(f"[16a] {label} fit_minibatch B={batch_size}, 200 steps: "
                  f"resident {wall_r:.3f} s, streaming "
                  f"{', '.join(walls)}: {len(resident)} parameters "
                  f"bit-equal, traces within {TRACE_RTOL} (last "
                  f"{trace_r[-1]:.4f} against {trace_s[-1]:.4f})")


def phase_svi_cell3c(torch, sal):
    """The 96 x 200,000 synthetic cohort, CorrNMFDet k=5, m=2: full-batch
    EM cycles/s, then 2,000 minibatch steps at B=4,096 resident and
    streaming in turns."""
    from salamander_tpu_torch.models.signature_nmf import host_rows
    from salamander_tpu_torch.ops import svi

    D, B, n_steps, n_cycles = 200_000, 4096, 2000, 50
    X_host, seconds = timed(torch, lambda: np.ascontiguousarray(
        sal.datasets.synthetic_catalog(96, D, 5, seed=0).T, dtype=np.float32))
    model = sal.CorrNMFDet(n_signatures=5, dim_embeddings=2, device="cuda",
                           dtype="float32")
    np.random.seed(0)
    _, init_seconds = timed(torch, lambda: (
        model._setup_adata(sal.AnnData(X_host)),
        model._initialize(init_kwargs={"seed": 1}),
        model._setup_fitting_parameters(None)))
    X_host = model.adata.X  # float32, clipped
    check(X_host.dtype == np.float32, "the cohort's counts are float32")
    params, data = model._device_state()
    print(f"[16b] cohort 96 x {D} drawn in {seconds:.3f} s, initialized in "
          f"{init_seconds:.3f} s; X float32 {X_host.nbytes / 1e6:.1f} MB")

    update_fn, _ = model._build_step()
    torch.cuda.reset_peak_memory_stats()
    def cycles(p, n):
        for _ in range(n):
            p = update_fn(p, data)
        return p

    p = cycles(params, 1)  # warm
    p, seconds = timed(torch, lambda: cycles(p, n_cycles))
    check(bool(torch.isfinite(p["signatures"]).all()),
          "non-finite full-batch signatures")
    print(f"[16b] full-batch EM: {n_cycles} cycles in {seconds:.3f} s, "
          f"{n_cycles / seconds:.2f} cycles/s, "
          f"{n_cycles * D / seconds:.0f} sample updates/s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del p

    config = svi.SVIConfig(batch_size=B, delay=50.0)
    step_fn = svi.make_svi_step(D, config)
    core = svi.make_svi_batch_step(D, config)
    elbo0 = float(svi.full_elbo(svi.svi_init(params).params, data["X"]))
    on_card = {"X": data.pop("X")}  # dropped while a streaming run is timed

    def resident_X():
        if on_card["X"] is None:
            on_card["X"] = torch.as_tensor(X_host, device="cuda")
        return on_card["X"]

    def get_batch(indices):
        return host_rows(X_host, indices, np.float32)

    def run(placement, steps, seed, state0=None):
        generator = torch.Generator().manual_seed(seed)
        if placement == "resident":
            state, _ = svi.run_svi(
                step_fn, state0 or svi.svi_init(params), resident_X(),
                generator, steps, 0)
        else:
            state, _ = svi.run_svi_streaming(
                core, state0 or svi.svi_init(params, streaming=True),
                get_batch, D, B, generator, steps, 0, None,
                refresh_fn=svi.refresh_sample_usq)
        return state

    run("resident", 20, 5), run("streaming", 20, 5)  # warm both
    states, rates, peaks = {}, {}, {}
    for placement in ("resident", "streaming", "streaming", "resident"):
        if placement == "streaming":
            on_card["X"] = None
        else:
            resident_X()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, seconds = timed(torch, lambda: run(placement, n_steps, 1))
        peaks.setdefault(placement, []).append(
            torch.cuda.max_memory_allocated())
        rates.setdefault(placement, []).append(n_steps / seconds)
        states.setdefault(placement, []).append(state)
        check(state.step == n_steps, "the run took every step")
    X = resident_X()
    for placement, (first, second) in states.items():
        for name, leaf in first.params.items():
            check(torch.equal(leaf, second.params[name]),
                  f"two {placement} runs differ in {name}")
            check(torch.equal(leaf, states["resident"][0].params[name]),
                  f"{placement} and resident differ in {name}")
        elbo = float(svi.full_elbo(first.params, X))
        check(np.isfinite(elbo) and elbo > elbo0,
              f"{placement}: ELBO {elbo} after the steps is not above the "
              f"initial {elbo0}")
        print(f"[16b] {placement}: {n_steps} steps at B={B} (in turns r, s, "
              f"s, r): {', '.join(f'{r:.2f}' for r in rates[placement])} "
              f"steps/s, "
              f"{', '.join(f'{r * B:.0f}' for r in rates[placement])} sample "
              f"updates/s, peak allocated "
              f"{', '.join(f'{b / 1e9:.4f}' for b in peaks[placement])} GB, "
              f"ELBO {elbo:.1f} (initial {elbo0:.1f})")
    print("[16b] the four final states are bit-equal (resident and "
          "streaming, each twice)")

    # one step without a host sync: the resident step mid-epoch (a
    # reshuffle would upload the epoch order), then the core alone
    state = states["resident"][0]
    generator = torch.Generator().manual_seed(2)
    while state.cursor + B > D:
        state = step_fn(state, X, generator)
    indices = state.perm[state.cursor:state.cursor + B]
    batch = X.index_select(0, indices)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stepped = step_fn(state, X, generator)
        cored = core(state, batch, indices)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(stepped.step == state.step + 1 and all(
        torch.equal(leaf, cored.params[name])
        for name, leaf in stepped.params.items()),
        "the resident step is the core on its gathered batch")
    print("[16b] one resident step and one core step ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")

    probe_steps = 50
    for placement in ("resident", "streaming"):
        state0 = states[placement][0]
        print_busy(
            "16b", f"{placement} minibatch steps at B={B}, {probe_steps} "
            "steps under torch.profiler",
            device_busy(torch, lambda: run(placement, probe_steps, 3, state0),
                        probe_steps, top=4), "step")


def uint16_cohort(n_samples: int, n_workers: int = 8) -> np.ndarray:
    """(n_samples, 96) uint16 Poisson counts of a planted k=5 factorization
    (the draw of the JAX package's streaming demonstration: Dirichlet(1)
    signatures, gamma(2, 120) exposures), drawn in `n_workers` blocks, each
    from its own child of SeedSequence(0), in threads."""
    from concurrent.futures import ThreadPoolExecutor

    V, K = 96, 5
    W = np.random.default_rng(0).dirichlet(np.ones(V), size=K)
    X = np.empty((n_samples, V), np.uint16)
    bounds = np.linspace(0, n_samples, n_workers + 1).astype(int)

    def fill(job):
        seed, start, stop = job
        rng = np.random.default_rng(seed)
        exposures = rng.gamma(2.0, 120.0, size=(stop - start, K))
        X[start:stop] = np.minimum(rng.poisson(exposures @ W),
                                   np.iinfo(np.uint16).max)

    with ThreadPoolExecutor(n_workers) as pool:
        list(pool.map(fill, zip(np.random.SeedSequence(0).spawn(n_workers),
                                bounds[:-1], bounds[1:])))
    return X


def phase_svi_streaming_cohort(torch, sal):
    """Streaming at cohort size: uint16 host counts 2,000,000 x 96, the
    CorrNMF core at B=16,384, delay 20, 20 warm and 100 timed steps."""
    from salamander_tpu_torch.models.signature_nmf import host_rows
    from salamander_tpu_torch.ops import svi

    D, V, K, M, B = 2_000_000, 96, 5, 2, 16384
    warm_steps, timed_steps = 20, 100
    X, seconds = timed(torch, lambda: uint16_cohort(D))
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[16c] host counts {X.shape} {X.dtype}, {X.nbytes / 1e6:.1f} MB, "
          f"drawn in {seconds:.3f} s; as float32 on the card they would be "
          f"{4 * X.size / 1e6:.1f} MB of {total / 1e9:.2f} GB: this cohort is "
          "NOT beyond the card's memory (float32 counts beyond it need "
          f"D > {total / (4 * V) / 1e6:.0f} million samples, "
          f"{2 * total / (4 * V) * V / 1e9:.1f} GB of uint16 on the host)")
    generator = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device="cuda")

    draws = torch.empty(K, V, device="cuda").exponential_(generator=generator)
    params = {
        "signatures": draws / draws.sum(-1, keepdim=True),
        "signature_scalings": torch.zeros(K, device="cuda"),
        "sample_scalings": torch.zeros(D, device="cuda"),
        "signature_embeddings": normal(K, M),
        "sample_embeddings": normal(D, M),
        "variance": torch.ones((), device="cuda"),
    }
    config = svi.SVIConfig(batch_size=B, forgetting=0.7, delay=20.0)
    core = svi.make_svi_batch_step(D, config)

    def get_batch(indices):
        return host_rows(X, indices, np.float32)

    probe_n = 262_144
    probe = svi.make_streamed_objective(
        svi.corrnmf_elbo_stream_chunk, lambda p: p["variance"].new_zeros(()),
        get_batch, probe_n, chunk_size=32_768)

    def run(state, steps, seed):
        state, _ = svi.run_svi_streaming(
            core, state, get_batch, D, B,
            torch.Generator().manual_seed(seed), steps,
            refresh_fn=svi.refresh_sample_usq)
        return state

    state0 = svi.svi_init(params, streaming=True)
    llh_before = float(probe(state0.params))
    state = run(state0, warm_steps, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, seconds = timed(torch, lambda: run(state, timed_steps, 2))
    peak = torch.cuda.max_memory_allocated()
    llh_after = float(probe(state.params))
    rate = timed_steps / seconds
    check(state.step == warm_steps + timed_steps, "every step ran")
    check(X.dtype == np.uint16, "the host counts were promoted")
    check(np.isfinite(llh_after) and llh_after > llh_before,
          f"the probe log-likelihood went from {llh_before} to {llh_after}")
    check(all(bool(torch.isfinite(leaf).all())
              for leaf in state.params.values()), "non-finite parameters")
    print(f"[16c] streaming CorrNMF core, B={B}, delay 20: {timed_steps} "
          f"steps in {seconds:.3f} s (after {warm_steps} warm), "
          f"{rate:.2f} steps/s, {rate * B:.0f} samples/s, "
          f"{rate * B * (4 * V + 8) / 1e6:.1f} MB/s uploaded (float32 rows "
          f"and int64 indices), peak allocated {peak / 1e9:.4f} GB; host "
          f"counts still {X.dtype}; probe log-likelihood a sample "
          f"{llh_before / probe_n:.4f} -> {llh_after / probe_n:.4f}")


def phase_svi_cell3e_probe(torch, sal):
    """20 lockstep cycles of fit_best_of(CorrNMFDet(5, m=2, random), the
    96 x 200,000 planted cohort, R=8): the bytes reckoned first."""
    V, D, K, R, cycles, n_backtrack = 96, 200_000, 5, 8, 20, 41
    rng = np.random.default_rng(0)
    W = rng.dirichlet(np.ones(V) * 0.3, size=K)
    H = rng.gamma(2.0, 30.0, size=(D, K))
    X = rng.poisson(H @ W).astype(np.float32) + np.float32(1.0)
    print(f"[16d] cohort 96 x {D}, R={R}: X {4 * D * V / 1e6:.1f} MB shared; "
          f"a lane-batched (R, D, V) tensor (the ratios) "
          f"{4 * R * D * V / 1e6:.1f} MB; the sample-side Armijo candidates "
          f"(R, D, {n_backtrack}, K) float32 "
          f"{4 * R * D * n_backtrack * K / 1e9:.3f} GB a tensor; the float64 "
          f"ELBO evaluation's (R, D, V) {8 * R * D * V / 1e9:.3f} GB")

    def probe():
        return sal.fit_best_of(
            sal.CorrNMFDet(n_signatures=K, dim_embeddings=2,
                           init_method="random", min_iterations=cycles,
                           max_iterations=cycles, conv_test_freq=10,
                           tol=1e-6, device="cuda", dtype="float32"),
            sal.AnnData(X.copy()), R, base_seed=0)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    busy = device_busy(torch, probe, cycles, top=6)
    peak = torch.cuda.max_memory_allocated()
    check(peak < 40e9, f"the probe allocated {peak / 1e9:.1f} GB")
    print(f"[16d] peak allocated {peak / 1e9:.3f} GB over the two runs "
          "(untraced, traced)")
    print_busy(
        "16d", f"fit_best_of(CorrNMFDet(5, m=2), R={R}), {cycles} lockstep "
        "cycles (set-up, the device init and two float64 ELBO evaluations "
        "included)", busy, "lockstep cycle")


def phase_svi(torch, sal):
    """Phase 16: stochastic (minibatch) fitting and host streaming."""
    phase_svi_equality(torch, sal)
    phase_svi_cell3c(torch, sal)
    phase_svi_streaming_cohort(torch, sal)
    phase_svi_cell3e_probe(torch, sal)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import salamander_tpu_torch as sal
    from salamander_tpu_torch import datasets
    from salamander_tpu_torch.initialization.methods import (
        random_init_batch,
    )
    from salamander_tpu_torch.ops import cuda_klnmf

    phase_environment(torch)
    phase_build(cuda_klnmf)
    max_abs_err, timings = phase_kernel(torch, cuda_klnmf, datasets,
                                        random_init_batch)

    X_host = datasets.load_pcawg_sbs().to_numpy().T.copy()
    launches, by_variant, by_x = {}, {}, {}

    def drive(path, phase, *args):
        """Run one path with the launch counts set to 0 just before it and
        read just after."""
        kernel = cuda_klnmf.fused_mu_block
        kernel.launches = 0
        for counts in (kernel.launches_by_variant, kernel.launches_by_x):
            for key in counts:
                counts[key] = 0
        out = phase(*args)
        launches[path] = kernel.launches
        by_variant[path] = dict(kernel.launches_by_variant)
        by_x[path] = dict(kernel.launches_by_x)
        return out

    drive("4 KLNMF.fit", phase_main_path, sal, cuda_klnmf)
    rates = drive("5 fit_klnmf_restarts", phase_headline, torch, sal,
                  cuda_klnmf, random_init_batch, X_host)
    drive("6 fit_best_of KLNMF", phase_quickstart, torch, sal, cuda_klnmf)
    drive("7 MvNMF", phase_mvnmf, torch, sal)
    drive("8 rank_scan_klnmf", phase_scan, torch, sal, cuda_klnmf, X_host)
    drive("9 CorrNMFDet", phase_corrnmf, torch, sal)
    drive("10 ARDNMF", phase_ardnmf, torch, sal)
    drive("11 rank_scan_corrnmf", phase_corrnmf_scan, torch, sal,
          np.ascontiguousarray(X_host.T))
    extracted = drive("12 extract_signatures", phase_extraction, torch, sal,
                      cuda_klnmf)
    drive("13 assignment", phase_assignment, torch, sal,
          extracted.consensus[5])
    drive("14 bootstrap", phase_bootstrap, torch, sal, cuda_klnmf)
    drive("15 MultimodalCorrNMF", phase_multimodal, torch, sal)
    drive("16 SVI and streaming", phase_svi, torch, sal)
    check(launches["16 SVI and streaming"] == 0,
          "the minibatch paths have no hand kernel to launch")
    for path in ("4 KLNMF.fit", "5 fit_klnmf_restarts",
                 "6 fit_best_of KLNMF", "8 rank_scan_klnmf",
                 "12 extract_signatures", "14 bootstrap"):
        check(launches[path] > 0, f"path {path} launched no kernel")
        check(by_variant[path]["resident"] > 0,
              f"path {path} did not run the resident kernel")
    for path in ("12 extract_signatures", "14 bootstrap"):
        check(by_x[path]["per_lane"] > 0,
              f"path {path} launched no kernel with a per-lane X")
    print(f"kernel launches by path: {launches}")
    print(f"kernel launches by path and kernel: {by_variant}")
    print(f"kernel launches by path, shared or per-lane X: {by_x}")

    headline = timings[(5, 100)]
    block_ms = min(headline["resident_ms"])
    blocks = WINDOW // BLOCK
    wall_ms = 1000 * (100 * WINDOW / rates["kernel"]) / blocks
    print(f"[5] kernel time per {BLOCK}-step block {block_ms:.4f} ms vs "
          f"{wall_ms:.4f} ms wall per block of the headline ({blocks} "
          "blocks; the rest is the objective, the lane freeze and one host "
          "sync per block)")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_mu_block",
        "route": "cuda",
        "source": "salamander_tpu_torch/csrc/mu_block.cu",
        "replaces": "salamander_tpu/ops/pallas_klnmf.py:75",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "launches_by_kernel": {
            variant: sum(counts[variant] for counts in by_variant.values())
            for variant in ("resident", "streamed")},
        "launches_by_x": {
            x: sum(counts[x] for counts in by_x.values())
            for x in ("shared", "per_lane")},
        "max_abs_err": max_abs_err,
        "variant": "resident",
        "cluster": headline["cluster"],
        "ms": block_ms,
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": None,
        "timings": list(timings.values()),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
