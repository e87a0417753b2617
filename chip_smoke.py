#!/usr/bin/env python3
"""Smoke test of the PyTorch port (salamander_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases (each prints its lines; any failed
check raises, so the script exits non-zero and prints no result):

1. environment: torch, CUDA, nvcc, triton, pandas/sklearn, the card's name
   and power limit. Exits 1 at once without a CUDA device.
2. build csrc/mu_block.cu with nvcc (timed; ptxas's register report).
3. the fused MU kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (PCAWG SBS 96x192, K=5, R=100 lanes)
   and at edge shapes, rtol 2e-4; kernel and plain times per block.
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
   fit_best_of(MvNMF(5, random), n_restarts=50) compacted, monolithic and
   compacted again, best losses at rtol 1e-4.
8. rank_scan_klnmf(X, range(2, 11), 20, seed=0) unpadded (with and without
   compaction; launches the kernel) and padded (packed and one point per
   call; plain ops), in turns; best loss per rank at rtol 1e-4.
9. CorrNMFDet(n_signatures=5, dim_embeddings=2, min 100, max 2000,
   tol 1e-7).fit on PCAWG SBS in float32 (np.random.seed(0)): EM cycles,
   wall, cycles/s, final ELBO, signature-side Newton steps per cycle; the
   ELBO is finite and its history never falls by more than float32 noise.
   Then fit_best_of(CorrNMFDet(5, dim_embeddings=2, random, max 500),
   n_restarts=16) compacted and monolithic in turns, best ELBO at rtol
   1e-4.
10. ARDNMF(n_signatures=20, a=5, min 500, max 20000).fit on the synthetic
   96 x 10,000 catalog with 8 planted signatures: the inferred rank is 8;
   then fit_best_of(ARDNMF(20, random), n_restarts=8) compacted and
   monolithic, best objective at rtol 1e-4, inferred rank 8.
11. rank_scan_corrnmf(PCAWG SBS, range(2, 8), n_restarts=4,
   dim_embeddings=2) over a fixed 200-cycle window, unpadded, padded and
   packed, and padded one point per call, in turns; best ELBO per rank at
   rtol 1e-4.
Phases 9-11 run plain PyTorch ops (neither family reaches the kernel).

Each of phases 4-11 runs with the kernel's launch count set to 0 just
before it and read just after. The last two lines are the per-kernel JSON
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


def phase_build(cuda_klnmf):
    start = time.perf_counter()
    library = cuda_klnmf.build()
    cuda_klnmf._library()
    seconds = time.perf_counter() - start
    print(f"[2] built {library.relative_to(ROOT)} in {seconds:.2f} s")
    for line in library.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2] ptxas: {line.strip()}")


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


def phase_kernel(torch, cuda_klnmf, datasets, random_init_batch):
    """Kernel vs plain on the card; returns (max_abs_err, timings)."""
    catalogs = {
        "sbs": datasets.load_pcawg_sbs(),
        "indel": datasets.load_pcawg_indel(),
        "sv": datasets.load_pcawg_sv(),
    }
    counts = {key: torch.as_tensor(frame.to_numpy().T.copy(),
                                   dtype=torch.float32, device="cuda")
              for key, frame in catalogs.items()}
    cases = [  # (catalog, K, R, samples, step counts)
        ("sbs", 5, 100, None, (1, 7, 10, 3)),
        ("sbs", 5, 1, None, (10,)),
        ("indel", 5, 4, None, (10,)),
        ("sv", 5, 4, None, (10,)),
        ("sbs", 1, 4, None, (10,)),
        ("sbs", 20, 4, None, (10,)),
        ("sbs", 5, 4, 100, (10,)),  # D = 100: not a multiple of the tile
    ]
    print(f"[3] tolerance: rtol {KERNEL_RTOL}, atol 1e-6 x max|plain| per "
          "tensor (entries at the eps clip)")
    max_abs_err = 0.0
    for key, K, R, samples, step_counts in cases:
        X = counts[key] if samples is None else \
            counts[key][:, :samples].contiguous()
        generator = torch.Generator(device="cuda").manual_seed(K * 1000 + R)
        W, H = random_init_batch(generator, X, K, R)
        for steps in step_counts:
            W_k, H_k = cuda_klnmf.fused_mu_block(X, W, H, steps)
            torch.cuda.synchronize()
            W_r, H_r = cuda_klnmf.fused_mu_block_reference(X, W, H, steps)
            for name, actual, expected in (("W", W_k, W_r), ("H", H_k, H_r)):
                check(bool(torch.isfinite(actual).all()),
                      f"non-finite kernel {name}")
                atol = 1e-6 * float(expected.abs().max())
                torch.testing.assert_close(actual, expected,
                                           rtol=KERNEL_RTOL, atol=atol)
                error = float((actual - expected).abs().max())
                relative = float(((actual - expected).abs()
                                  / expected.abs()).max())
                max_abs_err = max(max_abs_err, error)
                print(f"[3] {key} V={X.shape[0]} D={X.shape[1]} K={K} R={R} "
                      f"steps={steps} {name}: max abs err {error:.3e}, "
                      f"max rel err {relative:.3e}")

    timings = {}
    X = counts["sbs"]
    for R in (100, 1):
        generator = torch.Generator(device="cuda").manual_seed(R)
        W, H = random_init_batch(generator, X, 5, R)
        kernel = time_ms(
            torch, lambda: cuda_klnmf.fused_mu_block(X, W, H, BLOCK), 200)
        plain = time_ms(
            torch,
            lambda: cuda_klnmf.fused_mu_block_reference(X, W, H, BLOCK), 50)
        timings[R] = (kernel, plain)
        print(f"[3] one block of {BLOCK} steps, PCAWG SBS K=5 R={R}: kernel "
              f"{kernel:.4f} ms, plain {plain:.4f} ms")
    return max_abs_err, timings


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
    the cost of one trial round, and fit_best_of(MvNMF(5, random), R=50)
    compacted and monolithic in turns."""
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
    # the monolithic R=50 run (~55-80 s) runs once, between two compacted
    # runs, to keep the whole script near six minutes
    for compact in (True, False, True):
        trials[0] = 0
        mv_ops._renormalized_objective = counting
        try:
            summary, seconds = timed(torch, lambda: sal.fit_best_of(
                sal.MvNMF(n_signatures=5, init_method="random",
                          device="cuda", dtype="float32"),
                sbs_adata(sal), n_restarts=50, base_seed=0,
                compact=compact))
        finally:
            mv_ops._renormalized_objective = real
        check(bool(np.isfinite(summary.losses).all()), "non-finite losses")
        walls[compact].append(seconds)
        best[compact] = float(summary.losses.min())
        print(f"[7] fit_best_of(MvNMF(5), R=50, compact={compact}): "
              f"{seconds:.3f} s, best objective {best[compact]:.4f}, "
              f"iterations {summary.n_iterations.min()}.."
              f"{summary.n_iterations.max()} "
              f"(mean {summary.n_iterations.mean():.1f}), {trials[0]} "
              "batched line-search evaluations")
    check_best_agree("[7] compacted vs monolithic", best[True], best[False])
    print(f"[7] walls: compacted {', '.join(f'{s:.3f}' for s in walls[True])}"
          f" s; monolithic {', '.join(f'{s:.3f}' for s in walls[False])} s")


def phase_scan(torch, sal, cuda_klnmf, X_host):
    """rank_scan_klnmf(X, range(2, 11), 20, seed=0) in every layout, in
    turns; best loss per rank against the unpadded scan at rtol 1e-4."""
    layouts = {
        "unpadded": dict(pad_ranks=False, compact=False),
        "unpadded compacted": dict(pad_ranks=False, compact=True),
        "padded packed": dict(pad_ranks=True, pack_points=True),
        "padded per point": dict(pad_ranks=True, pack_points=False),
    }
    order = ["unpadded", "padded packed", "padded per point",
             "unpadded compacted", "padded packed", "unpadded"]
    walls = {name: [] for name in layouts}
    best = {}
    for name in order:
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
    fit_best_of(R=16) compacted and monolithic in turns."""
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
    for compact in (True, False, False, True):
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
    fixed 200-cycle window in every layout, in turns."""
    from salamander_tpu_torch.engine import FitConfig

    layouts = {
        "unpadded": dict(pad_ranks=False),
        "padded packed": dict(pad_ranks=True, pack_points=True),
        "padded per point": dict(pad_ranks=True, pack_points=False),
    }
    order = ["unpadded", "padded packed", "padded per point",
             "padded per point", "padded packed", "unpadded"]
    walls = {name: [] for name in layouts}
    best = {}
    for name in order:
        results, seconds = timed(torch, lambda: sal.rank_scan_corrnmf(
            X_samples, range(2, 8), dim_embeddings=2, n_restarts=4,
            config=FitConfig(200, 200, BLOCK, 1e-7), device="cuda",
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
    launches = {}

    def drive(path, phase, *args):
        """Run one path with the launch count set to 0 just before it and
        read just after."""
        cuda_klnmf.fused_mu_block.launches = 0
        out = phase(*args)
        launches[path] = cuda_klnmf.fused_mu_block.launches
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
    for path in ("4 KLNMF.fit", "5 fit_klnmf_restarts",
                 "6 fit_best_of KLNMF", "8 rank_scan_klnmf"):
        check(launches[path] > 0, f"path {path} launched no kernel")
    print(f"kernel launches by path: {launches}")

    block_ms = timings[100][0]
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
        "max_abs_err": max_abs_err,
        "ms": block_ms,
        "plain_ms": timings[100][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
