"""Command-line interface for the cohort-scale pipelines.

``python -m salamander_tpu_torch <command>`` drives the package's
production workflows end-to-end from count matrices on disk — fit one
model, run a multi-start rank scan with stability-based rank suggestion,
run the de novo consensus extraction, assign a cohort against a fixed
catalog, or bootstrap exposure uncertainty — with the same
checkpoint/resume and chunking controls the Python API exposes. Held
against salamander_tpu/cli.py: the same commands, flags, defaults,
messages and output files, so a preempted extraction resumes with the
identical command line (``--checkpoint-dir``).

Every command runs on the card; ``--cpu`` runs it on the CPU instead
(``device="cpu"`` for every model and batched routine). Without a card
and without ``--cpu`` a command exits non-zero: nothing moves to the CPU
unasked.
``--mesh auto|samples=N`` shards every command over a (restarts, samples)
mesh of torch.distributed ranks, one process per card, as the JAX CLI
does: launch it under ``torchrun --nproc-per-node N`` (a plain process is
a world of one). ``fit`` (``--resume`` and ``--batch-size`` included)
shards the samples of every model, ``scan`` and ``extract`` the restarts
(and samples where the family has them), ``assign`` and ``bootstrap`` the
samples; ``--mesh`` with ``--streaming`` exits, as in the JAX CLI. Under
a mesh the mesh's first rank alone writes the outputs. ``fit --resume``
checks that the counts are the checkpoint's own cohort, modality by
modality: shape, sample and feature names, and values.

Input conventions
-----------------
Count matrices follow the reference's shipped data layout (features as
rows, one column per sample — e.g. data/pcawg_breast_sbs.csv); pass
``--samples-as rows`` for the transposed layout. Catalogs are CSVs in
either orientation (feature names are matched against the counts' and the
orientation auto-detected), or the built-in names ``cosmic-sbs`` /
``cosmic-indel``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd

from .utils import EPSILON

__all__ = ["main"]


def _read_counts(path: str, samples_as: str) -> pd.DataFrame:
    """Counts CSV -> samples-x-features DataFrame."""
    frame = pd.read_csv(path, index_col=0)
    if samples_as == "columns":
        frame = frame.T
    frame.index = frame.index.astype(str)
    frame.columns = frame.columns.astype(str)
    return frame


def _read_catalog(spec: str) -> pd.DataFrame:
    """Catalog spec (builtin name or CSV path) -> DataFrame.

    Orientation is auto-detected downstream against the counts' feature
    names (assign._align_catalog), so both layouts are accepted here.
    """
    from . import datasets

    if spec == "cosmic-sbs":
        return datasets.load_cosmic_sbs_catalog()
    if spec == "cosmic-indel":
        return datasets.load_cosmic_indel_catalog()
    return pd.read_csv(spec, index_col=0)


def _parse_ranks(spec: str) -> list[int]:
    """'2-10' (inclusive) or '2,3,5' -> sorted unique ranks."""
    ranks: set[int] = set()
    try:
        for part in spec.split(","):
            part = part.strip()
            if "-" in part[1:]:  # allow plain ints; '-' only as a range here
                lo, hi = part.split("-", 1)
                ranks.update(range(int(lo), int(hi) + 1))
            else:
                ranks.add(int(part))
    except ValueError:
        raise SystemExit(
            f"invalid rank spec {spec!r}: use a range '2-10' or a "
            "comma list '2,3,5'"
        ) from None
    if not ranks or min(ranks) < 1:
        raise SystemExit(
            f"invalid rank spec {spec!r}: ranks must be >= 1 (an empty "
            "range like '5-2' selects nothing)"
        )
    return sorted(ranks)


def _sample_ways(spec: str | None) -> int | None:
    """The sample ways a valid --mesh spec pins: N for 'samples=N', None
    for 'auto' (and without a spec)."""
    if spec is None or spec == "auto":
        return None
    if spec.startswith("samples="):
        try:
            ways = int(spec.split("=", 1)[1])
        except ValueError:
            raise SystemExit(
                f"invalid mesh spec {spec!r}: N in 'samples=N' must be "
                "an integer"
            ) from None
        if ways < 1:
            raise SystemExit(
                f"invalid mesh spec {spec!r}: N must be >= 1"
            )
        return ways
    raise SystemExit(
        f"invalid mesh spec {spec!r}: use 'auto' or 'samples=N'"
    )


def _make_mesh(args):
    """--mesh spec -> parallel.make_mesh() over the ranks of the process
    group (init_distributed: torchrun's ranks, or a world of one). 'auto'
    factors all ranks into (restarts, samples); 'samples=N' pins the sample
    ways."""
    ways = _sample_ways(args.mesh)
    if args.mesh is None:
        return None
    from .parallel.mesh import init_distributed, make_mesh

    device = _device(args)
    try:
        init_distributed(device=device if device.type == "cpu" else None)
        mesh = make_mesh(sample_ways=ways, device=device)
    except ValueError as err:
        raise SystemExit(f"--mesh {args.mesh}: {err}") from None
    return mesh


def _writes(mesh) -> bool:
    """Whether this process writes the command's outputs: the mesh's first
    rank, or the only process without a mesh."""
    if mesh is None:
        return True
    from .parallel.mesh import is_writer

    return is_writer(mesh)


def _add_mesh(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--mesh", default=None,
        help="shard over the ranks (torchrun, one per card): 'auto' "
        "(factor all ranks into restarts x samples) or 'samples=N'",
    )


def _add_common(parser: argparse.ArgumentParser, multi: bool = False) -> None:
    if multi:
        parser.add_argument(
            "counts", nargs="+",
            help="counts CSV(s) (features as rows by default); several "
            "files = one modality each (--model mmcorrnmf)",
        )
    else:
        parser.add_argument(
            "counts", help="counts CSV (features as rows by default)"
        )
    parser.add_argument(
        "--samples-as", choices=["columns", "rows"], default="columns",
        help="which axis of the counts CSV holds the samples "
        "(default: columns, the reference data layout)",
    )
    parser.add_argument(
        "--output", "-o", default=".",
        help="output directory (created if missing)",
    )
    parser.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU (default: the card; without one the command "
        "exits non-zero)",
    )


def _device(args):
    """The device every model and batched routine of the command runs on:
    the CPU under --cpu, else the card (resolve_device's message without
    one)."""
    import torch

    from .models.signature_nmf import resolve_device

    if args.cpu:
        return torch.device("cpu")
    try:
        return resolve_device(None)
    except ValueError as err:
        raise SystemExit(f"{err} (or pass --cpu)") from None


def _check_same_cohort(frames, model) -> None:
    """--resume continues the checkpoint's own fit: the i-th counts file
    must equal the checkpoint's i-th modality (shape, sample and feature
    names, values after the fit's EPSILON clip); else exit naming the
    modality."""
    if hasattr(model, "mdata"):
        containers = {name: model.mdata[name] for name in model.mod_names}
    else:
        containers = {"counts": model.adata}
    if len(frames) != len(containers):
        raise SystemExit(
            f"--resume checkpoint holds {len(containers)} modalities "
            f"{list(containers)}; {len(frames)} counts file(s) were given "
            "(the checkpoint carries its own counts - pass the same cohort)"
        )
    for (name, container), frame in zip(containers.items(), frames):
        if frame.shape != container.shape:
            reason = (f"{container.n_obs} samples x {container.n_vars} "
                      f"features in the checkpoint, {frame.shape[0]} x "
                      f"{frame.shape[1]} in the counts file")
        elif not (list(frame.index) == list(map(str, container.obs_names))
                  and list(frame.columns)
                  == list(map(str, container.var_names))):
            reason = "the sample or feature names differ"
        elif not np.array_equal(
                frame.to_numpy(dtype=np.float64).clip(EPSILON),
                np.asarray(container.X, dtype=np.float64)):
            reason = "the counts differ"
        else:
            continue
        raise SystemExit(
            f"--resume checkpoint was fitted on another cohort: modality "
            f"{name!r}: {reason} (the checkpoint carries its own counts - "
            "pass the same cohort)"
        )


def _outdir(args) -> Path:
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    return out


def _parse_ks(spec: str, n_modalities: int) -> list[int]:
    try:
        ks = [int(part) for part in str(spec).split(",")]
    except ValueError:
        raise SystemExit(
            f"invalid -k/--n-signatures {spec!r}: pass an integer or a "
            "comma list of integers (one per counts file)"
        ) from None
    if len(ks) == 1:
        ks = ks * n_modalities
    if len(ks) != n_modalities:
        raise SystemExit(
            f"-k lists {len(ks)} signature counts for {n_modalities} "
            "counts file(s)"
        )
    if min(ks) < 1:
        raise SystemExit(
            f"invalid -k/--n-signatures {spec!r}: signature counts "
            "must be >= 1"
        )
    return ks


def _check_budget(args) -> None:
    """Shared sanity for the iteration-budget flags."""
    if args.max_iterations < 1:
        raise SystemExit("--max-iterations must be >= 1")
    if getattr(args, "min_iterations", 0) > args.max_iterations:
        raise SystemExit(
            f"--min-iterations ({args.min_iterations}) exceeds "
            f"--max-iterations ({args.max_iterations}): the fit could "
            "never satisfy its convergence rule"
        )
    if getattr(args, "conv_test_freq", 1) < 1:
        raise SystemExit("--conv-test-freq must be >= 1")
    if getattr(args, "tol", 1.0) < 0:
        raise SystemExit("--tol must be >= 0")


def _last_objective(model) -> str:
    """Final objective for the summary line; '<not evaluated>' when the
    trace is empty (fit_minibatch with eval_freq=0 records no values)."""
    trace = model.history.get("objective_function", [])
    return f"{trace[-1]:.6g}" if len(trace) else "<not evaluated>"


def _cmd_fit(args) -> int:
    from . import io as sio
    from .containers import AnnData, MuData
    from .models import (
        ARDNMF,
        KLNMF,
        CorrNMFDet,
        MultimodalCorrNMF,
        MvNMF,
    )

    frames = [_read_counts(path, args.samples_as) for path in args.counts]
    names = (
        args.names.split(",") if args.names
        else [Path(path).stem for path in args.counts]
    )
    if len(names) != len(frames) or len(set(names)) != len(names):
        raise SystemExit(
            f"--names must list {len(frames)} distinct modality names"
        )
    ks = _parse_ks(args.n_signatures, len(frames))
    if args.model != "mmcorrnmf" and len(frames) > 1:
        raise SystemExit(
            "several counts files require --model mmcorrnmf; the other "
            "families fit one matrix"
        )
    out = _outdir(args)
    init_kwargs = {"seed": args.seed} if args.seed is not None else None
    common = dict(
        init_method=args.init_method,
        min_iterations=args.min_iterations,
        max_iterations=args.max_iterations,
        conv_test_freq=args.conv_test_freq,
        tol=args.tol,
        dtype=args.dtype,
    )

    _check_budget(args)
    if args.resume is not None:
        if args.batch_size is not None or args.streaming:
            raise SystemExit(
                "--resume continues a full-batch fit; it cannot be "
                "combined with --batch-size/--streaming"
            )
        mesh = _make_mesh(args)
        model = sio.load_model(args.resume, device=_device(args))
        expected_class = {
            "klnmf": "KLNMF", "mvnmf": "MvNMF", "corrnmf": "CorrNMFDet",
            "ardnmf": "ARDNMF", "mmcorrnmf": "MultimodalCorrNMF",
        }[args.model]
        if type(model).__name__ != expected_class:
            raise SystemExit(
                f"--resume checkpoint holds a {type(model).__name__} "
                f"model but --model is {args.model}"
            )
        _check_same_cohort(frames, model)
        container = model.mdata if hasattr(model, "mdata") else model.adata
        # the iteration-budget flags apply to the resumed leg
        for attr in ("min_iterations", "max_iterations",
                     "conv_test_freq", "tol"):
            setattr(model, attr, getattr(args, attr))
        model.fit(container, warm_start=True, verbose=args.verbose,
                  mesh=mesh)
        model_path = out / "model.npz"
        if not _writes(mesh):
            return 0
        sio.save_model(model, str(model_path))
        if hasattr(model, "mdata"):
            for name in model.mod_names:
                model.asignatures[name].to_df().to_csv(
                    out / f"signatures_{name}.csv"
                )
                model.exposures[name].to_csv(out / f"exposures_{name}.csv")
        else:
            model.asignatures.to_df().to_csv(out / "signatures.csv")
            pd.DataFrame(
                container.obsm["exposures"],
                index=container.obs_names,
                columns=model.asignatures.obs_names,
            ).to_csv(out / "exposures.csv")
        print(
            f"fit: resumed {args.model} from {args.resume} for "
            f"{model.history['n_iterations']} further iterations, "
            f"objective {_last_objective(model)}; wrote {model_path}"
        )
        return 0

    minibatch = args.batch_size is not None
    if minibatch and args.model in ("mvnmf", "ardnmf"):
        raise SystemExit(
            "--batch-size (online fitting) is available for klnmf, "
            "corrnmf and mmcorrnmf"
        )
    if minibatch and args.batch_size < 1:
        raise SystemExit("--batch-size must be >= 1")
    if minibatch and args.n_steps < 1:
        raise SystemExit("--n-steps must be >= 1")
    if args.streaming and not minibatch:
        raise SystemExit(
            "--streaming is the host-resident minibatch path; pass "
            "--batch-size to enable online fitting"
        )
    if args.mesh is not None and args.streaming:
        _sample_ways(args.mesh)
        raise SystemExit(
            "--mesh and --streaming are mutually exclusive: streaming "
            "keeps the counts host-resident on ONE device"
        )
    mesh = _make_mesh(args)
    common["device"] = _device(args)
    fit_kwargs = {} if mesh is None else {"mesh": mesh}

    def _minibatch_kwargs():
        kwargs = dict(
            batch_size=args.batch_size,
            n_steps=args.n_steps,
            eval_freq=args.eval_freq,
            streaming=args.streaming,
            init_kwargs=init_kwargs,
            **fit_kwargs,
        )
        if args.seed is not None:
            kwargs["seed"] = args.seed
        if args.forgetting is not None:
            kwargs["forgetting"] = args.forgetting
        return kwargs

    if args.model == "mmcorrnmf":
        mdata = MuData(
            {name: AnnData(frame) for name, frame in zip(names, frames)}
        )
        model = MultimodalCorrNMF(
            ns_signatures=ks, dim_embeddings=args.dim_embeddings, **common
        )
        if minibatch:
            model.fit_minibatch(mdata, **_minibatch_kwargs())
        else:
            model.fit(mdata, init_kwargs=init_kwargs, verbose=args.verbose,
                      **fit_kwargs)
        if not _writes(mesh):
            return 0
        model_path = out / "model.npz"
        sio.save_model(model, str(model_path))
        for name in names:
            model.asignatures[name].to_df().to_csv(
                out / f"signatures_{name}.csv"
            )
            model.exposures[name].to_csv(out / f"exposures_{name}.csv")
        if args.export_h5ad:
            mdata.write_h5mu(str(out / "fitted.h5mu"))
        objective = _last_objective(model)
        print(
            f"fit: mmcorrnmf ks={ks} over modalities {names} converged in "
            f"{model.history['n_iterations']} iterations, ELBO "
            f"{objective}; wrote {model_path}"
        )
        return 0

    adata = AnnData(frames[0])
    if args.model == "klnmf":
        model = KLNMF(n_signatures=ks[0], **common)
    elif args.model == "mvnmf":
        model = MvNMF(n_signatures=ks[0], lam=args.lam, delta=args.delta,
                      **common)
    elif args.model == "corrnmf":
        model = CorrNMFDet(n_signatures=ks[0],
                           dim_embeddings=args.dim_embeddings, **common)
    else:
        model = ARDNMF(n_signatures=ks[0], **common)
    if minibatch:
        model.fit_minibatch(adata, **_minibatch_kwargs())
    else:
        model.fit(adata, init_kwargs=init_kwargs, verbose=args.verbose,
                  **fit_kwargs)
    if not _writes(mesh):
        return 0

    model_path = out / "model.npz"
    sio.save_model(model, str(model_path))
    model.asignatures.to_df().to_csv(out / "signatures.csv")
    pd.DataFrame(
        adata.obsm["exposures"],
        index=adata.obs_names,
        columns=model.asignatures.obs_names,
    ).to_csv(out / "exposures.csv")
    if args.export_h5ad:
        adata.write_h5ad(str(out / "fitted.h5ad"))
    objective = _last_objective(model)
    print(
        f"fit: {args.model} k={ks[0]} converged in "
        f"{model.history['n_iterations']} iterations, objective "
        f"{objective}; wrote {model_path}"
    )
    return 0


def _cmd_scan(args) -> int:
    from . import tools as tl
    from .engine import FitConfig

    _check_budget(args)
    if args.n_restarts < 1:
        raise SystemExit("--n-restarts must be >= 1")
    frame = _read_counts(args.counts, args.samples_as)
    ranks = _parse_ranks(args.ranks)
    config = FitConfig(
        min_iterations=args.min_iterations,
        max_iterations=args.max_iterations,
        conv_test_freq=args.conv_test_freq,
        tol=args.tol,
    )
    mesh = _make_mesh(args)
    device = _device(args)
    out = _outdir(args)

    if args.model == "corrnmf":
        from .parallel import rank_scan_corrnmf

        if args.dim_embeddings is None:
            raise SystemExit(
                "scan --model corrnmf needs --dim-embeddings: a rank scan "
                "compares ELBOs across ranks, so the embedding dimension "
                "must be held fixed (the per-fit default dim_embeddings="
                "n_signatures would change the model with every rank)"
            )
        results = rank_scan_corrnmf(
            frame.values, ranks,
            dim_embeddings=args.dim_embeddings,
            n_restarts=args.n_restarts, base_seed=args.seed,
            config=config, mesh=mesh,
            checkpoint_dir=args.checkpoint_dir, device=device,
        )
    elif args.model == "mvnmf":
        from .parallel import rank_scan_mvnmf

        results = rank_scan_mvnmf(
            frame.values.T, ranks, args.n_restarts, seed=args.seed,
            lam=args.lam, delta=args.delta, config=config, mesh=mesh,
            checkpoint_dir=args.checkpoint_dir, device=device,
        )
    else:
        from .parallel import rank_scan_klnmf

        results = rank_scan_klnmf(
            frame.values.T, ranks, args.n_restarts, seed=args.seed,
            config=config, mesh=mesh,
            checkpoint_dir=args.checkpoint_dir, device=device,
        )
    if not _writes(mesh):
        return 0

    table = tl.rank_selection_table(results)
    table.to_csv(out / "rank_selection.csv")
    try:
        suggested = int(tl.suggest_rank(
            results, min_stability=args.min_stability
        ))
    except ValueError as reason:
        suggested = None
        print(f"scan: no rank suggestion ({reason})")

    # winning restart of every scanned rank, with the cohort's names
    for k, result in results.items():
        sig_names = [f"Sig{i + 1}" for i in range(int(k))]
        if args.model == "corrnmf":
            W = np.asarray(result.model.signatures).T  # (V, k)
            H = np.asarray(result.model.exposures)     # (D, k)
        else:
            W = np.asarray(result.best_W)              # (V, k)
            H = np.asarray(result.best_H).T            # (D, k)
        pd.DataFrame(W, index=frame.columns, columns=sig_names).to_csv(
            out / f"signatures_k{k}.csv"
        )
        pd.DataFrame(H, index=frame.index, columns=sig_names).to_csv(
            out / f"exposures_k{k}.csv"
        )

    (out / "suggested_rank.json").write_text(json.dumps({
        "model": args.model,
        "ranks": [int(k) for k in results],
        "n_restarts": args.n_restarts,
        "min_stability": args.min_stability,
        "suggested_rank": suggested,
    }, indent=1))
    label = (
        str(suggested) if suggested is not None
        else "none (inspect rank_selection.csv)"
    )
    print(
        f"scan: {args.model} ranks {ranks[0]}..{ranks[-1]} x "
        f"{args.n_restarts} restarts; suggested rank {label}; "
        f"wrote {out / 'rank_selection.csv'}"
    )
    return 0


def _cmd_extract(args) -> int:
    from .extraction import extract_signatures
    from .io import save_extraction

    _check_budget(args)
    if args.n_bootstraps < 1:
        raise SystemExit("--n-bootstraps must be >= 1")
    if not 0.0 <= args.min_stability <= 1.0:
        raise SystemExit(
            "--min-stability is a cosine threshold in [0, 1]"
        )
    mesh = _make_mesh(args)
    device = _device(args)
    counts = _read_counts(args.counts, args.samples_as)
    given = (
        _read_catalog(args.given_signatures)
        if args.given_signatures else None
    )
    result = extract_signatures(
        counts,
        _parse_ranks(args.ranks),
        n_bootstraps=args.n_bootstraps,
        resample_method=args.resample_method,
        seed=args.seed,
        min_stability=args.min_stability,
        rank_rule=args.rank_rule,
        model=args.model,
        lam=args.lam,
        delta=args.delta,
        given_signatures=given,
        min_iterations=args.min_iterations,
        max_iterations=args.max_iterations,
        tol=args.tol,
        max_lane_gb=args.max_lane_gb,
        mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        device=device,
    )
    if not _writes(mesh):
        return 0
    out = _outdir(args)
    save_extraction(result, str(out / "extraction.npz"))
    result.table.to_csv(out / "rank_table.csv")
    for rank, consensus in result.consensus.items():
        consensus.to_csv(out / f"consensus_signatures_rank{rank}.csv")
        result.exposures[rank].to_csv(out / f"exposures_rank{rank}.csv")
    print(result.table.to_string())
    if result.suggested_rank is None:
        print("suggested rank: none (no rank met the stability threshold)")
    else:
        print(f"suggested rank: {result.suggested_rank}")
    print(f"wrote {out / 'extraction.npz'}")
    return 0


def _cmd_assign(args) -> int:
    from .assign import assign_exposures, assign_signatures

    _check_budget(args)
    if args.rel_tol < 0 or args.abs_tol < 0:
        raise SystemExit("--rel-tol/--abs-tol budgets must be >= 0")
    if args.candidate_iters < 1:
        raise SystemExit("--candidate-iters must be >= 1")
    if args.batch_size is not None and args.batch_size < 1:
        raise SystemExit("--batch-size must be >= 1")
    mesh = _make_mesh(args)
    device = _device(args)
    counts = _read_counts(args.counts, args.samples_as)
    catalog = _read_catalog(args.catalog)
    out = _outdir(args)
    if args.dense:
        exposures = assign_exposures(
            counts, catalog,
            max_iterations=args.max_iterations, tol=args.tol,
            mesh=mesh, device=device,
        )
        if not _writes(mesh):
            return 0
        exposures.to_csv(out / "exposures.csv")
        print(
            f"assign (dense): {exposures.shape[0]} samples x "
            f"{exposures.shape[1]} catalog signatures; "
            f"wrote {out / 'exposures.csv'}"
        )
        return 0
    result = assign_signatures(
        counts, catalog,
        rel_tol=args.rel_tol,
        abs_tol=args.abs_tol,
        candidate_iters=args.candidate_iters,
        max_iterations=args.max_iterations,
        tol=args.tol,
        batch_size=args.batch_size,
        mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        device=device,
    )
    if not _writes(mesh):
        return 0
    result.exposures.to_csv(out / "exposures.csv")
    result.active.to_csv(out / "active.csv")
    summary = pd.DataFrame({
        "kl_dense": result.kl_dense,
        "kl_sparse": result.kl_sparse,
        "n_active": result.n_active,
    })
    summary.to_csv(out / "summary.csv")
    (out / "meta.json").write_text(json.dumps(result.meta, indent=1))
    assigned = result.assigned_signatures()
    print(
        f"assign (sparse): {result.exposures.shape[0]} samples, mean "
        f"support {result.n_active.mean():.2f} signatures, "
        f"{len(assigned)} catalog signatures active cohort-wide; "
        f"wrote {out / 'exposures.csv'}"
    )
    return 0


def _cmd_bootstrap(args) -> int:
    from .assign import bootstrap_exposures

    _check_budget(args)
    if args.n_replicates < 1:
        raise SystemExit("--n-replicates must be >= 1")
    if args.replicate_batch is not None and args.replicate_batch < 1:
        raise SystemExit("--replicate-batch must be >= 1")
    if not 0.0 <= args.min_fraction <= 1.0:
        raise SystemExit("--min-fraction is a fraction in [0, 1]")
    try:
        quantiles = tuple(float(q) for q in args.quantiles.split(","))
    except ValueError:
        raise SystemExit(
            f"invalid --quantiles {args.quantiles!r}: pass a comma list "
            "of floats like '0.05,0.5,0.95'"
        ) from None
    if not quantiles or any(not 0.0 < q < 1.0 for q in quantiles):
        raise SystemExit(
            f"invalid --quantiles {args.quantiles!r}: quantiles must lie "
            "strictly inside (0, 1)"
        )
    mesh = _make_mesh(args)
    device = _device(args)
    counts = _read_counts(args.counts, args.samples_as)
    catalog = _read_catalog(args.catalog)
    active = None
    if args.active:
        active = pd.read_csv(args.active, index_col=0).astype(bool)
    result = bootstrap_exposures(
        counts, catalog,
        n_replicates=args.n_replicates,
        seed=args.seed,
        method=args.resample_method,
        quantiles=quantiles,
        min_fraction=args.min_fraction,
        active=active,
        max_iterations=args.max_iterations,
        tol=args.tol,
        replicate_batch=args.replicate_batch,
        mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        device=device,
    )
    if not _writes(mesh):
        return 0
    out = _outdir(args)
    result.point.to_csv(out / "exposures_point.csv")
    result.mean.to_csv(out / "exposures_mean.csv")
    result.std.to_csv(out / "exposures_std.csv")
    result.presence.to_csv(out / "presence.csv")
    for q, frame in result.quantiles.items():
        frame.to_csv(out / f"exposures_q{q:g}.csv")
    print(
        f"bootstrap: {result.meta['n_replicates']} replicates "
        f"({result.meta['method']}), wrote point/mean/std/presence and "
        f"{len(result.quantiles)} quantile frames to {out}"
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="salamander_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    sub = parser.add_subparsers(dest="command", required=True)

    fit = sub.add_parser(
        "fit", help="fit one NMF model and save it (io.save_model)"
    )
    _add_common(fit, multi=True)
    fit.add_argument(
        "--model",
        choices=["klnmf", "mvnmf", "corrnmf", "ardnmf", "mmcorrnmf"],
        default="klnmf",
    )
    fit.add_argument(
        "--n-signatures", "-k", required=True,
        help="signature count, or a comma list (one per counts file) "
        "for mmcorrnmf",
    )
    fit.add_argument(
        "--names", default=None,
        help="comma list of modality names for mmcorrnmf "
        "(default: counts file stems)",
    )
    fit.add_argument("--init-method", default="nndsvd")
    fit.add_argument("--min-iterations", type=int, default=500)
    fit.add_argument("--max-iterations", type=int, default=10_000)
    fit.add_argument("--conv-test-freq", type=int, default=10)
    fit.add_argument("--tol", type=float, default=1e-7)
    fit.add_argument("--dtype", default="float32")
    fit.add_argument("--seed", type=int, default=None)
    fit.add_argument("--lam", type=float, default=1.0)
    fit.add_argument("--delta", type=float, default=1.0)
    fit.add_argument("--dim-embeddings", type=int, default=None)
    fit.add_argument("--export-h5ad", action="store_true")
    fit.add_argument("--verbose", type=int, choices=[0, 1], default=0)
    fit.add_argument(
        "--resume", default=None, metavar="MODEL_NPZ",
        help="continue a previous fit from its io.save_model checkpoint "
        "(fit(warm_start=True)); the iteration-budget flags apply to "
        "the resumed leg",
    )
    fit.add_argument(
        "--batch-size", type=int, default=None,
        help="online (minibatch) fitting instead of full-batch cycles "
        "(klnmf, corrnmf, mmcorrnmf; model.fit_minibatch)",
    )
    fit.add_argument("--n-steps", type=int, default=2000)
    fit.add_argument("--eval-freq", type=int, default=50)
    fit.add_argument(
        "--forgetting", type=float, default=None,
        help="Robbins-Monro decay exponent (default: the family's own)",
    )
    _add_mesh(fit)
    fit.add_argument(
        "--streaming", action="store_true",
        help="keep the count matrix host-resident and stream minibatches "
        "to the device (cohorts larger than accelerator memory)",
    )
    fit.set_defaults(func=_cmd_fit)

    scan = sub.add_parser(
        "scan",
        help="multi-start rank scan with stability-based rank suggestion",
    )
    _add_common(scan)
    scan.add_argument("--model", choices=["klnmf", "mvnmf", "corrnmf"],
                      default="klnmf")
    scan.add_argument(
        "--ranks", required=True,
        help="rank range '2-10' (inclusive) or list '2,3,5'",
    )
    scan.add_argument("--n-restarts", "-r", type=int, default=20)
    scan.add_argument("--seed", type=int, default=0)
    scan.add_argument(
        "--min-stability", type=float, default=0.9,
        help="per-signature matched-cosine threshold for suggest_rank",
    )
    scan.add_argument("--lam", type=float, default=1.0)
    scan.add_argument("--delta", type=float, default=1.0)
    scan.add_argument(
        "--dim-embeddings", type=int, default=None,
        help="embedding dimension, required for --model corrnmf (held "
        "fixed across the scanned ranks)",
    )
    scan.add_argument("--min-iterations", type=int, default=500)
    scan.add_argument("--max-iterations", type=int, default=10_000)
    scan.add_argument("--conv-test-freq", type=int, default=10)
    scan.add_argument("--tol", type=float, default=1e-7)
    scan.add_argument("--checkpoint-dir", default=None)
    _add_mesh(scan)
    scan.set_defaults(func=_cmd_scan)

    extract = sub.add_parser(
        "extract",
        help="de novo consensus signature extraction over a rank range",
    )
    _add_common(extract)
    extract.add_argument(
        "--ranks", required=True,
        help="rank range '2-10' (inclusive) or list '2,3,5'",
    )
    extract.add_argument("--n-bootstraps", type=int, default=20)
    extract.add_argument(
        "--resample-method", choices=["multinomial", "poisson"],
        default="multinomial",
    )
    extract.add_argument("--seed", type=int, default=0)
    extract.add_argument("--min-stability", type=float, default=0.8)
    extract.add_argument(
        "--rank-rule", choices=["largest", "prefix"], default="largest"
    )
    extract.add_argument("--model", choices=["klnmf", "mvnmf"],
                         default="klnmf")
    extract.add_argument("--lam", type=float, default=1.0)
    extract.add_argument("--delta", type=float, default=1.0)
    extract.add_argument(
        "--given-signatures", default=None,
        help="CSV of known signatures to carry frozen (semi-supervised)",
    )
    extract.add_argument("--min-iterations", type=int, default=500)
    extract.add_argument("--max-iterations", type=int, default=10_000)
    extract.add_argument("--tol", type=float, default=1e-7)
    extract.add_argument("--max-lane-gb", type=float, default=None)
    extract.add_argument("--checkpoint-dir", default=None)
    _add_mesh(extract)
    extract.set_defaults(func=_cmd_extract)

    assign = sub.add_parser(
        "assign",
        help="assign a cohort against a fixed catalog (sparse by default)",
    )
    _add_common(assign)
    assign.add_argument(
        "catalog",
        help="catalog CSV (either orientation) or 'cosmic-sbs'/"
        "'cosmic-indel'",
    )
    assign.add_argument(
        "--dense", action="store_true",
        help="full-catalog refit only (no support search)",
    )
    assign.add_argument("--rel-tol", type=float, default=0.02)
    assign.add_argument("--abs-tol", type=float, default=0.0)
    assign.add_argument("--candidate-iters", type=int, default=50)
    assign.add_argument("--max-iterations", type=int, default=10_000)
    assign.add_argument("--tol", type=float, default=1e-7)
    assign.add_argument("--batch-size", type=int, default=None)
    assign.add_argument("--checkpoint-dir", default=None)
    _add_mesh(assign)
    assign.set_defaults(func=_cmd_assign)

    bootstrap = sub.add_parser(
        "bootstrap",
        help="bootstrap uncertainty of catalog-refit exposures",
    )
    _add_common(bootstrap)
    bootstrap.add_argument(
        "catalog",
        help="catalog CSV (either orientation) or 'cosmic-sbs'/"
        "'cosmic-indel'",
    )
    bootstrap.add_argument("--n-replicates", type=int, default=200)
    bootstrap.add_argument("--seed", type=int, default=0)
    bootstrap.add_argument(
        "--resample-method", choices=["multinomial", "poisson"],
        default="multinomial",
    )
    bootstrap.add_argument("--quantiles", default="0.05,0.5,0.95")
    bootstrap.add_argument("--min-fraction", type=float, default=0.05)
    bootstrap.add_argument(
        "--active", default=None,
        help="bool samples-x-signatures CSV (e.g. assign's active.csv) "
        "restricting each sample to a support",
    )
    bootstrap.add_argument("--max-iterations", type=int, default=10_000)
    bootstrap.add_argument("--tol", type=float, default=1e-7)
    bootstrap.add_argument("--replicate-batch", type=int, default=None)
    bootstrap.add_argument("--checkpoint-dir", default=None)
    _add_mesh(bootstrap)
    bootstrap.set_defaults(func=_cmd_bootstrap)

    return parser


def main(argv=None) -> int:
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    # a process group that --mesh brings up ends with the command
    started = dist.is_available() and dist.is_initialized()
    try:
        return args.func(args)
    except FileNotFoundError as err:
        path = err.filename if err.filename is not None else err
        raise SystemExit(f"file not found: {path}") from None
    except pd.errors.ParserError as err:
        raise SystemExit(f"could not parse CSV: {err}") from None
    finally:
        if not started and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
