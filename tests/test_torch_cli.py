"""The command line of salamander_tpu_torch (python -m
salamander_tpu_torch), mirroring tests/test_cli.py on tiny synthetic
cohorts with --cpu, and held against the JAX package's CLI.

Parity: `fit --init-method nndsvd --dtype float64 --cpu` through both
CLIs gives the same signatures.csv and exposures.csv at rtol 1e-8 with
equal iteration counts for klnmf, mvnmf and ardnmf; for corrnmf the
objective trace agrees at 1e-8 and the CSVs at rtol 1e-6 (its parameters
come out of Newton solves stopped at a tolerance; 3.3e-8 was seen, and
test_torch_corrnmf_model.py holds the signatures at 1e-5). `assign`, dense and sparse, agrees at 1e-8.
`scan`, `extract` and `bootstrap` draw with jax.random in the JAX package,
which torch cannot reproduce: for these the files, columns and index are
checked. Without --cpu and without a card every command exits non-zero;
fit and assign --mesh run in a world of one and equal the plain commands,
a mesh the ranks do not fill exits saying so, and --mesh with
--streaming exits as in the JAX CLI; and fit --resume refuses counts that
are not the checkpoint's own cohort (the JAX CLI checks only the first
modality's shape). The spawned worlds of test_torch_sharding.py and
test_torch_mesh_paths.py run the mesh commands across ranks."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from salamander_tpu import cli as jax_cli
from salamander_tpu_torch import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-8


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A planted 3-signature cohort: counts CSV (features x samples, the
    reference data layout) + the true signatures as a catalog CSV."""
    rng = np.random.default_rng(7)
    V, D, K = 12, 24, 3
    W = rng.dirichlet(np.ones(V) * 0.4, size=K)        # (K, V) rows
    H = rng.gamma(2.0, 50.0, size=(D, K))
    X = rng.poisson(H @ W).astype(float) + 1.0
    root = tmp_path_factory.mktemp("cli_cohort")
    counts = pd.DataFrame(
        X,
        index=[f"s{d}" for d in range(D)],
        columns=[f"f{v}" for v in range(V)],
    )
    counts.T.to_csv(root / "counts.csv")               # features x samples
    catalog = pd.DataFrame(
        W,
        index=[f"Cat{k}" for k in range(K)],
        columns=counts.columns,
    )
    catalog.to_csv(root / "catalog.csv")
    other = pd.DataFrame(
        np.random.default_rng(3).poisson(40.0, size=(D, 7)).astype(float)
        + 1.0,
        index=counts.index,
        columns=[f"g{v}" for v in range(7)],
    )
    other.T.to_csv(root / "counts_other.csv")
    return {"root": root, "counts": counts, "catalog": catalog,
            "other": other}


def run(argv):
    """cli.main on the CPU; returns its exit code."""
    return cli.main(argv + ["--cpu"])


def read(path):
    return pd.read_csv(path, index_col=0)


def test_parse_ranks():
    assert cli._parse_ranks("2-5") == [2, 3, 4, 5]
    assert cli._parse_ranks("2,4,3,4") == [2, 3, 4]
    assert cli._parse_ranks("7") == [7]
    with pytest.raises(SystemExit):
        cli._parse_ranks("0-2")


def test_read_counts_orientations(cohort):
    by_cols = cli._read_counts(str(cohort["root"] / "counts.csv"), "columns")
    pd.testing.assert_frame_equal(by_cols, cohort["counts"])
    # the transposed layout with --samples-as rows
    (cohort["root"] / "counts_rows.csv").write_text(
        cohort["counts"].to_csv()
    )
    by_rows = cli._read_counts(
        str(cohort["root"] / "counts_rows.csv"), "rows"
    )
    pd.testing.assert_frame_equal(by_rows, cohort["counts"])


def test_cli_fit_saves_model(cohort, tmp_path, capsys):
    rc = run([
        "fit", str(cohort["root"] / "counts.csv"),
        "--model", "klnmf", "-k", "3", "--seed", "1",
        "--min-iterations", "30", "--max-iterations", "60",
        "--export-h5ad",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    assert "fit: klnmf k=3" in capsys.readouterr().out

    from salamander_tpu_torch.io import load_model

    model = load_model(str(tmp_path / "model.npz"), device="cpu")
    sigs = read(tmp_path / "signatures.csv")
    np.testing.assert_allclose(
        sigs.to_numpy(), np.asarray(model.asignatures.X), rtol=1e-6
    )
    exposures = read(tmp_path / "exposures.csv")
    assert exposures.shape == (24, 3)
    assert (tmp_path / "fitted.h5ad").exists()


def test_cli_fit_minibatch_streaming(cohort, tmp_path, capsys):
    rc = run([
        "fit", str(cohort["root"] / "counts.csv"),
        "--model", "klnmf", "-k", "3", "--seed", "1",
        "--batch-size", "8", "--n-steps", "40", "--eval-freq", "10",
        "--streaming",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    assert "fit: klnmf k=3" in capsys.readouterr().out
    sigs = read(tmp_path / "signatures.csv")
    assert sigs.shape == (3, 12)
    np.testing.assert_allclose(sigs.sum(axis=1), 1.0, rtol=1e-4)

    from salamander_tpu_torch.io import load_model

    model = load_model(str(tmp_path / "model.npz"), device="cpu")
    assert model.history["n_iterations"] == 40


def test_cli_fit_minibatch_eval_freq_zero(cohort, tmp_path, capsys):
    """eval_freq=0 disables objective evaluation; the summary must not
    index an empty trace (rc 0, '<not evaluated>' in the message)."""
    rc = run([
        "fit", str(cohort["root"] / "counts.csv"),
        "--model", "klnmf", "-k", "3", "--seed", "1",
        "--batch-size", "8", "--n-steps", "20", "--eval-freq", "0",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    assert "<not evaluated>" in capsys.readouterr().out
    assert (tmp_path / "model.npz").exists()


def test_cli_scan_corrnmf_requires_dim_embeddings(cohort, tmp_path):
    with pytest.raises(SystemExit, match="dim-embeddings"):
        run([
            "scan", str(cohort["root"] / "counts.csv"),
            "--model", "corrnmf", "--ranks", "2", "-r", "2",
            "-o", str(tmp_path),
        ])


def test_cli_fit_minibatch_rejects_mvnmf(cohort, tmp_path):
    with pytest.raises(SystemExit):
        run([
            "fit", str(cohort["root"] / "counts.csv"),
            "--model", "mvnmf", "-k", "2", "--batch-size", "8",
            "-o", str(tmp_path),
        ])


def test_cli_scan_writes_table_and_winners(cohort, tmp_path, capsys):
    rc = run([
        "scan", str(cohort["root"] / "counts.csv"),
        "--ranks", "2-3", "-r", "4", "--seed", "0",
        "--min-iterations", "30", "--max-iterations", "60",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    assert "scan: klnmf ranks 2..3 x 4 restarts" in capsys.readouterr().out
    table = read(tmp_path / "rank_selection.csv")
    assert list(table.index) == [2, 3]
    assert list(table.columns) == ["best_loss", "mean_stability",
                                   "min_stability", "loss_improvement"]
    meta = json.loads((tmp_path / "suggested_rank.json").read_text())
    assert meta["ranks"] == [2, 3]
    assert set(meta) == {"model", "ranks", "n_restarts", "min_stability",
                         "suggested_rank"}
    for rank in (2, 3):
        sigs = read(tmp_path / f"signatures_k{rank}.csv")
        assert sigs.shape == (12, rank)
        assert list(sigs.index) == list(cohort["counts"].columns)
        assert list(sigs.columns) == [f"Sig{i + 1}" for i in range(rank)]
        np.testing.assert_allclose(sigs.sum(axis=0), 1.0, rtol=1e-4)
        exposures = read(tmp_path / f"exposures_k{rank}.csv")
        assert exposures.shape == (24, rank)
        assert list(exposures.index) == list(cohort["counts"].index)


def test_cli_scan_corrnmf(cohort, tmp_path, capsys):
    rc = run([
        "scan", str(cohort["root"] / "counts.csv"),
        "--model", "corrnmf", "--ranks", "2", "-r", "2",
        "--dim-embeddings", "2",
        "--min-iterations", "5", "--max-iterations", "10",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    assert "scan: corrnmf" in capsys.readouterr().out
    sigs = read(tmp_path / "signatures_k2.csv")
    assert sigs.shape == (12, 2)
    exposures = read(tmp_path / "exposures_k2.csv")
    assert exposures.shape == (24, 2)
    assert read(tmp_path / "rank_selection.csv").shape[0] == 1


def test_cli_extract_writes_result(cohort, tmp_path, capsys):
    rc = run([
        "extract", str(cohort["root"] / "counts.csv"),
        "--ranks", "2-3", "--n-bootstraps", "3", "--seed", "0",
        "--min-iterations", "30", "--max-iterations", "60",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "suggested rank" in out

    from salamander_tpu_torch.io import load_extraction

    result = load_extraction(str(tmp_path / "extraction.npz"), device="cpu")
    table = read(tmp_path / "rank_table.csv")
    assert list(table.index) == [2, 3] == list(result.table.index)
    assert list(table.columns) == list(result.table.columns)
    for rank in (2, 3):
        sigs = read(tmp_path / f"consensus_signatures_rank{rank}.csv")
        assert sigs.shape == (rank, 12)
        assert list(sigs.columns) == list(cohort["counts"].columns)
        exposures = read(tmp_path / f"exposures_rank{rank}.csv")
        assert list(exposures.index) == list(cohort["counts"].index)


def test_cli_assign_sparse_and_dense(cohort, tmp_path, capsys):
    sparse_dir = tmp_path / "sparse"
    rc = run([
        "assign", str(cohort["root"] / "counts.csv"),
        str(cohort["root"] / "catalog.csv"),
        "--max-iterations", "300",
        "-o", str(sparse_dir),
    ])
    assert rc == 0
    assert "assign (sparse)" in capsys.readouterr().out
    active = read(sparse_dir / "active.csv")
    exposures = read(sparse_dir / "exposures.csv")
    assert active.shape == exposures.shape == (24, 3)
    # off-support exposures are exact zeros
    assert (exposures.to_numpy()[~active.to_numpy().astype(bool)] == 0).all()
    summary = read(sparse_dir / "summary.csv")
    assert list(summary.columns) == ["kl_dense", "kl_sparse", "n_active"]

    dense_dir = tmp_path / "dense"
    rc = run([
        "assign", str(cohort["root"] / "counts.csv"),
        str(cohort["root"] / "catalog.csv"),
        "--dense", "--max-iterations", "300",
        "-o", str(dense_dir),
    ])
    assert rc == 0
    dense = read(dense_dir / "exposures.csv")
    assert dense.shape == (24, 3)
    # the dense refit keeps every signature active
    assert (dense.to_numpy() > 0).all()


def test_cli_bootstrap_uses_active_support(cohort, tmp_path):
    assign_dir = tmp_path / "assign"
    run([
        "assign", str(cohort["root"] / "counts.csv"),
        str(cohort["root"] / "catalog.csv"),
        "--max-iterations", "300", "-o", str(assign_dir),
    ])
    boot_dir = tmp_path / "boot"
    rc = run([
        "bootstrap", str(cohort["root"] / "counts.csv"),
        str(cohort["root"] / "catalog.csv"),
        "--n-replicates", "5", "--max-iterations", "200",
        "--quantiles", "0.5",
        "--active", str(assign_dir / "active.csv"),
        "-o", str(boot_dir),
    ])
    assert rc == 0
    active = read(assign_dir / "active.csv")
    mean = read(boot_dir / "exposures_mean.csv")
    assert (mean.to_numpy()[~active.to_numpy().astype(bool)] == 0).all()
    assert (boot_dir / "exposures_q0.5.csv").exists()
    presence = read(boot_dir / "presence.csv")
    assert ((presence.to_numpy() >= 0) & (presence.to_numpy() <= 1)).all()
    for name in ("point", "mean", "std"):
        frame = read(boot_dir / f"exposures_{name}.csv")
        assert list(frame.index) == list(cohort["counts"].index)
        assert list(frame.columns) == list(cohort["catalog"].index)


def test_cli_extract_checkpoint_resume(cohort, tmp_path):
    """A second identical invocation resumes from the store (same result)."""
    argv = [
        "extract", str(cohort["root"] / "counts.csv"),
        "--ranks", "2", "--n-bootstraps", "3",
        "--min-iterations", "30", "--max-iterations", "60",
        "--checkpoint-dir", str(tmp_path / "ckpt"),
    ]
    assert run(argv + ["-o", str(tmp_path / "first")]) == 0
    assert run(argv + ["-o", str(tmp_path / "second")]) == 0
    first = read(tmp_path / "first" / "consensus_signatures_rank2.csv")
    second = read(tmp_path / "second" / "consensus_signatures_rank2.csv")
    pd.testing.assert_frame_equal(first, second)


def test_cli_fit_multimodal(cohort, tmp_path, capsys):
    root = cohort["root"]
    rc = run([
        "fit", str(root / "counts.csv"), str(root / "counts_other.csv"),
        "--model", "mmcorrnmf", "-k", "2,2", "--names", "sbs,other",
        "--seed", "0", "--min-iterations", "10", "--max-iterations", "20",
        "--export-h5ad",
        "-o", str(tmp_path),
    ])
    assert rc == 0
    assert "fit: mmcorrnmf" in capsys.readouterr().out
    for name, n_feat in [("sbs", 12), ("other", 7)]:
        sigs = read(tmp_path / f"signatures_{name}.csv")
        assert sigs.shape == (2, n_feat)
        exposures = read(tmp_path / f"exposures_{name}.csv")
        assert exposures.shape == (24, 2)
    assert (tmp_path / "fitted.h5mu").exists()

    from salamander_tpu_torch.io import load_model

    model = load_model(str(tmp_path / "model.npz"), device="cpu")
    assert model.ns_signatures == [2, 2]


def test_cli_fit_multi_counts_requires_mm(cohort, tmp_path):
    with pytest.raises(SystemExit):
        run([
            "fit", str(cohort["root"] / "counts.csv"),
            str(cohort["root"] / "counts.csv"),
            "--model", "klnmf", "-k", "2", "-o", str(tmp_path),
        ])


def test_cli_fit_under_mesh(cohort, tmp_path):
    """fit --mesh auto in a plain process is a world of one: the same
    files as the plain fit, and no process group left behind. A mesh of
    4 sample ways on one rank exits non-zero saying why, and writes
    nothing."""
    import torch.distributed as dist

    argv = ["fit", str(cohort["root"] / "counts.csv"), "--model", "klnmf",
            "-k", "3", "--seed", "1", "--dtype", "float64",
            "--min-iterations", "100", "--max-iterations", "200"]
    assert run(argv + ["-o", str(tmp_path / "plain")]) == 0
    assert run(argv + ["--mesh", "auto", "-o", str(tmp_path / "auto")]) == 0
    assert not dist.is_initialized()
    for name in ("signatures.csv", "exposures.csv"):
        pd.testing.assert_frame_equal(read(tmp_path / "auto" / name),
                                      read(tmp_path / "plain" / name))
    with pytest.raises(SystemExit, match="not divisible") as excinfo:
        run(argv + ["--mesh", "samples=4", "-o", str(tmp_path / "mesh")])
    assert excinfo.value.code not in (0, None)
    assert not (tmp_path / "mesh" / "model.npz").exists()


def test_cli_fit_mesh_rejects_streaming(cohort, tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        run([
            "fit", str(cohort["root"] / "counts.csv"),
            "--model", "klnmf", "-k", "3", "--batch-size", "8",
            "--streaming", "--mesh", "samples=4", "-o", str(tmp_path),
        ])


def test_cli_fit_resume_continues(cohort, tmp_path, capsys):
    """fit --resume model.npz warm-starts from the checkpoint; the
    objective keeps improving and outputs are rewritten."""
    first_dir = tmp_path / "first"
    rc = run([
        "fit", str(cohort["root"] / "counts.csv"),
        "--model", "klnmf", "-k", "3", "--seed", "1",
        "--min-iterations", "20", "--max-iterations", "40",
        "-o", str(first_dir),
    ])
    assert rc == 0
    capsys.readouterr()
    resume_dir = tmp_path / "resumed"
    rc = run([
        "fit", str(cohort["root"] / "counts.csv"),
        "--model", "klnmf", "-k", "3",
        "--min-iterations", "20", "--max-iterations", "60",
        "--resume", str(first_dir / "model.npz"),
        "-o", str(resume_dir),
    ])
    assert rc == 0
    assert "resumed klnmf" in capsys.readouterr().out

    from salamander_tpu_torch.io import load_model

    first = load_model(str(first_dir / "model.npz"), device="cpu")
    resumed = load_model(str(resume_dir / "model.npz"), device="cpu")
    assert (resumed.history["objective_function"][-1]
            <= first.history["objective_function"][-1])
    assert (resume_dir / "exposures.csv").exists()

    # wrong model family and minibatch combinations exit cleanly
    with pytest.raises(SystemExit, match="--model"):
        run([
            "fit", str(cohort["root"] / "counts.csv"),
            "--model", "mvnmf", "-k", "3",
            "--resume", str(first_dir / "model.npz"),
            "-o", str(tmp_path),
        ])
    with pytest.raises(SystemExit, match="batch-size"):
        run([
            "fit", str(cohort["root"] / "counts.csv"),
            "--model", "klnmf", "-k", "3", "--batch-size", "8",
            "--resume", str(first_dir / "model.npz"),
            "-o", str(tmp_path),
        ])


# Negative-path sweep: each subcommand x missing/zero/contradictory flags
# must exit with a clean SystemExit message, never a raw traceback.
# Placeholders: C = counts CSV, CAT = catalog CSV (substituted per-test).
# match=None marks argparse-level failures (SystemExit code 2, message on
# stderr); a string matches our explicit SystemExit message. In this
# process (a world of one) a --mesh of more than one sample way exits
# naming the ranks it lacks.
NEGATIVE_CASES = [
    # fit
    (["fit", "C", "-k", "abc"], "invalid -k"),
    (["fit", "C", "-k", "0"], ">= 1"),
    (["fit", "C", "-k", "2,3"], "-k lists 2 signature counts"),
    (["fit", "C", "-k", "3", "--min-iterations", "100",
      "--max-iterations", "50"], "exceeds"),
    (["fit", "C", "-k", "3", "--max-iterations", "0"], "--max-iterations"),
    (["fit", "C", "-k", "3", "--conv-test-freq", "0"], "--conv-test-freq"),
    (["fit", "C", "-k", "3", "--tol", "-1"], "--tol"),
    (["fit", "C", "-k", "3", "--batch-size", "0"], "--batch-size"),
    (["fit", "C", "-k", "3", "--batch-size", "8", "--n-steps", "0"],
     "--n-steps"),
    (["fit", "C", "-k", "3", "--streaming"], "--batch-size"),
    (["fit", "C", "-k", "3", "--mesh", "bogus"], "invalid mesh spec"),
    (["fit", "C", "-k", "3", "--mesh", "samples=x"], "integer"),
    (["fit", "C", "-k", "3", "--mesh", "samples=0"], ">= 1"),
    (["fit", "C", "-k", "3", "--model", "corrnmf", "--batch-size", "8",
      "--streaming", "--mesh", "auto"], "mutually exclusive"),
    (["fit", "/nonexistent/counts.csv", "-k", "3"], "file not found"),
    (["fit", "C"], None),                       # missing -k
    (["fit", "C", "-k", "3", "--model", "nope"], None),
    # scan
    (["scan", "C", "--ranks", "abc"], "invalid rank spec"),
    (["scan", "C", "--ranks", "0"], "invalid rank spec"),
    (["scan", "C", "--ranks", "5-2"], "selects nothing"),
    (["scan", "C", "--ranks", "2", "-r", "0"], "--n-restarts"),
    (["scan", "C", "--ranks", "2", "--min-iterations", "10",
      "--max-iterations", "5"], "exceeds"),
    (["scan", "C", "--ranks", "2", "--model", "corrnmf",
      "--dim-embeddings", "2", "--mesh", "samples=4"], "not divisible"),
    (["scan", "C"], None),                      # missing --ranks
    # extract
    (["extract", "C", "--ranks", "x"], "invalid rank spec"),
    (["extract", "C", "--ranks", "2", "--n-bootstraps", "0"],
     "--n-bootstraps"),
    (["extract", "C", "--ranks", "2", "--min-stability", "1.5"],
     "[0, 1]"),
    (["extract", "C", "--ranks", "2", "--mesh", "samples=2"],
     "not divisible"),
    (["extract", "C"], None),                   # missing --ranks
    # assign
    (["assign", "C", "CAT", "--rel-tol", "-0.1"], ">= 0"),
    (["assign", "C", "CAT", "--candidate-iters", "0"],
     "--candidate-iters"),
    (["assign", "C", "CAT", "--batch-size", "0"], "--batch-size"),
    (["assign", "C", "/nonexistent/catalog.csv"], "file not found"),
    (["assign", "C"], None),                    # missing catalog
    # bootstrap
    (["bootstrap", "C", "CAT", "--n-replicates", "0"], "--n-replicates"),
    (["bootstrap", "C", "CAT", "--quantiles", "abc"], "--quantiles"),
    (["bootstrap", "C", "CAT", "--quantiles", "1.5"], "(0, 1)"),
    (["bootstrap", "C", "CAT", "--min-fraction", "2"], "[0, 1]"),
    (["bootstrap", "C", "CAT", "--replicate-batch", "0"],
     "--replicate-batch"),
    (["bootstrap", "C", "CAT", "--mesh", "samples=3"], "not divisible"),
    # top level
    (["frobnicate"], None),                     # unknown subcommand
]


@pytest.mark.parametrize(
    "argv,match", NEGATIVE_CASES,
    ids=["-".join(case[0][:1] + [str(i)])
         for i, case in enumerate(NEGATIVE_CASES)],
)
def test_cli_negative_paths(cohort, tmp_path, argv, match):
    """Bad flag lattices exit cleanly (SystemExit, message, no traceback)."""
    sub = {
        "C": str(cohort["root"] / "counts.csv"),
        "CAT": str(cohort["root"] / "catalog.csv"),
    }
    argv = [sub.get(token, token) for token in argv] + ["-o", str(tmp_path)]
    with pytest.raises(SystemExit) as excinfo:
        run(argv)
    assert excinfo.value.code not in (0, None)
    if match is not None:
        assert match in str(excinfo.value)


def test_cli_assign_under_mesh(cohort, tmp_path):
    """assign --mesh auto in a plain process is a world of one: the
    supports and exposures of the plain command, as the JAX CLI test holds
    its mesh run, and no process group left behind; a mesh of 4 sample
    ways on one rank exits and writes nothing."""
    import torch.distributed as dist

    base = ["assign", str(cohort["root"] / "counts.csv"),
            str(cohort["root"] / "catalog.csv"), "--max-iterations", "300"]
    assert run(base + ["-o", str(tmp_path / "plain")]) == 0
    assert run(base + ["--mesh", "auto", "-o", str(tmp_path / "auto")]) == 0
    assert not dist.is_initialized()
    for name in ("active.csv", "exposures.csv"):
        pd.testing.assert_frame_equal(read(tmp_path / "auto" / name),
                                      read(tmp_path / "plain" / name))
    with pytest.raises(SystemExit, match="not divisible"):
        run(base + ["--mesh", "samples=4", "-o", str(tmp_path / "mesh")])
    assert not (tmp_path / "mesh" / "active.csv").exists()


# ---------------------------------------------------------------------- #
# against the JAX package's CLI
# ---------------------------------------------------------------------- #

FIT_FAMILIES = {
    "klnmf": [],
    "mvnmf": ["--lam", "0.5"],
    "corrnmf": ["--dim-embeddings", "2"],
    "ardnmf": [],
}


def run_both(argv, out, seed=None):
    """The same command through both CLIs (float64 where a dtype is
    taken), into out/jax and out/port; the global numpy RNG reseeded
    before each when `seed` is given (the CorrNMF inits draw from it)."""
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        if seed is not None:
            np.random.seed(seed)
        assert main(argv + ["--cpu", "-o", str(out / name)]) == 0
    return out / "jax", out / "port"


@pytest.mark.parametrize("family", list(FIT_FAMILIES))
def test_fit_matches_the_jax_cli(family, cohort, tmp_path, capsys):
    jax_dir, port_dir = run_both([
        "fit", str(cohort["root"] / "counts.csv"), "--model", family,
        "-k", "3", "--init-method", "nndsvd", "--dtype", "float64",
        "--min-iterations", "30", "--max-iterations", "200",
        "--tol", "1e-6", *FIT_FAMILIES[family],
    ], tmp_path, seed=0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].replace(str(port_dir), str(jax_dir)) == lines[-2]

    import salamander_tpu_torch.io as port_io
    from salamander_tpu import io as jax_io

    model = port_io.load_model(str(port_dir / "model.npz"), device="cpu")
    jax_model = jax_io.load_model(str(jax_dir / "model.npz"))
    assert model.history["n_iterations"] == jax_model.history["n_iterations"]
    np.testing.assert_allclose(model.history["objective_function"],
                               jax_model.history["objective_function"],
                               rtol=RTOL)
    rtol = 1e-6 if family == "corrnmf" else RTOL
    for name in ("signatures.csv", "exposures.csv"):
        frame, expected = read(port_dir / name), read(jax_dir / name)
        pd.testing.assert_index_equal(frame.index, expected.index)
        pd.testing.assert_index_equal(frame.columns, expected.columns)
        np.testing.assert_allclose(frame.to_numpy(), expected.to_numpy(),
                                   rtol=rtol)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_assign_matches_the_jax_cli(dense, cohort, tmp_path):
    jax_dir, port_dir = run_both([
        "assign", str(cohort["root"] / "counts.csv"),
        str(cohort["root"] / "catalog.csv"), "--max-iterations", "300",
        *(["--dense"] if dense else []),
    ], tmp_path)
    names = ["exposures.csv"] + ([] if dense else ["active.csv",
                                                   "summary.csv"])
    for name in names:
        frame, expected = read(port_dir / name), read(jax_dir / name)
        pd.testing.assert_index_equal(frame.index, expected.index)
        pd.testing.assert_index_equal(frame.columns, expected.columns)
        np.testing.assert_allclose(frame.to_numpy(dtype=float),
                                   expected.to_numpy(dtype=float), rtol=RTOL)
    if not dense:
        meta = json.loads((port_dir / "meta.json").read_text())
        jax_meta = json.loads((jax_dir / "meta.json").read_text())
        assert set(meta) >= {"rel_tol", "abs_tol"}
        assert {key: meta[key] for key in ("rel_tol", "abs_tol")} == \
            {key: jax_meta[key] for key in ("rel_tol", "abs_tol")}


def test_drawing_commands_write_the_jax_cli_files(cohort, tmp_path):
    """scan, extract and bootstrap draw with jax.random in the JAX
    package: the port writes the same files, with the same columns and
    index."""
    counts = str(cohort["root"] / "counts.csv")
    catalog = str(cohort["root"] / "catalog.csv")
    commands = {
        "scan": ["scan", counts, "--ranks", "2-3", "-r", "3",
                 "--min-iterations", "20", "--max-iterations", "40"],
        "extract": ["extract", counts, "--ranks", "2-3", "--n-bootstraps",
                    "3", "--min-iterations", "20", "--max-iterations", "40"],
        "bootstrap": ["bootstrap", counts, catalog, "--n-replicates", "4",
                      "--max-iterations", "100"],
    }
    for command, argv in commands.items():
        jax_dir, port_dir = run_both(argv, tmp_path / command)
        files = sorted(p.name for p in jax_dir.iterdir())
        assert sorted(p.name for p in port_dir.iterdir()) == files, command
        for name in files:
            if not name.endswith(".csv"):
                continue
            frame, expected = read(port_dir / name), read(jax_dir / name)
            assert frame.shape == expected.shape, name
            pd.testing.assert_index_equal(frame.index, expected.index)
            pd.testing.assert_index_equal(frame.columns, expected.columns)
            # finite wherever the JAX package's file is (the first rank's
            # loss_improvement is NaN in both)
            np.testing.assert_array_equal(
                np.isfinite(frame.to_numpy(dtype=float)),
                np.isfinite(expected.to_numpy(dtype=float)), err_msg=name)


@pytest.mark.parametrize("command", [
    ["fit", "C", "-k", "2"],
    ["scan", "C", "--ranks", "2"],
    ["extract", "C", "--ranks", "2"],
    ["assign", "C", "CAT"],
    ["bootstrap", "C", "CAT"],
], ids=lambda argv: argv[0])
def test_without_a_card_a_command_exits_nonzero(command, cohort, tmp_path,
                                               monkeypatch):
    """No --cpu and no card: the command exits non-zero with
    resolve_device's message; nothing runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sub = {"C": str(cohort["root"] / "counts.csv"),
           "CAT": str(cohort["root"] / "catalog.csv")}
    argv = [sub.get(token, token) for token in command]
    with pytest.raises(SystemExit, match="no CUDA device") as excinfo:
        cli.main(argv + ["-o", str(tmp_path / "out")])
    assert excinfo.value.code not in (0, None)
    assert "--cpu" in str(excinfo.value)
    assert not any((tmp_path / "out").glob("*.csv"))


@pytest.mark.parametrize("change", ["values", "names", "first-modality"])
def test_resume_refuses_a_different_cohort(change, cohort, tmp_path):
    """fit --resume on counts that are not the checkpoint's: a second
    modality that differs only in values or in sample names, or a
    single-modality cohort with other values of the same shape. The port
    exits naming the modality; the JAX CLI checks only the first
    modality's shape and sample count and resumes anyway."""
    root = cohort["root"]
    if change == "first-modality":
        files, model, ks = [root / "counts.csv"], "klnmf", "3"
        changed = cohort["counts"] + 1.0
        index_of_changed = 0
    else:
        files, model, ks = ([root / "counts.csv", root / "counts_other.csv"],
                            "mmcorrnmf", "2,2")
        changed = cohort["other"].copy()
        if change == "values":
            changed.iloc[0, 0] += 1.0
        else:
            changed.index = [f"t{d}" for d in range(len(changed))]
        index_of_changed = 1
    base = ["fit", *map(str, files), "--model", model, "-k", ks,
            "--min-iterations", "5", "--max-iterations", "10"]
    jax_dir, port_dir = run_both(base, tmp_path / "first", seed=0)

    resumed = [str(f) for f in files]
    (tmp_path / "changed").mkdir()
    changed_file = tmp_path / "changed" / files[index_of_changed].name
    changed.T.to_csv(changed_file)
    resumed[index_of_changed] = str(changed_file)
    argv = ["fit", *resumed, "--model", model, "-k", ks,
            "--min-iterations", "5", "--max-iterations", "10", "--cpu"]
    # the JAX CLI's defect: it resumes on the other cohort
    assert jax_cli.main(argv + ["--resume", str(jax_dir / "model.npz"),
                                "-o", str(tmp_path / "jax")]) == 0
    with pytest.raises(SystemExit, match="another cohort") as excinfo:
        cli.main(argv + ["--resume", str(port_dir / "model.npz"),
                         "-o", str(tmp_path / "port")])
    assert excinfo.value.code not in (0, None)
    modality = ("counts" if change == "first-modality"
                else "counts_other")
    assert repr(modality) in str(excinfo.value)
    # the unchanged cohort resumes
    assert cli.main([*base[:1], *map(str, files), *base[1 + len(files):],
                     "--cpu", "--resume", str(port_dir / "model.npz"),
                     "-o", str(tmp_path / "same")]) == 0


def test_module_entry_point(cohort, tmp_path):
    """python -m salamander_tpu_torch runs the CLI: --help works with
    matplotlib and seaborn blocked, and a fit writes the same model as
    the in-process call."""
    blocked = ("import runpy, sys; sys.modules['matplotlib'] = None; "
               "sys.modules['seaborn'] = None; sys.argv[0] = 'x'; "
               "runpy.run_module('salamander_tpu_torch', "
               "run_name='__main__')")
    help_run = subprocess.run([sys.executable, "-c", blocked, "--help"],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
    assert help_run.returncode == 0, help_run.stderr
    assert "usage: salamander_tpu_torch" in help_run.stdout
    argv = ["fit", str(cohort["root"] / "counts.csv"), "-k", "2",
            "--min-iterations", "20", "--max-iterations", "20", "--cpu"]
    fit_run = subprocess.run(
        [sys.executable, "-m", "salamander_tpu_torch", *argv,
         "-o", str(tmp_path / "module")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert fit_run.returncode == 0, fit_run.stderr
    assert cli.main(argv + ["-o", str(tmp_path / "inline")]) == 0
    for name in ("signatures.csv", "exposures.csv"):
        pd.testing.assert_frame_equal(read(tmp_path / "module" / name),
                                      read(tmp_path / "inline" / name))
