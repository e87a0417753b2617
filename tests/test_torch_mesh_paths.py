"""The rest of salamander_tpu_torch's (restarts, samples) mesh paths
across ranks: the sample axis of MvNMF, ARDNMF, CorrNMFDet and
MultimodalCorrNMF (fit and fit_best_of), fit_minibatch of KLNMF,
CorrNMFDet and MultimodalCorrNMF, rank_scan_mvnmf and rank_scan_corrnmf,
extract_signatures, assign_exposures, assign_signatures,
bootstrap_exposures and the CLI commands under --mesh.

One 4-process gloo world for the module (torch.multiprocessing spawn, a
FileStore under tmp_path, a 60 s process-group timeout and a 180 s join
that kills the ranks), as in test_torch_sharding.py. Every rank runs every
path on the meshes (4, 1), (1, 4) and (2, 2) and writes what it got; the
parent meanwhile computes the port's meshless runs and the JAX package's
runs on its 8-device virtual CPU mesh (tests/conftest.py). At float64:

- against the JAX package's mesh run: equal iteration counts, traces at
  rtol 1e-9, signatures at 1e-7, exposures and embeddings at 1e-6 for the
  fits; assignment at 1e-8 with equal supports; fit_best_of at 1e-8;
  fit_minibatch at batch_size = n_samples (traces 1e-8, signatures 1e-6)
  and at B = 7 with both packages fed one epoch order (SHARED_ORDER), and
  rank_scan_mvnmf with both fed the same starts (shared_starts), at the
  fits' tolerances: the packages draw batches and starts apart;
- against the port without a mesh: the same tolerances; on a restart-only
  mesh the lanes are the meshless ones bit for bit;
- extraction and bootstrap_exposures draw their resamples from torch
  generators and are held against the meshless port. That run is held
  against the JAX package elsewhere: extraction's lanes, fed the JAX
  package's resamples and starts, by
  test_torch_extraction.py::test_discovery_fit_fed_jax_lanes and its
  clustering by ::test_host_clustering_is_bit_equal; bootstrap_exposures's
  point estimate and refits by
  test_torch_assign.py::test_bootstrap_point_equals_dense_refit with
  ::test_assign_exposures_matches_jax, and
  test_torch_ops_assign.py::test_refit_exposures.

Every rank of a sample row must take the same branches, or one rank calls
an all_reduce that the others never join: the ranks count the MvNMF
line-search trials, the CorrNMF Newton steps and the stop blocks of each
fit, and every rank's own (never gathered) trace and signatures must be
bit-equal.

The worker imports neither jax nor the JAX package: the tests do, inside
their bodies.
"""

import contextlib
import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch.multiprocessing as mp

import salamander_tpu_torch as port
from salamander_tpu_torch.engine import FitConfig

torch.set_num_threads(1)

WORLD = 4
SHAPES = {"4x1": 1, "1x4": 4, "2x2": 2}  # mesh name -> sample ways
SAMPLE_SHARDED = ("1x4", "2x2")
N_SAMPLES = 16
FAMILIES = ("mvnmf", "ardnmf", "corrnmf", "mmcorrnmf")
MINIBATCH_FAMILIES = ("klnmf", "corrnmf", "mmcorrnmf")
CATALOG = ["SBS1", "SBS2", "SBS3", "SBS5", "SBS13", "SBS18"]
SCAN_CONFIG = FitConfig(min_iterations=10, max_iterations=60,
                        conv_test_freq=10, tol=1e-4)
# every epoch of the fed fit_minibatch runs, by cohort size
SHARED_ORDER = {n: np.random.default_rng(n).permutation(n) for n in (16, 20)}
INIT_TIMEOUT = datetime.timedelta(seconds=60)
# a guard against a hung world, not a time budget: the world ends in
# about 41 s on an idle 8-core host and took 165 s there beside the
# suite's six workers (a lockstep collective waits for its slowest rank)
JOIN_LIMIT = 600.0
# fit traces, signatures, exposures/embeddings (tests/test_sharding.py)
TRACE, SIGNATURES, EXPOSURES = 1e-9, 1e-7, 1e-6
CLI_FIT = ["--seed", "1", "--dtype", "float64", "--min-iterations", "10",
           "--max-iterations", "40"]
CLI_COMMANDS = {
    "fit_corrnmf": ["fit", "C", "--model", "corrnmf", "-k", "2",
                    "--dim-embeddings", "2", *CLI_FIT],
    "fit_mvnmf": ["fit", "C", "--model", "mvnmf", "-k", "2", *CLI_FIT],
    "fit_ardnmf": ["fit", "C", "--model", "ardnmf", "-k", "3", *CLI_FIT],
    "fit_mmcorrnmf": ["fit", "M1", "M2", "--model", "mmcorrnmf", "-k",
                      "2,2", "--dim-embeddings", "2", *CLI_FIT],
    "fit_minibatch": ["fit", "C", "--model", "corrnmf", "-k", "2",
                      "--dim-embeddings", "2", "--batch-size", "8",
                      "--n-steps", "12", "--eval-freq", "3", "--seed", "1",
                      "--dtype", "float64"],
    "scan_corrnmf": ["scan", "C", "--model", "corrnmf", "--ranks", "2-3",
                     "--dim-embeddings", "2", "-r", "4",
                     "--min-iterations", "10", "--max-iterations", "30"],
    "scan_mvnmf": ["scan", "C", "--model", "mvnmf", "--ranks", "2-3",
                   "-r", "4", "--min-iterations", "10",
                   "--max-iterations", "40"],
    "extract": ["extract", "C", "--ranks", "2-3", "--n-bootstraps", "4",
                "--min-iterations", "50", "--max-iterations", "300"],
    "assign": ["assign", "C", "CAT", "--max-iterations", "2000"],
    "assign_dense": ["assign", "C", "CAT", "--dense",
                     "--max-iterations", "2000"],
    "bootstrap": ["bootstrap", "C", "CAT", "--n-replicates", "5",
                  "--max-iterations", "2000"],
}


# ---------------------------------------------------------------------- #
# inputs (numpy, the same in every rank and in the tests)
# ---------------------------------------------------------------------- #
def counts(n_samples=N_SAMPLES):
    """PCAWG SBS counts, samples x features."""
    return port.datasets.load_pcawg_sbs().iloc[:n_samples]


def catalog():
    return port.datasets.load_cosmic_sbs_catalog().loc[CATALOG]


def mm_counts(n_samples=20):
    rng = np.random.default_rng(0)
    load = rng.gamma(2.0, 1.0, (n_samples, 3))
    return {name: rng.poisson(60.0 * load @ rng.dirichlet(np.ones(v), 3))
            .astype(float)
            for name, v in {"sbs": 12, "indel": 9, "sv": 6}.items()}


def mm_data(pkg):
    return pkg.MuData({name: pkg.AnnData(X.copy())
                       for name, X in mm_counts().items()})


# ---------------------------------------------------------------------- #
# the runs, each through the port (pkg=port, mesh=None: meshless) or the
# JAX package (pkg: its models and containers, device None)
# ---------------------------------------------------------------------- #
def build(pkg, family, device=None, **extra):
    kwargs = {} if device is None else {"device": device}
    kwargs.update(extra)
    if family == "klnmf":
        return pkg.KLNMF(n_signatures=3, **kwargs)
    if family == "mvnmf":
        return pkg.MvNMF(n_signatures=2, min_iterations=20,
                         max_iterations=60, **kwargs)
    if family == "ardnmf":
        return pkg.ARDNMF(n_signatures=4, min_iterations=20,
                          max_iterations=60, **kwargs)
    if family == "corrnmf":
        return pkg.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                              min_iterations=10, max_iterations=30, **kwargs)
    return pkg.MultimodalCorrNMF(ns_signatures=[3, 2, 2], dim_embeddings=2,
                                 min_iterations=10, max_iterations=30,
                                 **kwargs)


def container(pkg, family):
    if family == "mmcorrnmf":
        return mm_data(pkg)
    return pkg.AnnData(counts().copy())


def model_summary(model):
    """Signatures, exposures (and embeddings), trace and count of a fitted
    model of any family."""
    if hasattr(model, "mdata"):
        names = model.mod_names
        return {
            "signatures": np.concatenate(
                [np.asarray(model.asignatures[n].X).ravel() for n in names]),
            "exposures": np.concatenate(
                [np.asarray(model.mdata[n].obsm["exposures"])
                 for n in names], axis=1),
            "embeddings": np.asarray(model.mdata.obsm["embeddings"]),
            "history": np.asarray(model.history["objective_function"]),
            "n_iterations": int(model.history["n_iterations"]),
        }
    out = {"signatures": np.asarray(model.asignatures.X),
           "exposures": np.asarray(model.adata.obsm["exposures"]),
           "history": np.asarray(model.history["objective_function"]),
           "n_iterations": int(model.history["n_iterations"])}
    if "embeddings" in model.adata.obsm:
        out["embeddings"] = np.asarray(model.adata.obsm["embeddings"])
    return out


def fit_run(family, mesh=None, pkg=port):
    model = build(pkg, family, "cpu" if pkg is port else None)
    data = container(pkg, family)
    np.random.seed(1)  # the CorrNMF embeddings draw from it
    model.fit(data, init_kwargs={"seed": 0},
              **({} if mesh is None else {"mesh": mesh}))
    return model_summary(model)


def best_of_run(family, mesh=None, pkg=port, fit_best_of=None):
    model = build(pkg, family, "cpu" if pkg is port else None,
                  init_method="random")
    model.tol = 1e-4  # lanes stop apart
    fit_best_of = fit_best_of or port.fit_best_of
    summary = fit_best_of(model, container(pkg, family), 4, base_seed=7,
                          batched_init=False,
                          **({} if mesh is None else {"mesh": mesh}))
    return {"losses": np.asarray(summary.losses),
            "n_iterations": np.asarray(summary.n_iterations),
            "best_index": int(summary.best_index),
            "model_history": np.asarray(model.history["objective_function"])}


def minibatch_run(family, mesh=None, batch_size=7, pkg=port):
    model = build(pkg, family, "cpu" if pkg is port else None)
    np.random.seed(1)
    model.fit_minibatch(container(pkg, family), batch_size=batch_size,
                        n_steps=12, eval_freq=3, seed=3,
                        init_kwargs={"seed": 0},
                        **({} if mesh is None else {"mesh": mesh}))
    out = model_summary(model)
    out.pop("n_iterations")
    return out


@contextlib.contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def fed_minibatch_run(family, mesh):
    """minibatch_run with every epoch in SHARED_ORDER, as the JAX run of
    jax_fed_minibatch_run."""
    from salamander_tpu_torch.ops import svi

    def draw_permutation(generator, n_samples):
        return torch.as_tensor(SHARED_ORDER[n_samples])

    with patched(svi, "draw_permutation", draw_permutation):
        return minibatch_run(family, mesh)


def shared_starts(X, n_signatures, n_restarts):
    """numpy starts of a scan point's lanes for both packages: W (R, V, k)
    with unit columns, H (R, k, D) at the scale of X (V, D)."""
    rng = np.random.default_rng(n_signatures)
    W = rng.uniform(0.1, 1.0, (n_restarts, X.shape[0], n_signatures))
    H = rng.uniform(0.5, 1.5, (n_restarts, n_signatures, X.shape[1]))
    return W / W.sum(1, keepdims=True), H * X.sum(0) / n_signatures


def fed_scan_run(mesh):
    """scan_run("mvnmf") with the lanes started at shared_starts, as the
    JAX run of jax_fed_scan_run."""
    from salamander_tpu_torch.ops.klnmf import pad_rank
    from salamander_tpu_torch.parallel import restarts

    def padded_init(generator, X, n_signatures, n_restarts, padded):
        W, H = (torch.as_tensor(a, dtype=X.dtype, device=X.device)
                for a in shared_starts(X.cpu().numpy(), n_signatures,
                                       n_restarts))
        W, H, mask = pad_rank(W, H, padded)
        return W, H, mask.expand(n_restarts, padded)

    with patched(restarts, "_padded_random_init", padded_init):
        return scan_run("mvnmf", mesh)


def scan_run(family, mesh=None):
    on_mesh = {} if mesh is None else {"mesh": mesh}
    if family == "mvnmf":
        results = port.rank_scan_mvnmf(
            counts().to_numpy().T, [2, 3], 4, seed=3, config=SCAN_CONFIG,
            dtype=torch.float64, device="cpu", **on_mesh)
        return {k: {"losses": r.losses, "n_iterations": r.n_iterations,
                    "W": np.asarray(r.W)} for k, r in results.items()}
    results = port.rank_scan_corrnmf(
        counts().to_numpy(), [2, 3], dim_embeddings=2, n_restarts=4,
        base_seed=5, config=FitConfig(10, 30, 10, 1e-4), device="cpu",
        build_models=False, **on_mesh)
    return {k: {"losses": r.losses, "n_iterations": r.n_iterations,
                "signatures": r.signatures} for k, r in results.items()}


def extract_run(mesh=None):
    result = port.extract_signatures(
        counts(), [2, 3], n_bootstraps=4, seed=3, min_iterations=50,
        max_iterations=300, device="cpu",
        **({} if mesh is None else {"mesh": mesh}))
    out = {"table": result.table.to_numpy(),
           "suggested": result.suggested_rank,
           "final": np.asarray(result.model.adata.obsm["exposures"])}
    for k in (2, 3):
        out[f"losses_{k}"] = result.replicate_losses[k]
        out[f"iterations_{k}"] = result.replicate_iterations[k]
        out[f"consensus_{k}"] = result.consensus[k].to_numpy()
        out[f"exposures_{k}"] = result.exposures[k].to_numpy()
    return out


def lane_starts(lo, hi):
    """The resamples and starts of lanes [lo, hi) of the extraction above
    (ranks 2-3, 4 bootstraps, seed 3) as a rank of a restart-sharded mesh
    prepares them: only its own lanes."""
    from salamander_tpu_torch import extraction

    X = torch.as_tensor(np.maximum(counts().to_numpy().T,
                                   extraction.EPSILON))
    generator = torch.Generator().manual_seed(3)
    X_boot = extraction._resample_all(X, generator, 4, "multinomial")
    lane_ranks = np.repeat([2, 3], 4)[lo:hi]
    lane_replicates = np.tile(np.arange(4), 2)[lo:hi]
    params0, data = extraction._prepare_lanes(X_boot, 3, lane_ranks,
                                              lane_replicates, 3)
    return {"W": params0["W"].numpy(), "H": params0["H"].numpy(),
            "X": data["X"].numpy()}


def assign_run(mesh=None, pkg=None, **kwargs):
    if pkg is None:
        assign_signatures, placement = port.assign_signatures, {
            "device": "cpu"}
    else:
        assign_signatures, placement = pkg.assign_signatures, {}
    result = assign_signatures(counts(), catalog(), rel_tol=0.02,
                               **({} if mesh is None else {"mesh": mesh}),
                               **placement, **kwargs)
    return {"exposures": result.exposures.to_numpy(),
            "active": result.active.to_numpy(),
            "kl_sparse": result.kl_sparse.to_numpy(),
            "n_rounds": int(result.meta["n_rounds"])}


def dense_run(mesh=None, pkg=None):
    if pkg is None:
        return port.assign_exposures(counts(), catalog(), device="cpu",
                                     **({} if mesh is None
                                        else {"mesh": mesh})).to_numpy()
    return pkg.assign_exposures(counts(), catalog(),
                                **({} if mesh is None
                                   else {"mesh": mesh})).to_numpy()


def bootstrap_run(mesh=None):
    result = port.bootstrap_exposures(
        counts(), catalog(), 5, seed=1, device="cpu",
        **({} if mesh is None else {"mesh": mesh}))
    return {"point": result.point.to_numpy(), "mean": result.mean.to_numpy(),
            "std": result.std.to_numpy()}


def refusal(call):
    try:
        call()
    except Exception as err:  # the type and message are what is checked
        return type(err).__name__, str(err)
    return None


def cli_argv(root: Path, command: str) -> list[str]:
    sub = {"C": str(root / "counts.csv"), "CAT": str(root / "catalog.csv"),
           "M1": str(root / "mod_sbs.csv"), "M2": str(root / "mod_indel.csv")}
    return [sub.get(token, token) for token in CLI_COMMANDS[command]]


# ---------------------------------------------------------------------- #
# the world
# ---------------------------------------------------------------------- #
class BranchCounter:
    """Counts, in this process, the MvNMF line-search trials and the
    CorrNMF Newton steps (the module functions every loop calls)."""

    def __init__(self):
        from salamander_tpu_torch.ops import corrnmf, mvnmf

        self.counts = {"trials": 0, "newton": 0}
        for module, name, key in ((mvnmf, "_renormalized_objective",
                                   "trials"),
                                  (corrnmf, "_newton_step", "newton")):
            setattr(module, name, self._counted(getattr(module, name), key))

    def _counted(self, fn, key):
        def counted(*args, **kwargs):
            self.counts[key] += 1
            return fn(*args, **kwargs)

        return counted

    def take(self) -> dict:
        counts, self.counts = self.counts, {"trials": 0, "newton": 0}
        return counts


def rank_main(rank, store_path, out_dir):
    """One rank of the world: every path on every mesh, its results
    pickled to out_dir/rank<rank>.pkl."""
    import torch.distributed as dist

    from salamander_tpu_torch import cli
    from salamander_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    port.init_distributed(num_processes=WORLD, process_id=rank, device="cpu",
                          store=dist.FileStore(store_path, WORLD),
                          timeout=INIT_TIMEOUT)
    branches = BranchCounter()
    got = {}
    for name, ways in SHAPES.items():
        mesh = port.make_mesh(sample_ways=ways, device="cpu")
        fits, counted = {}, {}
        for family in FAMILIES:
            branches.take()  # what ran before on this rank's own lanes
            fits[family] = fit_run(family, mesh)
            counted[family] = dict(branches.take(),
                                   blocks=fits[family]["n_iterations"])
        got[name] = {
            "fit": fits,
            "branches": counted,
            "best_of": {family: best_of_run(family, mesh)
                        for family in FAMILIES},
            "minibatch": {family: minibatch_run(family, mesh)
                          for family in MINIBATCH_FAMILIES},
            "scan": {family: scan_run(family, mesh)
                     for family in ("mvnmf", "corrnmf")},
            "extract": extract_run(mesh),
            "assign": assign_run(mesh),
            "dense": dense_run(mesh),
            "bootstrap": bootstrap_run(mesh),
        }
        if name in SAMPLE_SHARDED:
            got[name]["fed_minibatch"] = {
                family: fed_minibatch_run(family, mesh)
                for family in MINIBATCH_FAMILIES}
            got[name]["fed_scan"] = fed_scan_run(mesh)
        if name == "1x4":
            got[name]["minibatch_full"] = {
                family: minibatch_run(family, mesh, batch_size=N_SAMPLES
                                      if family != "mmcorrnmf" else 20)
                for family in MINIBATCH_FAMILIES}
            got[name]["assign_chunked"] = assign_run(mesh, batch_size=6)
        if name == "4x1":
            lo, hi = mesh_mod.lane_range(8, mesh)
            got[name]["lanes"] = (lo, hi, lane_starts(lo, hi))
    restarts = port.make_mesh(sample_ways=1, device="cpu")
    sharded = port.make_mesh(sample_ways=4, device="cpu")
    got["refusals"] = {
        "minibatch_streaming": refusal(lambda: build(
            port, "klnmf", "cpu").fit_minibatch(
                port.AnnData(counts().copy()), streaming=True,
                mesh=sharded)),
        "corrnmf_compat": refusal(lambda: build(
            port, "corrnmf", "cpu", newton_cg_compat=True).fit(
                port.AnnData(counts().copy()), mesh=sharded)),
        "mmcorrnmf_compat": refusal(lambda: build(
            port, "mmcorrnmf", "cpu", newton_cg_compat=True).fit(
                mm_data(port), mesh=sharded)),
        "extract_lanes": refusal(lambda: port.extract_signatures(
            counts(), [2], n_bootstraps=3, device="cpu", mesh=restarts)),
        "assign_samples": refusal(lambda: port.assign_signatures(
            counts(14), catalog(), device="cpu", mesh=sharded)),
        "bootstrap_samples": refusal(lambda: port.bootstrap_exposures(
            counts(14), catalog(), 3, device="cpu", mesh=sharded)),
        "scan_corrnmf_lanes": refusal(lambda: port.rank_scan_corrnmf(
            counts().to_numpy(), [2], dim_embeddings=2, n_restarts=3,
            device="cpu", mesh=restarts)),
    }
    got["cli"] = {command: cli.main(cli_argv(out_dir, command) + [
        "--mesh", "auto", "--cpu", "-o", str(out_dir / "cli_mesh" /
                                             command)])
        for command in CLI_COMMANDS}
    with open(out_dir / f"rank{rank}.pkl", "wb") as handle:
        pickle.dump(got, handle)
    mesh_mod.barrier(restarts)
    dist.destroy_process_group()


class World:
    """The spawned world: started at once, joined (within JOIN_LIMIT,
    killing the ranks past it) on the first read of its results."""

    def __init__(self, root: Path):
        self.root = root
        counts().T.to_csv(root / "counts.csv")  # features x samples
        catalog().to_csv(root / "catalog.csv")
        for name, X in mm_counts().items():
            frame = pd.DataFrame(X, index=[f"s{d}" for d in range(len(X))],
                                 columns=[f"{name}{v}"
                                          for v in range(X.shape[1])])
            frame.T.to_csv(root / f"mod_{name}.csv")
        self.context = mp.start_processes(
            rank_main, args=(str(root / "store"), str(root)), nprocs=WORLD,
            join=False, start_method="spawn")
        self.started = time.monotonic()
        self._ranks = None

    def ranks(self) -> list[dict]:
        if self._ranks is None:
            try:
                while not self.context.join(timeout=max(
                        1.0, JOIN_LIMIT - (time.monotonic() - self.started))):
                    if time.monotonic() - self.started > JOIN_LIMIT:
                        raise TimeoutError(
                            f"the {WORLD}-rank world did not end within "
                            f"{JOIN_LIMIT:.0f} s")
            finally:
                for process in self.context.processes:
                    if process.is_alive():
                        process.kill()
            self._ranks = []
            for rank in range(WORLD):
                with open(self.root / f"rank{rank}.pkl", "rb") as handle:
                    self._ranks.append(pickle.load(handle))
        return self._ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    world = World(tmp_path_factory.mktemp("mesh_paths"))
    yield world
    world.ranks()  # joins (or kills) the ranks before the module ends


# ---------------------------------------------------------------------- #
# the references, computed while the world runs
# ---------------------------------------------------------------------- #
def jax_mesh(ways):
    import jax

    from salamander_tpu.parallel import make_mesh

    return make_mesh(jax.devices()[:WORLD], sample_ways=ways)


def jax_fed_minibatch_run(family, mesh, package):
    """minibatch_run through the JAX package with every epoch in
    SHARED_ORDER: its resident steps are traced anew (the caches that hold
    their traces are cleared before and after) with jax.random.permutation
    giving that order."""
    import jax
    import jax.numpy as jnp

    from salamander_tpu.ops import svi as jax_svi

    drawn = []

    def permutation(key, n_samples):
        drawn.append(n_samples)
        return jnp.asarray(SHARED_ORDER[n_samples])

    def clear():
        jax.clear_caches()
        for value in vars(jax_svi).values():
            if hasattr(value, "cache_clear"):
                value.cache_clear()

    clear()
    try:
        with patched(jax.random, "permutation", permutation):
            out = minibatch_run(family, mesh, pkg=package)
    finally:
        clear()
    assert drawn, "the JAX package's steps were not traced anew"
    return out


def jax_fed_scan_run(mesh):
    """The JAX package's rank_scan_mvnmf as fed_scan_run runs the port's."""
    import jax.numpy as jnp

    from salamander_tpu.engine import FitConfig as JaxFitConfig
    from salamander_tpu.ops.klnmf import pad_rank
    from salamander_tpu.parallel import restarts

    def padded_init(key, X, n_signatures, n_restarts, padded):
        W, H = (jnp.asarray(a, X.dtype)
                for a in shared_starts(np.asarray(X), n_signatures,
                                       n_restarts))
        W, H, mask = pad_rank(W, H, padded)
        return W, H, jnp.broadcast_to(mask, (n_restarts, padded))

    with patched(restarts, "_padded_random_init", padded_init):
        results = restarts.rank_scan_mvnmf(
            counts().to_numpy().T, [2, 3], 4, seed=3,
            config=JaxFitConfig(*SCAN_CONFIG), mesh=mesh,
            dtype=jnp.float64)
    return {k: {"losses": np.asarray(r.losses),
                "n_iterations": np.asarray(r.n_iterations),
                "W": np.asarray(r.W)} for k, r in results.items()}


def jax_references() -> dict:
    """The JAX package's mesh runs."""
    import salamander_tpu as jax_pkg
    from salamander_tpu import containers, models
    from salamander_tpu.parallel import fit_best_of

    class Package:  # the port's entry-point names over the JAX package's
        KLNMF, MvNMF, ARDNMF = models.KLNMF, models.MvNMF, models.ARDNMF
        CorrNMFDet = models.CorrNMFDet
        MultimodalCorrNMF = models.MultimodalCorrNMF
        AnnData, MuData = containers.AnnData, containers.MuData
        assign_signatures = staticmethod(jax_pkg.assign_signatures)
        assign_exposures = staticmethod(jax_pkg.assign_exposures)

    refs = {}
    for name in SAMPLE_SHARDED:
        mesh = jax_mesh(SHAPES[name])
        refs[name] = {
            "fit": {family: fit_run(family, mesh, Package)
                    for family in FAMILIES},
            "assign": assign_run(mesh, Package),
            "dense": dense_run(mesh, Package),
            "fed_minibatch": {
                family: jax_fed_minibatch_run(family, mesh, Package)
                for family in MINIBATCH_FAMILIES},
            "fed_scan": jax_fed_scan_run(mesh),
        }
    mesh = jax_mesh(4)
    refs["1x4"]["best_of"] = {
        family: best_of_run(family, mesh, Package, fit_best_of)
        for family in ("mvnmf", "ardnmf")}
    refs["1x4"]["minibatch_full"] = {
        family: minibatch_run(family, mesh, N_SAMPLES
                              if family != "mmcorrnmf" else 20, Package)
        for family in MINIBATCH_FAMILIES}
    return refs


def plain_references(root: Path) -> dict:
    """The port's meshless runs, and the CLI's plain commands."""
    from salamander_tpu_torch import cli

    codes = {command: cli.main(cli_argv(root, command) + [
        "--cpu", "-o", str(root / "cli_plain" / command)])
        for command in CLI_COMMANDS}
    assert codes == dict.fromkeys(CLI_COMMANDS, 0)
    return {
        "fit": {family: fit_run(family) for family in FAMILIES},
        "best_of": {family: best_of_run(family) for family in FAMILIES},
        "minibatch": {family: minibatch_run(family)
                      for family in MINIBATCH_FAMILIES},
        "scan": {family: scan_run(family) for family in ("mvnmf", "corrnmf")},
        "extract": extract_run(),
        "lanes": lane_starts(0, 8),
        "assign": assign_run(),
        "assign_chunked": assign_run(batch_size=8),
        "dense": dense_run(),
        "bootstrap": bootstrap_run(),
    }


@pytest.fixture(scope="module")
def refs(world):
    return {"jax": jax_references(), "plain": plain_references(world.root)}


@pytest.fixture(scope="module")
def ranks(world, refs):
    return world.ranks()


# ---------------------------------------------------------------------- #
# comparisons
# ---------------------------------------------------------------------- #
FIT_RTOL = {"history": TRACE, "signatures": SIGNATURES,
            "exposures": EXPOSURES, "embeddings": EXPOSURES}


def assert_fit(got, ref, rtol=None):
    """Equal iteration counts; each array at its tolerance."""
    for key, value in ref.items():
        if key in ("n_iterations", "best_index", "n_rounds", "suggested"):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            np.testing.assert_allclose(
                got[key], value, rtol=rtol or FIT_RTOL.get(key, 1e-8),
                atol=1e-300, err_msg=key)


def assert_bit_equal(got, ref):
    for key, value in ref.items():
        if isinstance(value, dict):
            assert_bit_equal(got[key], value)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", SAMPLE_SHARDED)
def test_fit_on_the_sample_axis_matches_jax_and_meshless(ranks, refs, name,
                                                         family):
    for got in ranks:
        assert_fit(got[name]["fit"][family], refs["jax"][name]["fit"][family])
        assert_fit(got[name]["fit"][family], refs["plain"]["fit"][family])


@pytest.mark.parametrize("family", FAMILIES)
def test_fit_on_a_restart_only_mesh_is_the_meshless_fit(ranks, refs,
                                                        family):
    for got in ranks:
        assert_bit_equal(got["4x1"]["fit"][family],
                         refs["plain"]["fit"][family])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", SAMPLE_SHARDED)
def test_every_rank_takes_the_same_branches(ranks, name, family):
    """Equal line-search trials, Newton steps and stop blocks on every
    rank, and every rank's own trace and signatures bit-equal: each
    branch read only all-reduced values."""
    first = ranks[0][name]
    assert first["branches"][family]["blocks"] > 0
    if family == "mvnmf":
        assert first["branches"][family]["trials"] > 0
    if family in ("corrnmf", "mmcorrnmf"):
        assert first["branches"][family]["newton"] > 0
    for got in ranks[1:]:
        assert got[name]["branches"][family] == first["branches"][family]
        for key in ("history", "signatures"):
            np.testing.assert_array_equal(got[name]["fit"][family][key],
                                          first["fit"][family][key])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_fit_best_of_on_every_mesh(ranks, refs, name, family):
    """Every family's lanes on both axes; the restart-only mesh gives the
    meshless lanes bit for bit."""
    plain = refs["plain"]["best_of"][family]
    for got in ranks:
        if name == "4x1":
            assert_bit_equal(got[name]["best_of"][family], plain)
        else:
            assert_fit(got[name]["best_of"][family], plain, rtol=1e-8)
        if name == "1x4" and family in refs["jax"]["1x4"]["best_of"]:
            assert_fit(got[name]["best_of"][family],
                       refs["jax"]["1x4"]["best_of"][family], rtol=1e-8)


@pytest.mark.parametrize("family", MINIBATCH_FAMILIES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_fit_minibatch_on_every_mesh(ranks, refs, name, family):
    """B = 7 of 16 (20): every rank draws the meshless batches; the
    traces at 1e-9 and the parameters at 1e-7 (embeddings 1e-6)."""
    plain = refs["plain"]["minibatch"][family]
    for got in ranks:
        if name == "4x1":
            assert_bit_equal(got[name]["minibatch"][family], plain)
        else:
            assert_fit(got[name]["minibatch"][family], plain)


@pytest.mark.parametrize("family", MINIBATCH_FAMILIES)
def test_fit_minibatch_full_batch_matches_the_jax_mesh_run(ranks, refs,
                                                           family):
    ref = refs["jax"]["1x4"]["minibatch_full"][family]
    for got in ranks:
        run = got["1x4"]["minibatch_full"][family]
        np.testing.assert_allclose(run["history"], ref["history"],
                                   rtol=1e-8)
        np.testing.assert_allclose(run["signatures"], ref["signatures"],
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("family", MINIBATCH_FAMILIES)
@pytest.mark.parametrize("name", SAMPLE_SHARDED)
def test_fit_minibatch_fed_one_epoch_order_matches_the_jax_mesh_run(
        ranks, refs, name, family):
    """B = 7, both packages fed SHARED_ORDER: the JAX package's batches,
    so the mesh run is held against its mesh run at the fits' tolerances;
    the embeddings, out of Newton solves stopped at a threshold, with
    atol 1e-8 besides, as test_torch_ops_svi.py holds the cores."""
    ref = dict(refs["jax"][name]["fed_minibatch"][family])
    embeddings = ref.pop("embeddings", None)
    for got in ranks:
        run = dict(got[name]["fed_minibatch"][family])
        if embeddings is not None:
            np.testing.assert_allclose(run.pop("embeddings"), embeddings,
                                       rtol=EXPOSURES, atol=1e-8)
        assert_fit(run, ref)


@pytest.mark.parametrize("name", SAMPLE_SHARDED)
def test_rank_scan_mvnmf_on_the_sample_axis_matches_the_jax_mesh_run(
        ranks, refs, name):
    """Both packages fed shared_starts: equal iterations, losses at the
    traces' tolerance and signatures at theirs."""
    ref = refs["jax"][name]["fed_scan"]
    for got in ranks:
        scan = got[name]["fed_scan"]
        assert list(scan) == list(ref) == [2, 3]
        for k in (2, 3):
            np.testing.assert_array_equal(scan[k]["n_iterations"],
                                          ref[k]["n_iterations"])
            np.testing.assert_allclose(scan[k]["losses"], ref[k]["losses"],
                                       rtol=TRACE)
            np.testing.assert_allclose(scan[k]["W"], ref[k]["W"],
                                       rtol=SIGNATURES, atol=1e-12)


@pytest.mark.parametrize("family", ["mvnmf", "corrnmf"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_rank_scans_on_every_mesh(ranks, refs, name, family):
    """rank_scan_mvnmf shards lanes and samples; rank_scan_corrnmf shards
    the lanes with the counts replicated, as the JAX package does, so the
    ranks of a sample row run the same lanes."""
    plain = refs["plain"]["scan"][family]
    for got in ranks:
        scan = got[name]["scan"][family]
        assert list(scan) == [2, 3]
        for k in (2, 3):
            if name == "4x1" or family == "corrnmf":
                assert_bit_equal(scan[k], plain[k])
            else:
                assert_fit(scan[k], plain[k], rtol=1e-8)


@pytest.mark.parametrize("name", list(SHAPES))
def test_extraction_on_every_mesh(ranks, refs, name):
    """Restart-sharded lanes are the meshless lanes bit for bit;
    sample-sharded lanes agree at the JAX package's own mesh tolerance
    (tests/test_extraction.py: losses 1e-10, consensus and table 1e-8)."""
    plain = refs["plain"]["extract"]
    for got in ranks:
        run = got[name]["extract"]
        assert run["suggested"] == plain["suggested"]
        if name == "4x1":
            assert_bit_equal(run, plain)
            continue
        for k in (2, 3):
            np.testing.assert_array_equal(run[f"iterations_{k}"],
                                          plain[f"iterations_{k}"])
            np.testing.assert_allclose(run[f"losses_{k}"],
                                       plain[f"losses_{k}"], rtol=1e-10)
            np.testing.assert_allclose(run[f"consensus_{k}"],
                                       plain[f"consensus_{k}"], rtol=1e-8,
                                       atol=1e-12)
            np.testing.assert_allclose(run[f"exposures_{k}"],
                                       plain[f"exposures_{k}"], rtol=1e-6)
        np.testing.assert_allclose(run["table"], plain["table"], rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(run["final"], plain["final"], rtol=1e-6)


def test_a_lane_starts_as_without_a_mesh(ranks, refs):
    """A rank of a restart-sharded mesh draws only its own lanes: their
    resamples and starts are the meshless ones (keyed draws)."""
    seen = set()
    for got in ranks:
        lo, hi, lanes = got["4x1"]["lanes"]
        seen.update(range(lo, hi))
        for key, value in lanes.items():
            np.testing.assert_array_equal(
                value, refs["plain"]["lanes"][key][lo:hi], err_msg=key)
    assert seen == set(range(8))


@pytest.mark.parametrize("name", SAMPLE_SHARDED)
def test_assignment_matches_jax_and_meshless(ranks, refs, name):
    for got in ranks:
        for ref in (refs["jax"][name], refs["plain"]):
            np.testing.assert_array_equal(got[name]["assign"]["active"],
                                          ref["assign"]["active"])
            assert (got[name]["assign"]["n_rounds"]
                    == ref["assign"]["n_rounds"])
            for key in ("exposures", "kl_sparse"):
                np.testing.assert_allclose(got[name]["assign"][key],
                                           ref["assign"][key], rtol=1e-8,
                                           atol=1e-12)
            np.testing.assert_allclose(got[name]["dense"], ref["dense"],
                                       rtol=1e-8, atol=1e-12)


def test_assignment_chunks_round_up_to_the_sample_ways(ranks, refs):
    """batch_size=6 on 4 sample ways runs chunks of 8, as the JAX package
    rounds them."""
    plain = refs["plain"]["assign_chunked"]
    for got in ranks:
        run = got["1x4"]["assign_chunked"]
        np.testing.assert_array_equal(run["active"], plain["active"])
        np.testing.assert_allclose(run["exposures"], plain["exposures"],
                                   rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", list(SHAPES))
def test_bootstrap_exposures_on_every_mesh(ranks, refs, name):
    plain = refs["plain"]["bootstrap"]
    for got in ranks:
        if SHAPES[name] == 1:
            assert_bit_equal(got[name]["bootstrap"], plain)
        else:
            for key, value in plain.items():
                np.testing.assert_allclose(got[name]["bootstrap"][key],
                                           value, rtol=1e-8, atol=1e-12,
                                           err_msg=key)


@pytest.mark.parametrize("case, error, match", [
    ("minibatch_streaming", "ValueError", "mutually exclusive"),
    ("corrnmf_compat", "ValueError", "host-loop compatibility"),
    ("mmcorrnmf_compat", "ValueError", "newton_cg_compat"),
    ("extract_lanes", "ValueError", "must divide the 3 lanes"),
    ("assign_samples", "ValueError",
     "sample axis (14) must divide the mesh's 4 sample ways"),
    ("bootstrap_samples", "ValueError",
     "sample axis (14) must divide the mesh's 4 sample ways"),
    ("scan_corrnmf_lanes", "ValueError", "must divide the 3 lanes"),
])
def test_the_jax_packages_refusals(ranks, case, error, match):
    for got in ranks:
        assert got["refusals"][case] is not None
        name, message = got["refusals"][case]
        assert name == error and match in message, message


@pytest.mark.parametrize("command", list(CLI_COMMANDS))
def test_cli_under_mesh_writes_the_plain_run_files(world, ranks, command):
    """Every rank ran the command under --mesh auto ((1, 4)); the mesh's
    first rank alone wrote its files, which equal the plain command's
    (float32 where the command has no --dtype, whose sums the sample axis
    orders otherwise)."""
    assert [got["cli"][command] for got in ranks] == [0] * WORLD
    plain_dir = world.root / "cli_plain" / command
    mesh_dir = world.root / "cli_mesh" / command
    names = sorted(path.name for path in plain_dir.glob("*.csv"))
    assert names and names == sorted(
        path.name for path in mesh_dir.glob("*.csv"))
    rtol = 1e-6 if "--dtype" in CLI_COMMANDS[command] else 1e-4
    for file_name in names:
        got = pd.read_csv(mesh_dir / file_name, index_col=0)
        ref = pd.read_csv(plain_dir / file_name, index_col=0)
        pd.testing.assert_index_equal(got.index, ref.index)
        pd.testing.assert_index_equal(got.columns, ref.columns)
        np.testing.assert_allclose(got.to_numpy(float), ref.to_numpy(float),
                                   rtol=rtol, atol=1e-6, err_msg=file_name)


def test_the_world_is_gone(world, ranks):
    assert not any(process.is_alive()
                   for process in world.context.processes)
