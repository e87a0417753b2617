"""salamander_tpu_torch's (restarts, samples) meshes across ranks.

One 4-process gloo world per module (torch.multiprocessing spawn, a
FileStore rendezvous under tmp_path so parallel workers never collide, a
60 s process-group timeout and a 180 s join limit that kills the
children) builds the meshes (4, 1), (1, 4) and (2, 2) in turn and runs
every ported mesh path on them: the multi-start runners, fit_klnmf_restarts
(monolithic and compacted), KLNMF.fit (plain, weights_kl, weights_lhalf,
given signatures, warm start), fit_best_of (KLNMF on every mesh, CorrNMFDet
and MultimodalCorrNMF on (4, 1) and (1, 4)), rank_scan_klnmf padded and
unpadded with compaction and a checkpoint store, rank_scan_mvnmf and
MvNMF.fit on both axes, the CLI's fit, fit --resume and scan, and the
refusals (test_torch_mesh_paths.py runs the other item-18 paths in a world
of its own). Each rank writes
what it got; the tests hold it, at float64, against the port without a
mesh and against the JAX package's mesh run on its 8-device virtual CPU
mesh (tests/conftest.py): equal iteration counts, rtol 1e-8. The world
starts when the module's first test asks for it and runs while the
references are computed.

The worker imports neither jax nor the JAX package: the tests do, inside
their bodies, so the spawned ranks import this module without them.
"""

import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import salamander_tpu_torch as port
from salamander_tpu_torch.engine import FitConfig

torch.set_num_threads(1)

WORLD = 4
SHAPES = {"4x1": 1, "1x4": 4, "2x2": 2}  # mesh name -> sample ways
N_SAMPLES = 16
R = 8
K = 3
CONFIG = FitConfig(min_iterations=20, max_iterations=200, conv_test_freq=10,
                   tol=1e-4)
HYPER = dict(n_signatures=K, min_iterations=20, max_iterations=200,
             tol=1e-5)
BEST_OF_HYPER = dict(HYPER, tol=1e-4)  # lanes stop apart
FIT_CASES = ("plain", "weights_kl", "weights_lhalf", "given_signatures",
             "warm_start")
RTOL = 1e-8
INIT_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_LIMIT = 180.0
CLI_FIT = ["-k", "3", "--seed", "1", "--dtype", "float64",
           "--min-iterations", "20", "--max-iterations", "200",
           "--tol", "1e-5"]
CLI_SCAN = ["--ranks", "2-3", "-r", "4", "--min-iterations", "20",
            "--max-iterations", "200", "--tol", "1e-4"]


# ---------------------------------------------------------------------- #
# inputs (numpy, the same in every rank and in the tests)
# ---------------------------------------------------------------------- #
def counts(n_samples=N_SAMPLES):
    """PCAWG SBS counts, samples x features."""
    return port.datasets.load_pcawg_sbs().iloc[:n_samples]


def runner_inputs():
    """Numpy params0 and data of the multi-start runner: R lanes."""
    X = np.ascontiguousarray(counts().to_numpy().T, dtype=float)
    rng = np.random.default_rng(9)
    W = rng.dirichlet(np.ones(X.shape[0]), (R, K)).transpose(0, 2, 1)
    H = rng.uniform(1.0, 300.0, (R, K, N_SAMPLES))
    return {"W": W, "H": H}, {"X": X}


def masked_inputs():
    """Numpy params0 of the rank-masked runner: ranks 2 and 3 inside
    Kp = 4, four lanes each."""
    from salamander_tpu_torch.ops import klnmf

    X = np.ascontiguousarray(counts().to_numpy().T, dtype=float)
    rng = np.random.default_rng(4)
    parts = []
    for k in (2, 3):
        W = rng.dirichlet(np.ones(X.shape[0]), (R // 2, k)).transpose(0, 2, 1)
        H = rng.uniform(1.0, 300.0, (R // 2, k, N_SAMPLES))
        W_pad, H_pad, mask = klnmf.pad_rank(torch.as_tensor(W),
                                            torch.as_tensor(H), 4)
        parts.append((W_pad.numpy(), H_pad.numpy(),
                      np.broadcast_to(mask.numpy(), (R // 2, 4))))
    params0 = {name: np.concatenate([part[i] for part in parts])
               for i, name in enumerate(("W", "H", "mask"))}
    return params0, {"X": X}


def torch_tree(tree):
    return {name: torch.as_tensor(np.array(leaf)) for name, leaf in
            tree.items()}


def mm_mdata(containers, n_samples=20):
    rng = np.random.default_rng(0)
    load = rng.gamma(2.0, 1.0, (n_samples, 3))
    return containers.MuData({
        name: containers.AnnData(rng.poisson(
            60.0 * load @ rng.dirichlet(np.ones(n_features), 3)
        ).astype(float))
        for name, n_features in {"sbs": 12, "indel": 9, "sv": 6}.items()
    })


# ---------------------------------------------------------------------- #
# the runs, each through the port (mesh=None: meshless) or, where
# `pkg` is the JAX package's, through it
# ---------------------------------------------------------------------- #
def runner_run(mesh=None):
    params0, data = runner_inputs()
    run = port.build_klnmf_restart_runner(CONFIG, mesh)
    params, losses, n_iterations = run(torch_tree(params0), torch_tree(data))
    return {"W": params["W"].numpy(), "H": params["H"].numpy(),
            "losses": losses.numpy(), "n_iterations": n_iterations.numpy()}


def masked_run(mesh=None):
    from salamander_tpu_torch.parallel.restarts import (
        build_klnmf_masked_runner,
    )

    params0, data = masked_inputs()
    params, losses, n_iterations = build_klnmf_masked_runner(CONFIG, mesh)(
        torch_tree(params0), torch_tree(data))
    return {"W": params["W"].numpy(), "H": params["H"].numpy(),
            "losses": losses.numpy(), "n_iterations": n_iterations.numpy()}


def restarts_run(mesh=None, **kwargs):
    result = port.fit_klnmf_restarts(
        counts().to_numpy().T, K, R, seed=5, config=CONFIG, mesh=mesh,
        dtype=torch.float64, device="cpu", **kwargs)
    return {"W": np.asarray(result.W), "H": np.asarray(result.H),
            "losses": result.losses, "n_iterations": result.n_iterations}


def model_summary(model):
    return {"signatures": np.asarray(model.asignatures.X),
            "exposures": np.asarray(model.adata.obsm["exposures"]),
            "history": np.asarray(model.history["objective_function"]),
            "n_iterations": int(model.history["n_iterations"])}


def fit_run(case, mesh=None, KLNMF=None, AnnData=None, device="cpu"):
    """KLNMF(3).fit of one case: the port's classes unless others are
    given (the JAX package's, with device=None)."""
    KLNMF = KLNMF or port.KLNMF
    AnnData = AnnData or port.AnnData
    given = fitting = None
    if case == "given_signatures":
        spectra = port.datasets.load_pcawg_sbs().iloc[
            N_SAMPLES:N_SAMPLES + 2]
        given = {"asignatures": AnnData(
            spectra / spectra.sum(axis=1).to_numpy()[:, None])}
    elif case == "weights_kl":
        fitting = {"weights_kl": np.random.default_rng(5).uniform(
            0.5, 2.0, N_SAMPLES)}
    elif case == "weights_lhalf":
        fitting = {"weights_lhalf": 30.0}
    placement = {} if device is None else {"device": device}
    on_mesh = {} if mesh is None else {"mesh": mesh}
    model = KLNMF(init_method="random", **HYPER, **placement)
    adata = AnnData(counts().copy())
    model.fit(adata, given_parameters=given, init_kwargs={"seed": 2},
              fitting_kwargs=fitting, **on_mesh)
    if case == "warm_start":
        model.fit(adata, warm_start=True, **on_mesh)
    return model_summary(model)


def best_of_summary(model, summary):
    return {"losses": summary.losses, "n_iterations": summary.n_iterations,
            "history": summary.history, "best_index": summary.best_index,
            "signatures": summary.signatures,
            "model_history": np.asarray(model.history["objective_function"])}


def best_of_run(family, mesh=None, n_samples=N_SAMPLES, **kwargs):
    if family == "KLNMF":
        model = port.KLNMF(init_method="random", device="cpu",
                           **BEST_OF_HYPER)
        data = port.AnnData(counts(n_samples).copy())
    elif family == "CorrNMFDet":
        model = port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                                init_method="random", min_iterations=10,
                                max_iterations=40, device="cpu")
        data = port.AnnData(counts(n_samples).copy())
    else:
        model = port.MultimodalCorrNMF(
            ns_signatures=[3, 2, 2], dim_embeddings=2, init_method="random",
            min_iterations=10, max_iterations=60, tol=3e-3, device="cpu")
        data = mm_mdata(port)
    summary = port.fit_best_of(model, data, R if family == "KLNMF" else 4,
                               base_seed=7, batched_init=False, mesh=mesh,
                               **kwargs)
    out = best_of_summary(model, summary)
    if family != "KLNMF":
        out["signatures"] = None  # compared lane by lane through losses
    return out


def scan_run(mesh=None, **kwargs):
    results = port.rank_scan_klnmf(
        counts().to_numpy().T, [2, 3], R, seed=11, config=CONFIG, mesh=mesh,
        dtype=torch.float64, device="cpu", compact=True,
        compact_min_bucket=1, **kwargs)
    return {k: {"W": np.asarray(r.W), "H": np.asarray(r.H),
                "losses": np.asarray(r.losses),
                "n_iterations": np.asarray(r.n_iterations)}
            for k, r in results.items()}


def mvnmf_scan_run(mesh=None):
    results = port.rank_scan_mvnmf(
        counts().to_numpy().T, [2, 3], 4, seed=3,
        config=FitConfig(min_iterations=10, max_iterations=60,
                         conv_test_freq=10, tol=1e-4),
        mesh=mesh, dtype=torch.float64, device="cpu")
    return {k: {"losses": np.asarray(r.losses),
                "n_iterations": np.asarray(r.n_iterations),
                "W": np.asarray(r.W)} for k, r in results.items()}


def mvnmf_fit_run(mesh=None):
    """MvNMF(2).fit: on a restart-only mesh every rank does the whole fit,
    as the JAX package replicates it."""
    on_mesh = {} if mesh is None else {"mesh": mesh}
    model = port.MvNMF(n_signatures=2, min_iterations=10, max_iterations=60,
                       device="cpu")
    model.fit(port.AnnData(counts().copy()), **on_mesh)
    return model_summary(model)


def refusal(call):
    try:
        call()
    except Exception as err:  # the type and message are what is checked
        return type(err).__name__, str(err)
    return None


# ---------------------------------------------------------------------- #
# the world
# ---------------------------------------------------------------------- #
def rank_main(rank, store_path, out_dir):
    """One rank of the world: every mesh path on every mesh, its results
    pickled to out_dir/rank<rank>.pkl."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from salamander_tpu_torch import cli
    from salamander_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    port.init_distributed(num_processes=WORLD, process_id=rank, device="cpu",
                          store=dist.FileStore(store_path, WORLD),
                          timeout=INIT_TIMEOUT)
    got = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    for name, ways in SHAPES.items():
        mesh = port.make_mesh(sample_ways=ways, device="cpu")
        got[name] = {
            "shape": tuple(mesh.shape),
            "coordinate": tuple(mesh.get_coordinate()),
            "runner": runner_run(mesh),
            "masked": masked_run(mesh),
            "restarts": restarts_run(mesh),
            "restarts_compact": restarts_run(mesh, compact=True,
                                             compact_min_bucket=1),
            "fit": {case: fit_run(case, mesh) for case in FIT_CASES},
            "best_of": best_of_run("KLNMF", mesh),
            "best_of_compact": best_of_run("KLNMF", mesh, compact=True,
                                           compact_min_bucket=1),
            "scan": scan_run(mesh, pad_ranks=False),
            "scan_padded": scan_run(mesh, pad_ranks=True, pack_points=True),
        }
        store = out_dir / f"scan_store_{name}"
        got[name]["scan_stored"] = scan_run(mesh, checkpoint_dir=store)
        got[name]["scan_resumed"] = scan_run(mesh, checkpoint_dir=store)
    mesh = port.make_mesh(sample_ways=1, device="cpu")
    got["4x1"]["best_of_corrnmf"] = best_of_run("CorrNMFDet", mesh)
    got["4x1"]["best_of_mmcorrnmf"] = best_of_run("MultimodalCorrNMF", mesh)
    got["4x1"]["scan_mvnmf"] = mvnmf_scan_run(mesh)
    got["4x1"]["fit_mvnmf"] = mvnmf_fit_run(mesh)
    sharded = port.make_mesh(sample_ways=4, device="cpu")
    got["1x4"]["best_of_corrnmf"] = best_of_run("CorrNMFDet", sharded)
    got["1x4"]["best_of_corrnmf_14"] = best_of_run("CorrNMFDet", sharded,
                                                   n_samples=14)
    got["1x4"]["scan_mvnmf"] = mvnmf_scan_run(sharded)
    got["1x4"]["fit_mvnmf"] = mvnmf_fit_run(sharded)
    flat = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("data",))
    got["refusals"] = {
        "no_samples_axis": refusal(lambda: fit_run("plain", flat)),
        "lanes_do_not_divide": refusal(lambda: port.fit_klnmf_restarts(
            counts().to_numpy().T, K, 6, mesh=mesh, device="cpu")),
        "samples_do_not_divide": refusal(lambda: port.KLNMF(
            2, device="cpu").fit(port.AnnData(counts(14).copy()),
                                 mesh=sharded)),
        "mvnmf_samples": refusal(lambda: port.MvNMF(2, device="cpu").fit(
            port.AnnData(counts(14).copy()), mesh=sharded)),
        "best_of_corrnmf_samples": refusal(lambda: port.fit_best_of(
            port.CorrNMFDet(n_signatures=2, dim_embeddings=2,
                            device="cpu"),
            port.AnnData(counts().copy()), 3, mesh=mesh)),
        "scan_mvnmf_samples": refusal(lambda: port.rank_scan_mvnmf(
            counts(14).to_numpy().T, [2], 4, mesh=sharded, device="cpu")),
        "not_a_mesh": refusal(lambda: mesh_mod.sample_range(16, object())),
    }
    csv = str(out_dir / "counts.csv")
    cli_out = out_dir / "cli_mesh"
    got["cli"] = [
        cli.main(["fit", csv, *CLI_FIT, "--mesh", "samples=2", "--cpu",
                  "-o", str(cli_out / "fit")]),
        cli.main(["fit", csv, *CLI_FIT, "--resume",
                  str(out_dir / "cli_plain" / "fit" / "model.npz"),
                  "--mesh", "samples=4", "--cpu",
                  "-o", str(cli_out / "resume")]),
        cli.main(["scan", csv, *CLI_SCAN, "--mesh", "auto", "--cpu",
                  "-o", str(cli_out / "scan")]),
    ]
    with open(out_dir / f"rank{rank}.pkl", "wb") as handle:
        pickle.dump(got, handle)
    mesh_mod.barrier(mesh)
    dist.destroy_process_group()


class World:
    """The spawned world: started at once, joined (within JOIN_LIMIT,
    killing the ranks past it) on the first read of its results."""

    def __init__(self, root: Path):
        from salamander_tpu_torch import cli

        self.root = root
        counts().T.to_csv(root / "counts.csv")  # features x samples
        # the plain fit --resume starts from, before the ranks need it
        assert cli.main(["fit", str(root / "counts.csv"), *CLI_FIT, "--cpu",
                         "-o", str(root / "cli_plain" / "fit")]) == 0
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
    world = World(tmp_path_factory.mktemp("world"))
    yield world
    world.ranks()  # joins (or kills) the ranks before the module ends


def assert_same_run(got, ref, rtol=RTOL):
    """Equal iteration counts, every array at rtol."""
    for key, value in ref.items():
        if key in ("n_iterations", "best_index"):
            np.testing.assert_array_equal(got[key], value)
        elif value is not None:
            np.testing.assert_allclose(got[key], value, rtol=rtol,
                                       atol=1e-300, err_msg=key)


def assert_bit_equal(got, ref):
    for key, value in ref.items():
        if value is not None:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def jax_mesh(ways):
    import jax

    from salamander_tpu.parallel import make_mesh

    return make_mesh(jax.devices()[:WORLD], sample_ways=ways)


# ---------------------------------------------------------------------- #
# the references, computed while the world runs
# ---------------------------------------------------------------------- #
def jax_references() -> dict:
    """The JAX package's mesh runs, mesh shape by mesh shape."""
    from salamander_tpu import containers as jax_containers
    from salamander_tpu import models as jax_models
    from salamander_tpu.engine import FitConfig as JaxFitConfig
    from salamander_tpu.parallel import fit_best_of as jax_fit_best_of
    from salamander_tpu.parallel.restarts import (
        build_klnmf_masked_runner,
        build_klnmf_restart_runner,
    )

    def lanes(run, inputs):
        params, losses, n_iterations = run(*inputs)
        return {"W": np.asarray(params["W"]), "H": np.asarray(params["H"]),
                "losses": np.asarray(losses),
                "n_iterations": np.asarray(n_iterations)}

    refs = {}
    for name, ways in SHAPES.items():
        mesh = jax_mesh(ways)
        model = jax_models.KLNMF(init_method="random", **BEST_OF_HYPER)
        refs[name] = {
            "runner": lanes(build_klnmf_restart_runner(
                JaxFitConfig(*CONFIG), mesh=mesh), runner_inputs()),
            "masked": lanes(build_klnmf_masked_runner(
                JaxFitConfig(*CONFIG), mesh=mesh), masked_inputs()),
            "fit": {case: fit_run(case, mesh, KLNMF=jax_models.KLNMF,
                                  AnnData=jax_containers.AnnData,
                                  device=None)
                    for case in FIT_CASES},
            "best_of": best_of_summary(model, jax_fit_best_of(
                model, jax_containers.AnnData(counts().copy()), R,
                base_seed=7, batched_init=False, mesh=mesh)),
        }
    return refs


def plain_references(root: Path) -> dict:
    """The port's meshless runs, and the CLI's plain commands."""
    from salamander_tpu_torch import cli

    csv = str(root / "counts.csv")
    plain = root / "cli_plain"
    codes = [
        cli.main(["fit", csv, *CLI_FIT, "--resume",
                  str(plain / "fit" / "model.npz"), "--cpu",
                  "-o", str(plain / "resume")]),
        cli.main(["scan", csv, *CLI_SCAN, "--cpu", "-o", str(plain / "scan")]),
    ]
    assert codes == [0, 0]
    return {
        "runner": runner_run(),
        "masked": masked_run(),
        "restarts": restarts_run(),
        "fit": {case: fit_run(case) for case in FIT_CASES},
        "best_of": best_of_run("KLNMF"),
        "best_of_corrnmf": best_of_run("CorrNMFDet"),
        "best_of_corrnmf_14": best_of_run("CorrNMFDet", n_samples=14),
        "best_of_mmcorrnmf": best_of_run("MultimodalCorrNMF"),
        "scan": scan_run(pad_ranks=False),
        "scan_mvnmf": mvnmf_scan_run(),
        "fit_mvnmf": mvnmf_fit_run(),
    }


@pytest.fixture(scope="module")
def refs(world):
    return {"jax": jax_references(), "plain": plain_references(world.root)}


@pytest.fixture(scope="module")
def ranks(world, refs):
    return world.ranks()


# ---------------------------------------------------------------------- #
# the tests
# ---------------------------------------------------------------------- #
def test_world_builds_each_mesh_on_every_rank(ranks):
    for rank, got in enumerate(ranks):
        assert (got["world"], got["rank"]) == (WORLD, rank)
        for name, ways in SHAPES.items():
            assert got[name]["shape"] == (WORLD // ways, ways)
            assert got[name]["coordinate"] == divmod(rank, ways)


@pytest.mark.parametrize("runner", ["runner", "masked"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_runners_match_the_jax_mesh_run(ranks, refs, name, runner):
    """The multi-start runner and its rank-masked twin on numpy params0
    against the JAX package's runners on the same mesh shape of its
    virtual devices, and against the port without a mesh."""
    ref = refs["jax"][name][runner]
    if runner == "runner":
        assert len(set(ref["n_iterations"])) > 1  # lanes stop apart
    for got in ranks:
        assert_same_run(got[name][runner], ref)
        assert_same_run(got[name][runner], refs["plain"][runner])


@pytest.mark.parametrize("name", list(SHAPES))
def test_fit_klnmf_restarts_equals_the_meshless_fit(ranks, refs, name):
    """The same seed draws the same lanes on every mesh; on a restart-only
    mesh each lane's arithmetic is the meshless one, bit for bit."""
    plain = refs["plain"]["restarts"]
    assert len(set(plain["n_iterations"])) > 1
    for got in ranks:
        for key in ("restarts", "restarts_compact"):
            if SHAPES[name] == 1:
                assert_bit_equal(got[name][key], plain)
            else:
                assert_same_run(got[name][key], plain)


@pytest.mark.parametrize("case", FIT_CASES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_model_fit_matches_meshless_and_jax_mesh_fit(ranks, refs, name,
                                                     case):
    for got in ranks:
        assert_same_run(got[name]["fit"][case], refs["jax"][name]["fit"][case])
        assert_same_run(got[name]["fit"][case], refs["plain"]["fit"][case])


@pytest.mark.parametrize("name", list(SHAPES))
def test_every_rank_of_a_sample_row_takes_the_same_decisions(ranks, name):
    """Each rank's own history (never gathered) and iteration count: the
    loop's stop decisions read only reduced values, so every rank of a
    sample row (here: of the world) stops at the same block."""
    for case in FIT_CASES:
        first = ranks[0][name]["fit"][case]
        for got in ranks[1:]:
            assert got[name]["fit"][case]["n_iterations"] == \
                first["n_iterations"]
            np.testing.assert_array_equal(got[name]["fit"][case]["history"],
                                          first["history"])
            np.testing.assert_array_equal(
                got[name]["fit"][case]["exposures"], first["exposures"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_fit_best_of_klnmf_matches_meshless_and_jax(ranks, refs, name):
    plain = refs["plain"]["best_of"]
    assert len(set(plain["n_iterations"])) > 1
    for got in ranks:
        for key in ("best_of", "best_of_compact"):
            assert_same_run(got[name][key], refs["jax"][name]["best_of"])
            assert_same_run(got[name][key], plain)


@pytest.mark.parametrize("family", ["corrnmf", "mmcorrnmf"])
def test_fit_best_of_restart_axis_of_the_other_families(ranks, refs,
                                                        family):
    """On a restart-only mesh each rank runs its lanes alone: the gathered
    lanes are the meshless run's, bit for bit."""
    key = f"best_of_{family}"
    for got in ranks:
        assert_bit_equal(got["4x1"][key], refs["plain"][key])


@pytest.mark.parametrize("name", list(SHAPES))
def test_rank_scan_klnmf_padded_unpadded_and_stored(ranks, refs, name):
    plain = refs["plain"]["scan"]
    for got in ranks:
        for key in ("scan", "scan_padded", "scan_stored", "scan_resumed"):
            assert list(got[name][key]) == [2, 3]
            for k in (2, 3):
                if SHAPES[name] == 1:
                    assert_bit_equal(got[name][key][k], plain[k])
                else:
                    assert_same_run(got[name][key][k], plain[k])


def test_rank_scan_mvnmf_restart_axis(ranks, refs):
    for got in ranks:
        for k in (2, 3):
            assert_bit_equal(got["4x1"]["scan_mvnmf"][k],
                             refs["plain"]["scan_mvnmf"][k])


def test_mvnmf_fit_on_a_restart_only_mesh(ranks, refs):
    for got in ranks:
        assert_bit_equal(got["4x1"]["fit_mvnmf"], refs["plain"]["fit_mvnmf"])


def test_fit_best_of_replicates_samples_the_ways_do_not_divide(ranks,
                                                              refs):
    """The JAX package's fit_best_of shards only the lanes, so it takes a
    sample axis whose ways do not divide the samples (14 on 4): the port
    then fits every lane on all samples, the meshless lanes bit for
    bit."""
    for got in ranks:
        assert_bit_equal(got["1x4"]["best_of_corrnmf_14"],
                         refs["plain"]["best_of_corrnmf_14"])


@pytest.mark.parametrize("key", ["fit_mvnmf", "best_of_corrnmf",
                                 "scan_mvnmf"])
def test_item_18_paths_on_the_sample_axis(ranks, refs, key):
    """The sample axis of MvNMF.fit, of fit_best_of for the families
    besides KLNMF and of rank_scan_mvnmf (ROADMAP item 18): the meshless
    runs at the JAX package's mesh tolerances (traces 1e-9, signatures
    1e-7, exposures 1e-6, lanes 1e-8; CorrNMF lanes 1e-7, whose sample
    embeddings come out of Newton solves that the JAX package holds at
    1e-6 under a mesh, tests/test_sharding.py:78-81), equal iteration
    counts."""
    plain = refs["plain"][key]
    for got in ranks:
        run = got["1x4"][key]
        if key == "scan_mvnmf":
            for k in (2, 3):
                assert_same_run(run[k], plain[k])
        elif key == "fit_mvnmf":
            for name, rtol in (("history", 1e-9), ("signatures", 1e-7),
                               ("exposures", 1e-6)):
                np.testing.assert_allclose(run[name], plain[name],
                                           rtol=rtol, err_msg=name)
            assert run["n_iterations"] == plain["n_iterations"]
        else:
            assert_same_run(run, plain, rtol=1e-7)


@pytest.mark.parametrize("case, error, match", [
    ("no_samples_axis", "ValueError", "expects a 'samples' axis"),
    ("lanes_do_not_divide", "ValueError", "must divide the 6 lanes"),
    ("samples_do_not_divide", "ValueError",
     "4 samples ways must divide the 14 samples"),
    ("mvnmf_samples", "ValueError",
     "4 samples ways must divide the 14 samples"),
    ("best_of_corrnmf_samples", "ValueError", "must divide the 3 lanes"),
    ("scan_mvnmf_samples", "ValueError",
     "must divide the 4 lanes and 14 samples"),
    ("not_a_mesh", "TypeError", "DeviceMesh"),
])
def test_refusals(ranks, case, error, match):
    for got in ranks:
        assert got["refusals"][case] is not None
        name, message = got["refusals"][case]
        assert name == error and match in message, message


@pytest.mark.parametrize("command, rtol", [
    ("fit", RTOL), ("resume", RTOL),
    # the scan has no --dtype: float32, whose sums the sample axis orders
    # otherwise
    ("scan", 1e-5),
])
def test_cli_under_mesh_writes_the_plain_run_files(world, ranks, command,
                                                   rtol):
    """Every rank ran the command (fit on a (2, 2) mesh, fit --resume on
    (1, 4), scan --mesh auto: (1, 4)); the mesh's first rank wrote its
    files, which equal the plain command's."""
    import pandas as pd

    assert [got["cli"] for got in ranks] == [[0, 0, 0]] * WORLD
    plain_dir = world.root / "cli_plain" / command
    mesh_dir = world.root / "cli_mesh" / command
    names = sorted(path.name for path in plain_dir.glob("*.csv"))
    assert names and names == sorted(
        path.name for path in mesh_dir.glob("*.csv"))
    for file_name in names:
        got = pd.read_csv(mesh_dir / file_name, index_col=0)
        ref = pd.read_csv(plain_dir / file_name, index_col=0)
        pd.testing.assert_index_equal(got.index, ref.index)
        pd.testing.assert_index_equal(got.columns, ref.columns)
        np.testing.assert_allclose(got.to_numpy(float), ref.to_numpy(float),
                                   rtol=rtol, err_msg=file_name)
    if command == "scan":
        assert (mesh_dir / "suggested_rank.json").read_text() == \
            (plain_dir / "suggested_rank.json").read_text()


def test_the_world_is_gone(world, ranks):
    assert not any(process.is_alive()
                   for process in world.context.processes)
