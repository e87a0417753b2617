"""salamander_tpu_torch stands alone: it imports with jax (and the JAX
package) blocked, and no module of it - nor chip_smoke.py - imports
either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "salamander_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for path in PACKAGE.rglob("*.py")
)


@pytest.mark.parametrize("name", [
    "salamander_tpu_torch.__main__",
    "salamander_tpu_torch.assign",
    "salamander_tpu_torch.checkpoint",
    "salamander_tpu_torch.cli",
    "salamander_tpu_torch.datasets",
    "salamander_tpu_torch.extraction",
    "salamander_tpu_torch.io",
    "salamander_tpu_torch.models.ardnmf",
    "salamander_tpu_torch.models.corrnmf",
    "salamander_tpu_torch.models.corrnmf_det",
    "salamander_tpu_torch.models.mvnmf",
    "salamander_tpu_torch.ops.ardnmf",
    "salamander_tpu_torch.ops.assign",
    "salamander_tpu_torch.ops.corrnmf",
    "salamander_tpu_torch.ops.mvnmf",
    "salamander_tpu_torch.ops.svi",
    "salamander_tpu_torch.parallel.bootstrap",
    "salamander_tpu_torch.parallel.compaction",
    "salamander_tpu_torch.parallel.corrnmf_scan",
    "salamander_tpu_torch.parallel.mesh",
    "salamander_tpu_torch.parallel.multistart",
    "salamander_tpu_torch.parallel.restarts",
    "salamander_tpu_torch.plot",
    "salamander_tpu_torch.profiling",
    "salamander_tpu_torch.tools",
    "salamander_tpu_torch.utils",
])
def test_the_blocked_import_covers_the_module(name):
    assert name in MODULES


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['salamander_tpu'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr


def test_the_mesh_module_loads_no_jax():
    """parallel.mesh stands on torch.distributed alone: importing it (and
    building a world of one) loads no jax."""
    code = (
        "import sys\n"
        "import salamander_tpu_torch.parallel.mesh as mesh\n"
        "grid = mesh.make_mesh(device='cpu')\n"
        "assert tuple(grid.mesh_dim_names) == ('restarts', 'samples')\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "or m.startswith('salamander_tpu.') or m == 'salamander_tpu' "
        "for m in sys.modules)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr


@pytest.mark.parametrize("call, waits_for", [
    (lambda pkg, **kw: pkg.CorrNMFDet(2, **kw).fit_minibatch(
        None, streaming=True, mesh=object()), None),
    (lambda pkg, **kw: pkg.CorrNMFDet(2, **kw).plot_embeddings(), None),
    (lambda pkg, **kw: pkg.ARDNMF(2, **kw).plot_relevance(), None),
], ids=["fit_minibatch", "plot_embeddings", "plot_relevance"])
def test_unported_methods_name_the_slice_they_wait_for(call, waits_for):
    """An unported method raises NotImplementedError naming the module it
    waits for. None is left: the plots came with plot.py, and on an
    unfitted model they raise what the JAX package's raise; fit_minibatch's
    mesh came with item 18, and with streaming=True it raises the JAX
    package's refusal."""
    import salamander_tpu_torch as port

    if waits_for is not None:
        with pytest.raises(NotImplementedError, match=waits_for):
            call(port, device="cpu")
        return
    import matplotlib

    matplotlib.use("Agg")
    import salamander_tpu as jax_sal

    with pytest.raises(Exception) as expected:
        call(jax_sal.models)
    with pytest.raises(Exception) as got:
        call(port, device="cpu")
    assert not isinstance(got.value, NotImplementedError)
    assert type(got.value) is type(expected.value)
    assert str(got.value) == str(expected.value)


def test_the_package_and_the_cli_need_no_matplotlib():
    """matplotlib and seaborn are optional: with both blocked the package
    imports (without `pl`), the CLI prints its help, and a plot method
    raises ImportError."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['seaborn'] = None\n"
        "import salamander_tpu_torch as sal\n"
        "assert not hasattr(sal, 'pl') and 'pl' not in sal.__all__\n"
        "try:\n"
        "    sal.ARDNMF(2, device='cpu').plot_relevance()\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('plot_relevance drew without matplotlib')\n"
        "from salamander_tpu_torch import cli\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit as exit:\n"
        "    assert exit.code == 0\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "usage: salamander_tpu_torch" in run.stdout


@pytest.mark.parametrize("family", ["corrnmf", "klnmf", "mmcorrnmf"])
def test_svi_state_round_trips_through_numpy(family):
    """engine.transfer carries a minibatch-fit state (parameters, running
    statistics, step, sampler position) to numpy and back unchanged."""
    import numpy as np
    import torch

    from salamander_tpu_torch.engine import (
        svi_state_from_numpy,
        svi_state_to_numpy,
    )
    from salamander_tpu_torch.engine.tree import tree_flatten
    from salamander_tpu_torch.ops import svi

    generator = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=generator, dtype=torch.float64)

    corr = {"signatures": rand(2, 6), "signature_scalings": rand(2),
            "sample_scalings": rand(9), "signature_embeddings": rand(2, 2),
            "sample_embeddings": rand(9, 2), "variance": rand(())}
    if family == "corrnmf":
        state = svi.svi_init(corr)
    elif family == "klnmf":
        state = svi.klnmf_svi_init({"W": rand(6, 2), "H": rand(2, 9)})
    else:
        mod = {k: v for k, v in corr.items()
               if k not in ("sample_embeddings", "variance")}
        state = svi.mm_svi_init({
            "mods": {"a": mod, "b": dict(mod)},
            "sample_embeddings": corr["sample_embeddings"],
            "variance": corr["variance"]})
    state = state._replace(step=7, cursor=4,
                           perm=torch.randperm(9, generator=generator))
    host = svi_state_to_numpy(state)
    assert type(host) is type(state)
    assert host.step.dtype == np.int32 and host.perm.dtype == np.int32
    back = svi_state_from_numpy(host, device="cpu")
    assert type(back) is type(state)
    assert (back.step, back.cursor) == (7, 4)
    assert back.perm.dtype == torch.int64
    for field, value in state._asdict().items():
        if isinstance(value, int):
            continue
        flat = tree_flatten(value) if isinstance(value, dict) \
            else {field: value}
        flat_back = tree_flatten(getattr(back, field)) \
            if isinstance(value, dict) else {field: getattr(back, field)}
        assert list(flat) == list(flat_back)
        for path, leaf in flat.items():
            assert flat_back[path].dtype == leaf.dtype
            assert torch.equal(flat_back[path], leaf), (field, path)
    # a dict of the same fields (numpy leaves) is taken as well
    again = svi_state_from_numpy(host._asdict(), device="cpu")
    assert type(again) is type(state) and again.step == 7


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_the_jax_package(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "salamander_tpu"), (path, name)
