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
    "salamander_tpu_torch.checkpoint",
    "salamander_tpu_torch.models.ardnmf",
    "salamander_tpu_torch.models.corrnmf",
    "salamander_tpu_torch.models.corrnmf_det",
    "salamander_tpu_torch.models.mvnmf",
    "salamander_tpu_torch.ops.ardnmf",
    "salamander_tpu_torch.ops.corrnmf",
    "salamander_tpu_torch.ops.mvnmf",
    "salamander_tpu_torch.parallel.compaction",
    "salamander_tpu_torch.parallel.corrnmf_scan",
    "salamander_tpu_torch.parallel.multistart",
    "salamander_tpu_torch.parallel.restarts",
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


@pytest.mark.parametrize("call, waits_for", [
    (lambda port: port.CorrNMFDet(2, device="cpu").fit_minibatch(None),
     "ops/svi.py"),
    (lambda port: port.CorrNMFDet(2, device="cpu").plot_embeddings(),
     "plot.py"),
    (lambda port: port.ARDNMF(2, device="cpu").plot_relevance(), "plot.py"),
], ids=["fit_minibatch", "plot_embeddings", "plot_relevance"])
def test_unported_methods_name_the_slice_they_wait_for(call, waits_for):
    import salamander_tpu_torch as port

    with pytest.raises(NotImplementedError, match=waits_for):
        call(port)


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
