"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: top-level names compared whole."""

import ast
import subprocess
import sys

import pytest

from portbench import importcheck
from portbench.manifest import ROOT

SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return importcheck.top_levels(names)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not imported(path) & importcheck.FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_holds_nothing_of_the_port(path):
    assert importcheck.PROGRAM not in imported(path)


def test_whole_names():
    assert importcheck.forbidden_loaded(["salamander_tpu_torch.ops"]) == []
    assert importcheck.forbidden_loaded(["salamander_tpu.ops", "jax.numpy"]) \
        == ["jax", "salamander_tpu"]


def test_processes_load_what_they_may():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.klnmf, portbench.reference.extraction\n"
        "import portbench.reference.assign\n"
        "from portbench import importcheck\n"
        "assert importcheck.PROGRAM not in importcheck.top_levels(sys.modules)\n"
        "import portbench.run, portbench.entries.restarts\n"
        "import portbench.entries.extract, portbench.entries.assign\n"
        "import salamander_tpu_torch\n"
        "assert importcheck.forbidden_loaded() == [], importcheck.forbidden_loaded()\n"
    ) % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
