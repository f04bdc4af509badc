"""What the benchmark's files import: no module of JAX or of the JAX
package anywhere (top-level names compared whole, so ``pycwt_torch`` is not
taken for ``pycwt_tpu``), nothing of the program in the reference, and none
of the JAX side's scripts or records read."""
import ast
import os

import pytest

from conftest import REPO
from cwtbench import harness

BENCH = os.path.join(REPO, "cwtbench")
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs
               if f.endswith(".py") and "__pycache__" not in d)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if "/reference/" in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "functools", "math", "numpy", "torch"}
    with open(path) as f:
        assert "pycwt" not in f.read().replace("pycwt's", "")


@pytest.mark.parametrize("path", [p for p in FILES if "/tests/" not in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reads_nothing_of_the_jax_side(path):
    with open(path) as f:
        text = f.read()
    for word in ("chip_smoke", "BENCH_r", "MULTICHIP", "tools/tpu", "import bench"):
        assert word not in text


def test_span_targets_are_the_ports():
    for d in ("metrics",):
        for fn in os.listdir(os.path.join(BENCH, d)):
            if fn.endswith(".py"):
                mod = harness.load_module(d, fn[:-3])
                for _, module, _ in getattr(mod, "SPANS", ()):
                    assert module.split(".", 1)[0] == "pycwt_torch"
