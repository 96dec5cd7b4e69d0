"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole)."""
import ast
import os
import subprocess
import sys

from gsbench.tests import toy

FORBIDDEN = {"jax", "jaxlib", "flax", "saro_gs_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(sub=""):
    for d, _, files in os.walk(os.path.join(toy.BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _modules():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        assert "saro_gs_torch" not in set(_imports(path)), path
    code = ("import sys; import gsbench.reference.step, "
            "gsbench.reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=toy.ROOT, check=True)
    loaded = set(ast.literal_eval(res.stdout.strip()))
    assert not loaded & (FORBIDDEN | {"saro_gs_torch"})
