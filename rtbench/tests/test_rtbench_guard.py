"""No module that the benchmark runs imports JAX or the JAX package, and
the reference imports nothing of the program.  Each import's top-level
name (the part before the first dot) is compared whole: the program's
name begins with the JAX package's."""

import ast
import os

import pytest

from rtbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "imbatracer_tpu"}
PROGRAM = "imbatracer_torch"


def modules(top):
    root = os.path.join(spec.ROOT, top)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_top_level_names_are_whole():
    assert "imbatracer_torch".split(".")[0] not in FORBIDDEN
    assert "imbatracer_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("top", ["rtbench", PROGRAM])
def test_no_jax_in_what_the_benchmark_runs(top):
    bad = {p: sorted(set(top_level_imports(p)) & FORBIDDEN)
           for p in modules(top)}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join("rtbench", "reference")
    bad = [p for p in modules(ref) if PROGRAM in set(top_level_imports(p))]
    assert not bad
