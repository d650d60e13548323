"""Nothing the benchmark runs imports JAX; the reference imports neither JAX,
the JAX package nor the port (top-level names compared whole)."""

import ast

import pytest

from bench_tiny import BENCH
from harness.device import FORBIDDEN, forbidden_modules

PORT = "spatiotemporal_variable_separation_tpu_torch"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH / "reference")))
def test_reference_imports_neither_jax_nor_the_port(path):
    assert not _imports(path) & (set(FORBIDDEN) | {PORT})


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax(path):
    assert not _imports(path) & set(FORBIDDEN)


def test_modules_are_compared_by_whole_top_level_name():
    loaded = {PORT, f"{PORT}.serve", "jaxtyping", "flax_like", "numpy",
              "spatiotemporal_variable_separation_tpu_extra"}
    assert forbidden_modules(loaded) == []
    jax_package = "spatiotemporal_variable_separation_tpu"
    bad = {"jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", jax_package,
           f"{jax_package}.models"}
    assert forbidden_modules(loaded | bad) == sorted(bad)
