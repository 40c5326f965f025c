"""Nothing under the benchmark imports JAX or the JAX reproduction, and the
reference imports nothing of the port: by whole top-level module name, as
``repro_torch`` begins with ``repro``."""
import ast
import sys
import types

import pytest

from port_bench.harness import env
from port_bench.harness.manifest import BENCH_DIR

FILES = sorted(BENCH_DIR.rglob("*.py"))


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not set(_imported(path)) & set(env.FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_imported(path))


def test_forbidden_modules_compares_whole_names():
    planted = {"repro_torch_x": types.ModuleType("repro_torch_x"),
               "reprox.y": types.ModuleType("reprox.y")}
    sys.modules.update(planted)
    try:
        assert env.forbidden_modules() == [
            m for m in env.forbidden_modules()
            if m not in ("repro_torch_x", "reprox")]
        assert "repro_torch" not in env.forbidden_modules()
        sys.modules["repro.planted"] = types.ModuleType("repro.planted")
        assert "repro" in env.forbidden_modules()
    finally:
        for k in list(planted) + ["repro.planted"]:
            sys.modules.pop(k, None)


def test_subseeds_distinct_and_large_seeds():
    seed = 2 ** 31 + 7
    a, b = env.subseed(seed, "weights"), env.subseed(seed, "traffic")
    assert a != b and 0 <= a < 2 ** 63 and 0 <= b < 2 ** 63
    assert env.subseed(seed, "weights") == a
