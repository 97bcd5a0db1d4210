"""Nothing under portbench/ imports JAX, jaxlib, flax or the JAX package, and
the references import nothing of the program: each module's top-level name
(before the first dot) is compared as a whole name, since the program's
own name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

from portbench.harness import BANNED

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py"))


def top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_names(path)) & set(BANNED)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    names = set(top_names(path))
    assert "diffmining_tpu_torch" not in names and "diffmining_tpu" not in names
    tree = ast.parse(path.read_text())
    inner = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert all(m == "portbench.reference.common" or not m.startswith("portbench") or
               m.startswith("portbench.reference") for m in inner)


def test_the_rule_compares_whole_names():
    assert "diffmining_tpu_torch".split(".")[0] not in BANNED
    assert "diffmining_tpu.ops".split(".")[0] in BANNED
