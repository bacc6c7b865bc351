"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "medsegpretrainimagenet_tpu"}
PROGRAM = "medsegpretrainimagenet_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(text: str) -> set:
    """Top-level names of every module *text* imports, by statement or by
    ``import_module``/``__import__`` of a constant."""
    names = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not imported(path.read_text()) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path.read_text())
    assert PROGRAM not in names
    assert "portbench" not in names


@pytest.mark.parametrize("path", sorted((BENCH / "archs").glob("*.py")),
                         ids=lambda p: p.name)
def test_architectures_import_nothing_of_the_program(path):
    # an architecture module is reference: of the benchmark it takes the
    # reference's layers and the yardstick's bounds, never the program
    tree = ast.parse(path.read_text())
    assert PROGRAM not in imported(path.read_text())
    taken = {(n.module, a.name) for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module
             and n.module.split(".")[0] == "portbench" for a in n.names}
    assert {m for m, _ in taken} <= {"portbench", "portbench.reference.ops"}
    assert {a for m, a in taken if m == "portbench"} <= {"bounds"}


def test_names_compared_whole():
    assert imported(f"import {PROGRAM}.ops") == {PROGRAM}
    assert not imported(f"from {PROGRAM}.train import step") & JAX_SIDE
    assert imported("import jax.numpy as jnp") & JAX_SIDE
    assert imported("from medsegpretrainimagenet_tpu.ops import x") \
        & JAX_SIDE


def test_only_the_port_modules_import_the_program():
    users = {p.relative_to(BENCH).as_posix() for p in SOURCES
             if PROGRAM in imported(p.read_text())}
    assert users <= {"port.py", "faults.py"}, users
