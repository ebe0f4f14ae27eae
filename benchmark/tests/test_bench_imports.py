"""What a benchmark run imports: no module with the top-level name jax,
jaxlib, flax, optax or ossid_code_tpu, in the benchmark or in the program it
runs (the part before the first dot, compared whole: `ossid_code_torch`
is not `ossid_code_tpu`); and nothing of the program in the reference."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "optax", "ossid_code_tpu"}


def _imports(path: Path) -> set:
    """Top-level names of the absolute imports in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _files(root: Path) -> list:
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("package", ["benchmark", "ossid_code_torch"])
def test_no_jax_in_what_a_run_imports(package):
    bad = {str(p.relative_to(REPO)): sorted(_imports(p) & BANNED) for p in _files(REPO / package)}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    bad = {str(p.relative_to(REPO)): sorted(_imports(p) & (BANNED | {"ossid_code_torch", "benchmark"}))
           for p in _files(REPO / "benchmark" / "reference")}
    assert not {k: v for k, v in bad.items() if v}


def test_whole_names_are_compared():
    assert "ossid_code_torch".split(".")[0] not in BANNED
    assert "jax.numpy".split(".")[0] in BANNED
    assert "jaxtyping".split(".")[0] not in BANNED
