"""Nothing under perfbench/ imports JAX or the JAX package the port was made
from, and the references import nothing of the port either: each import's
top-level module name (the part before the first dot) compared whole, so
that ``repro_torch`` is not taken for ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "math", "typing", "torch"}


def test_the_whole_name_is_compared():
    src = "import repro_torch.models\nfrom repro_torch import x\nimport jaxtyping\n"
    p = BENCH_DIR / "__pycache__" / "_import_probe.py"
    p.parent.mkdir(exist_ok=True)
    p.write_text(src)
    try:
        assert top_level_imports(p) == {"repro_torch", "jaxtyping"}
    finally:
        p.unlink()


def test_the_run_refuses_a_loaded_jax_package():
    import perfbench.run as run

    assert run.loaded_forbidden(["repro.models", "torch", "jaxlib.xla"]) == ["jaxlib", "repro"]
    assert run.loaded_forbidden(["repro_torch.models", "jaxtyping", "torch"]) == []
