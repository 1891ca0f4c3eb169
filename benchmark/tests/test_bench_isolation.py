"""No module of the benchmark imports JAX, Flax or the JAX package, by
top-level name compared whole (the port's name begins with the JAX
package's); the reference and the weights it draws import nothing of the
program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "whisperlive_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(BENCH)): sorted(_imports(p) & FORBIDDEN) for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_port_s_name_is_not_taken_for_the_jax_package():
    # whole top-level names: the port is allowed, the JAX package is not
    assert "whisperlive_tpu_torch" not in FORBIDDEN
    assert "whisperlive_tpu_torch".split(".")[0] != "whisperlive_tpu"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "costmodel.py"):
        assert "whisperlive_tpu_torch" not in _imports(BENCH / name), name
