"""The port imports nothing of JAX and nothing of the JAX package.

A static scan (the AST of every ``.py`` file under
``mmlspark_tpu_torch/`` plus ``chip_smoke.py``): the interpreter may
have imported jax before any test runs, so ``sys.modules`` proves
nothing. A top-level module name must not be ``jax``, ``jaxlib`` or
``flax``, nor exactly ``mmlspark_tpu`` — ``mmlspark_tpu_torch`` shares
that prefix and is of course allowed.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "mmlspark_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "mmlspark_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def _forbidden(source: str, tmp_path) -> list:
    path = tmp_path / "probe.py"
    path.write_text(source)
    return [name for _, name in _imported_roots(path) if name in FORBIDDEN]


def test_the_port_has_files_to_scan():
    assert len(FILES) > 10
    assert (ROOT / "mmlspark_tpu_torch" / "serving" / "decode.py") in FILES
    for module in ("ring_attention", "topology", "collectives", "dist",
                   "sharding"):
        assert (ROOT / "mmlspark_tpu_torch" / "parallel"
                / f"{module}.py") in FILES
    assert (ROOT / "mmlspark_tpu_torch" / "testing" / "mesh_train.py") \
        in FILES


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,expected", [
    ("import jax.numpy as jnp", ["jax"]),
    ("from flax import linen", ["flax"]),
    ("from mmlspark_tpu.core import logs", ["mmlspark_tpu"]),
    ("def f():\n    import mmlspark_tpu\n", ["mmlspark_tpu"]),
    ("from mmlspark_tpu_torch.core import logs", []),
    ("import mmlspark_tpu_torch.serving.decode", []),
    ("from . import sibling", []),
])
def test_the_scan_catches_what_it_must(source, expected, tmp_path):
    assert _forbidden(source, tmp_path) == expected
