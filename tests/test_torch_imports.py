"""The port imports nothing of JAX and nothing of the JAX package.

A static scan (the AST of every ``.py`` file under
``mmlspark_tpu_torch/`` plus ``chip_smoke.py``): the interpreter may
have imported jax before any test runs, so ``sys.modules`` proves
nothing. A top-level module name must not be ``jax``, ``jaxlib``, ``flax``,
``optax`` or ``ml_dtypes`` (the card's machine has neither of the last
two), nor exactly ``mmlspark_tpu`` — ``mmlspark_tpu_torch`` shares that
prefix and is of course allowed.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "mmlspark_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "mmlspark_tpu"}


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
    for module in ("server", "frontend", "slo", "incident", "rollout",
                   "capture", "quant"):
        assert (ROOT / "mmlspark_tpu_torch" / "serving"
                / f"{module}.py") in FILES
    assert (ROOT / "mmlspark_tpu_torch" / "io" / "http.py") in FILES


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
    ("import optax", ["optax"]),
    ("def f():\n    import ml_dtypes\n", ["ml_dtypes"]),
    ("from mmlspark_tpu_torch.core import logs", []),
    ("import mmlspark_tpu_torch.serving.decode", []),
    ("from . import sibling", []),
])
def test_the_scan_catches_what_it_must(source, expected, tmp_path):
    assert _forbidden(source, tmp_path) == expected


FRAME_PLANE = ("core/config.py", "core/schema.py", "core/pipeline.py",
               "models/function.py", "models/resnet.py", "models/convert.py",
               "models/zoo.py", "models/nn.py", "gbdt/stages.py",
               "serving/consolidator.py", "serving/__main__.py",
               # frame training and features
               "ops/image.py", "stages/__init__.py", "stages/image.py",
               "models/featurizer.py", "models/trainer.py",
               "featurize/__init__.py", "featurize/assemble.py",
               "featurize/text.py", "automl/__init__.py", "automl/train.py")


#: the train-state store, resumable training and the retrain loop
RETRAIN_PLANE = ("io/__init__.py", "io/checkpoint.py", "io/binary.py",
                 "io/streaming.py", "streaming/__init__.py",
                 "streaming/engine.py", "streaming/traffic.py",
                 "streaming/loop.py", "testing/faults.py")


#: distributed GBDT and the load drivers
DISTRIBUTED_GBDT_AND_LOAD = ("gbdt/learners.py", "gbdt/tree.py",
                             "gbdt/booster.py", "testing/__init__.py",
                             "testing/load.py", "testing/decode_load.py",
                             "testing/datagen.py", "testing/benchmarks.py")


#: the long tail's first part: pipeline stages, AutoML evaluation and
#: tuning, SAR and LIME, the column helpers and the plots (matplotlib is
#: imported only when a plot is drawn)
LONG_TAIL = ("stages/basic.py", "stages/prep.py", "stages/batching.py",
             "automl/metrics.py", "automl/best.py", "automl/tune.py",
             "recommend/__init__.py", "recommend/indexer.py",
             "recommend/sar.py", "recommend/ranking.py",
             "explain/__init__.py", "explain/superpixel.py",
             "explain/lime.py", "udfs.py", "plot.py")


#: the I/O tail: HTTP on columns, the services, image reading, the host
#: C++ reader's loader and binding, and ``all.py`` (``requests`` and PIL
#: are imported only when a client or a codec is used)
IO_TAIL = ("io/http.py", "io/services.py", "io/images.py", "io/binary.py",
           "native/__init__.py", "native/loader.py", "native/binary.py",
           "native/build_cache.py", "all.py")


def test_the_frame_plane_modules_are_scanned():
    for rel in (FRAME_PLANE + RETRAIN_PLANE + DISTRIBUTED_GBDT_AND_LOAD
                + LONG_TAIL + IO_TAIL):
        assert ROOT / "mmlspark_tpu_torch" / rel in FILES, rel


def test_the_frame_plane_imports_with_jax_blocked():
    """Import every frame-plane module (and the package inits that
    export them) in a fresh interpreter whose import system refuses
    ``jax``, ``jaxlib``, ``flax``, ``optax``, ``ml_dtypes`` and
    ``mmlspark_tpu``; the retrain plane's modules, distributed GBDT's,
    the load drivers', the long tail's and the I/O tail's too."""
    import subprocess
    import sys
    modules = ["mmlspark_tpu_torch." + rel[:-3].replace("/", ".")
               .removesuffix(".__init__")
               for rel in FRAME_PLANE + RETRAIN_PLANE
               + DISTRIBUTED_GBDT_AND_LOAD + LONG_TAIL + IO_TAIL
               if not rel.endswith("__main__.py")]
    modules += ["mmlspark_tpu_torch", "mmlspark_tpu_torch.core",
                "mmlspark_tpu_torch.models",
                "mmlspark_tpu_torch.gbdt", "mmlspark_tpu_torch.serving"]
    probe = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {sorted(FORBIDDEN)!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
