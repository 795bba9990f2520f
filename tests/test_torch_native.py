"""The port's host C++ binary reader (``mmlspark_tpu_torch/native``) and
``read_binary_files``' engines, held against the JAX package's.

Each case of ``tests/test_native.py`` runs the port's reader beside
JAX's on the same tree: the same paths in the same order and the same
bytes, exactly. Both packages build the same C++ source, each into its
own build directory, so sampled reads select the same records under
``engine="auto"`` wherever g++ and zlib exist.
"""

import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from mmlspark_tpu.io.binary import read_binary_files as jax_read
from mmlspark_tpu.native import native_available as jax_native_available
from mmlspark_tpu.native import native_read_records as jax_records
from mmlspark_tpu_torch.io.binary import read_binary_files as port_read
from mmlspark_tpu_torch.native import loader as port_loader
from mmlspark_tpu_torch.native.build_cache import digest_dir
from mmlspark_tpu_torch.native import native_available, native_read_records

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

needs_native = pytest.mark.skipif(
    not (native_available() and jax_native_available()),
    reason="g++/zlib toolchain unavailable")


def same_frames(a, b) -> None:
    assert list(a["path"]) == list(b["path"])
    assert list(a["bytes"]) == list(b["bytes"])


@pytest.fixture
def tree(tmp_path):
    """``tests/test_native.py``'s tree: nested dirs, two zips (deflated
    and stored) and an empty file."""
    (tmp_path / "sub" / "deeper").mkdir(parents=True)
    rng = np.random.default_rng(7)
    files = {
        "a.bin": rng.bytes(1000),
        "b.txt": b"hello world",
        "sub/c.bin": rng.bytes(50_000),
        "sub/deeper/d.bin": rng.bytes(3),
        "empty.bin": b"",
    }
    for rel, data in files.items():
        (tmp_path / rel).write_bytes(data)
    with zipfile.ZipFile(tmp_path / "arch.zip", "w",
                         compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("inner/x.bin", rng.bytes(5000))
        zf.writestr("y.txt", b"zipped text")
    with zipfile.ZipFile(tmp_path / "stored.zip", "w",
                         compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("s.bin", rng.bytes(128))
    return tmp_path


@pytest.fixture
def fifty(tmp_path):
    """50 one-byte files and a zip of 10 members."""
    for i in range(50):
        (tmp_path / f"f{i:02d}.bin").write_bytes(bytes([i]))
    with zipfile.ZipFile(tmp_path / "z.zip", "w",
                         compression=zipfile.ZIP_DEFLATED) as zf:
        for i in range(10):
            zf.writestr(f"m{i}.bin", bytes([100 + i]) * (i + 1))
    return tmp_path


@needs_native
def test_sampled_auto_read_selects_jaxs_records(fifty):
    """The default engine samples the records JAX's default engine
    samples: both take the C++ reader and its per-file RNG."""
    want = jax_read(str(fifty), sample_ratio=0.3, seed=7)
    got = port_read(str(fifty), sample_ratio=0.3, seed=7)
    assert 0 < got.num_rows < 60
    same_frames(got, want)


@needs_native
@pytest.mark.parametrize("engine", ["auto", "native", "python"])
@pytest.mark.parametrize("ratio,seed", [(1.0, 0), (0.3, 7), (0.5, 1),
                                        (0.0, 3)])
def test_every_engine_and_ratio_reads_jaxs_records(fifty, engine, ratio,
                                                   seed):
    want = jax_read(str(fifty), sample_ratio=ratio, seed=seed,
                    engine=engine)
    got = port_read(str(fifty), sample_ratio=ratio, seed=seed, engine=engine)
    same_frames(got, want)


@needs_native
class TestNativeReader:
    """``tests/test_native.py``'s cases, each against JAX's reader."""

    def test_matches_python_engine(self, tree):
        nat = port_read(str(tree), engine="native")
        same_frames(nat, port_read(str(tree), engine="python"))
        same_frames(nat, jax_read(str(tree), engine="native"))
        paths = list(nat["path"])
        assert any(p.endswith("arch.zip/inner/x.bin") for p in paths)
        assert any(p.endswith("stored.zip/s.bin") for p in paths)
        assert any(p.endswith("empty.bin") for p in paths)

    @pytest.mark.parametrize("kw", [{"pattern": "*.bin", "inspect_zip": False},
                                    {"recursive": False, "inspect_zip": False},
                                    {"pattern": "*.zip"}])
    def test_pattern_and_nonrecursive(self, tree, kw):
        nat = port_read(str(tree), engine="native", **kw)
        same_frames(nat, port_read(str(tree), engine="python", **kw))
        same_frames(nat, jax_read(str(tree), engine="native", **kw))

    def test_sampling_deterministic(self, tree):
        a = port_read(str(tree), engine="native", sample_ratio=0.5, seed=1)
        b = port_read(str(tree), engine="native", sample_ratio=0.5, seed=1)
        same_frames(a, b)
        same_frames(a, jax_read(str(tree), engine="native", sample_ratio=0.5,
                                seed=1))
        assert a.num_rows <= port_read(str(tree), engine="native").num_rows

    def test_many_files_prefetch(self, tmp_path):
        """More files than the prefetch window, several workers."""
        for i in range(100):
            (tmp_path / f"f{i:03d}.bin").write_bytes(bytes([i % 256]) * i)
        recs = list(native_read_records(str(tmp_path), n_threads=8,
                                        prefetch_files=4))
        assert len(recs) == 100
        for i, (p, data) in enumerate(recs):
            assert p.endswith(f"f{i:03d}.bin")
            assert data == bytes([i % 256]) * i
        assert recs == list(jax_records(str(tmp_path), n_threads=8,
                                        prefetch_files=4))

    def test_single_file_root(self, tree):
        recs = list(native_read_records(str(tree / "b.txt")))
        assert recs == [(str(tree / "b.txt"), b"hello world")]
        assert recs == list(jax_records(str(tree / "b.txt")))

    def test_empty_deflated_member(self, tmp_path):
        """Empty members compressed with deflate parse as b''."""
        with zipfile.ZipFile(tmp_path / "e.zip", "w",
                             compression=zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("empty.txt", b"")
            zf.writestr("full.txt", b"data")
        nat = port_read(str(tmp_path), engine="native")
        same_frames(nat, port_read(str(tmp_path), engine="python"))
        same_frames(nat, jax_read(str(tmp_path), engine="native"))
        assert list(nat["bytes"]) == [b"", b"data"]

    @pytest.mark.parametrize("engine", ["auto", "native", "python"])
    def test_missing_path_raises_like_jax(self, tmp_path, engine):
        for read in (port_read, jax_read):
            with pytest.raises(FileNotFoundError):
                read(str(tmp_path / "nope"), engine=engine)

    def test_corrupt_zip_raises(self, tmp_path):
        (tmp_path / "bad.zip").write_bytes(b"PK\x03\x04 this is not a zip")
        for records in (native_read_records, jax_records):
            with pytest.raises(IOError, match="bad.zip"):
                list(records(str(tmp_path)))


class TestEngineSelection:
    def test_native_refuses_a_remote_path_like_jax(self):
        import fsspec
        mem = fsspec.filesystem("memory")
        mem.pipe("/io_tail_native/a.bin", b"abc")
        mem.pipe("/io_tail_native/b.bin", b"de")
        try:
            for read in (port_read, jax_read):
                with pytest.raises(ValueError, match="remote"):
                    read("memory://io_tail_native", engine="native")
            # auto reads a remote path in Python, as JAX's does
            same_frames(port_read("memory://io_tail_native", engine="auto"),
                        jax_read("memory://io_tail_native", engine="auto"))
        finally:
            mem.rm("/io_tail_native", recursive=True)

    def test_no_build_raises_for_native_and_reads_python_for_auto(
            self, fifty, monkeypatch):
        """A library that cannot build: ``native`` raises JAX's
        RuntimeError, ``auto`` falls to the Python engine, as JAX's
        ``auto`` does without a compiler."""
        from mmlspark_tpu.native import loader as jax_loader
        for loader in (port_loader, jax_loader):
            monkeypatch.setitem(loader._cache, "mmlbinary",
                                RuntimeError("no g++"))
        for read in (port_read, jax_read):
            with pytest.raises(RuntimeError, match="unavailable"):
                read(str(fifty), engine="native")
        same_frames(port_read(str(fifty), sample_ratio=0.3, seed=7),
                    jax_read(str(fifty), sample_ratio=0.3, seed=7,
                             engine="python"))

    def test_unknown_engine(self, fifty):
        with pytest.raises(ValueError, match="unknown engine"):
            port_read(str(fifty), engine="fast")


class TestLoader:
    def test_unknown_library(self):
        with pytest.raises(FileNotFoundError):
            port_loader._find_or_build("no_such_lib")
        with pytest.raises(Exception):
            port_loader.NativeLoader.load_library_by_name("no_such_lib")

    @needs_native
    def test_cached_handle_identity(self):
        a = port_loader.NativeLoader.load_library_by_name("mmlbinary")
        b = port_loader.NativeLoader.load_library_by_name("mmlbinary")
        assert a is b
        assert a.mml_abi_version() == 1

    @needs_native
    def test_builds_the_ports_copy_into_its_own_tree(self):
        built = Path(port_loader._find_or_build("mmlbinary"))
        assert built.parent.parent == ROOT / "mmlspark_tpu_torch" / \
            "_build" / "host"
        assert built.parent == digest_dir(
            port_loader.BUILD_DIR, (*port_loader.CXX_FLAGS, "-lz"),
            [port_loader.SRC_DIR / "binary_reader.cpp"])
        assert port_loader.SRC_DIR == ROOT / "mmlspark_tpu_torch" / \
            "native" / "src"
        # the port's source is the JAX package's, carried over as it is
        assert (port_loader.SRC_DIR / "binary_reader.cpp").read_bytes() \
            == (ROOT / "mmlspark_tpu" / "native" / "src"
                / "binary_reader.cpp").read_bytes()

    @needs_native
    def test_environment_directory_comes_first(self, tmp_path, monkeypatch):
        lib = tmp_path / "libmmlbinary.so"
        lib.write_bytes(Path(port_loader._find_or_build("mmlbinary"))
                        .read_bytes())
        monkeypatch.setenv("MMLSPARK_TPU_NATIVE_DIR", str(tmp_path))
        assert port_loader._find_or_build("mmlbinary") == str(lib)
        # a directory without the library falls through to the build
        monkeypatch.setenv("MMLSPARK_TPU_NATIVE_DIR", str(tmp_path / "no"))
        assert port_loader._find_or_build("mmlbinary") != str(lib)

    @needs_native
    def test_concurrent_builders_publish_one_library(self, tmp_path):
        """Three processes build into one empty directory at once; each
        gets a whole library that loads, and no temporary file stays."""
        probe = (
            "import ctypes, sys\n"
            "from pathlib import Path\n"
            "from mmlspark_tpu_torch.native import loader\n"
            "loader.BUILD_DIR = Path(sys.argv[1])\n"
            "p = loader._find_or_build('mmlbinary')\n"
            "assert ctypes.CDLL(p).mml_abi_version() == 1\n"
            "print(p)\n")
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        env.pop("MMLSPARK_TPU_NATIVE_DIR", None)
        procs = [subprocess.Popen([sys.executable, "-c", probe,
                                   str(tmp_path)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
                 for _ in range(3)]
        outs = [p.communicate(timeout=240) for p in procs]
        assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
        paths = {o.strip() for o, _ in outs}
        assert len(paths) == 1
        built = Path(paths.pop())
        assert sorted(q.name for q in built.parent.iterdir()) == [
            "libmmlbinary.so"]


def test_publish_is_atomic_and_cleans_up(tmp_path):
    """``build_cache.publish`` (shared by the g++ and the nvcc builds):
    a write that fails leaves neither the target nor a temp file; one
    that succeeds appears under the target's name only."""
    from mmlspark_tpu_torch.native.build_cache import publish
    target = tmp_path / "libx.so"

    def fails(tmp):
        tmp.write_bytes(b"half")
        raise RuntimeError("compiler failed")
    with pytest.raises(RuntimeError, match="compiler failed"):
        publish(target, fails)
    assert list(tmp_path.iterdir()) == []
    assert publish(target, lambda tmp: tmp.write_bytes(b"whole")) == target
    assert [p.name for p in tmp_path.iterdir()] == ["libx.so"]
    assert target.read_bytes() == b"whole"
    d = digest_dir(tmp_path, ("-O2",), [target])
    assert d.parent == tmp_path and len(d.name) == 16
    assert d != digest_dir(tmp_path, ("-O3",), [target])
