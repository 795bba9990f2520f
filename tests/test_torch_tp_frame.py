"""The model axis on the frame plane against the JAX package, on the CPU:
``NNModel(tensor_parallel=...)``, ``NNLearner`` on a mesh, and the rest
of ``parallel/dist.py`` (``state_shardings``, ``shard_state``,
``put_batch`` and its pad cache).

* ``tests/test_dist.py::TestTensorParallelServing``'s contract with the
  hosted values (ROADMAP queue 3): the mesh ``{"data": 1, "model": 2}``
  and its label ``"data=1,model=2"`` (JAX ``{"data": 4, "model": 2}``),
  and ``tensor_parallel=3`` serving with every leaf 3 does not divide
  replicated (JAX refuses 3 on 8 devices). Scores within 1e-5 of the
  replicated model and of JAX's TP model.
* ``TestShardingRules`` and ``TestPutBatchPadCache`` on the port's
  ``dist``; ``shard_state``'s slices have JAX's shard shapes.
* ``NNLearner`` on a hosted ``{"data": 2, "model": 2}`` against JAX's fit
  on that mesh and the port's ``{"data": 1}`` fit (1e-4, JAX's), both
  from bridged weights, accuracy above 0.95.
* Two gloo processes fit ``{"data": 2}`` one rank per process
  (``mmlspark_tpu_torch.testing.learner_fit``) on 45 rows with a batch
  of 64: every step is a ragged batch, padded to 46, whose two halves
  hold 23 and 22 real rows. Each process equals the hosted ``{"data":
  2}`` fit within 1e-6 and JAX's within 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import requests
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.models.nn import NNModel as JNN
from mmlspark_tpu.models.trainer import NNLearner as JNNLearner
from mmlspark_tpu.parallel import dist as JD
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.resilience import ManualClock
from mmlspark_tpu_torch.core.tracing import Tracer
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.function import flatten_params
from mmlspark_tpu_torch.models.nn import NNModel
from mmlspark_tpu_torch.models.trainer import NNLearner
from mmlspark_tpu_torch.parallel import dist
from mmlspark_tpu_torch.parallel.topology import single_device_scope
from mmlspark_tpu_torch.serving.server import ServingServer
from mmlspark_tpu_torch.testing import learner_fit

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
FIT_TOL = 1e-4
GLOO_TOL = 1e-6


def _mlp(seed=0):
    jf = JF.init({"builder": "mlp", "hidden": [32], "num_outputs": 4},
                 input_shape=(8,), seed=seed)
    return jf, PF(arch=dict(jf.arch),
                  params=jax.tree.map(np.asarray, jf.params))


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return JD.train_mesh(shape, devices=jax.devices()[:n])


# -- NNModel(tensor_parallel=...) ----------------------------------------------

class TestTensorParallelServing:

    @staticmethod
    def _model(pf, tp, **kw):
        return NNModel(model=pf, input_col="features", batch_size=32,
                       tensor_parallel=tp, device="cpu", **kw)

    def test_tp_scores_match_replicated_and_jax(self, rng):
        jf, pf = _mlp()
        x = rng.normal(size=(16, 8)).astype(np.float32)
        s0 = self._model(pf, 0).transform(DataFrame({"features": x}))
        s2 = self._model(pf, 2).transform(DataFrame({"features": x}))
        j2 = JNN(model=jf, input_col="features", batch_size=32,
                 tensor_parallel=2).transform(JDF({"features": x}))
        np.testing.assert_allclose(s2["scores"], s0["scores"], atol=ATOL)
        np.testing.assert_allclose(s2["scores"], j2["scores"], atol=ATOL)

    def test_tp_width_that_divides_no_leaf_replicates_it(self, rng):
        """JAX refuses 3 ("does not divide the 8-device host"); a hosted
        mesh has 3 model ranks, and the rule replicates every leaf 3
        does not divide (here all: 8, 32 and 4 wide)."""
        jf, pf = _mlp()
        with pytest.raises(ValueError, match="divide"):
            JNN(model=jf, input_col="features", batch_size=32,
                tensor_parallel=3).transform(
                    JDF({"features": np.zeros((4, 8), np.float32)}))
        x = rng.normal(size=(5, 8)).astype(np.float32)
        m = self._model(pf, 3)
        got = m.transform(DataFrame({"features": x}))["scores"]
        ref = self._model(pf, 0).transform(DataFrame({"features": x}))
        np.testing.assert_allclose(got, ref["scores"], atol=ATOL)
        pl = m.placement()
        assert pl["mesh"] == {"data": 1, "model": 3}
        assert pl["sharded_leaves"] == 0 and pl["replicated_leaves"] == 4

    def test_placement_mode_reflects_reality_not_config(self, rng):
        _, pf = _mlp()
        m = self._model(pf, 2)
        assert m.placement()["mode"] == "unplaced"
        m.data_parallel = False
        m.transform(DataFrame(
            {"features": rng.normal(size=(4, 8)).astype(np.float32)}))
        assert m.placement()["mode"] == "single_device"
        with single_device_scope():
            m3 = self._model(pf, 2)
            m3.transform(DataFrame({"features": np.ones((2, 8),
                                                        np.float32)}))
            assert m3.placement()["mode"] == "single_device"
        m2 = self._model(pf, 2)
        m2.transform(DataFrame(
            {"features": rng.normal(size=(4, 8)).astype(np.float32)}))
        assert m2.placement()["mode"] == "tensor_parallel"
        assert m2.placement_label == "data=1,model=2"

    def test_placement_report_is_jaxs_rule_on_a_hosted_mesh(self):
        """The counts and bytes JAX reports on ``{"data": 4, "model":
        2}``; the mesh and devices are the hosted mesh's."""
        jf, pf = _mlp()
        m = self._model(pf, 2)
        m.transform(DataFrame({"features": np.ones((2, 8), np.float32)}))
        pl = m.placement()
        jrep = JD.placement_report(jf.params, _jmesh({"data": 4,
                                                      "model": 2}))
        for k in ("sharded_leaves", "replicated_leaves", "state_bytes",
                  "state_bytes_per_device"):
            assert pl[k] == jrep[k], k
        assert pl["mesh"] == {"data": 1, "model": 2}
        assert pl["n_devices"] == 2 and len(pl["devices"]) == 2

    def test_server_stats_placement_and_zero_recompiles(self):
        _, pf = _mlp()
        srv = ServingServer(self._model(pf, 2), max_batch_size=8,
                            max_latency_ms=2.0)
        srv.warmup({"features": [0.0] * 8})
        srv.start()
        try:
            rec0 = srv.n_recompiles
            base = f"http://{srv.host}:{srv.port}"
            for i in range(12):
                r = requests.post(base + "/predict",
                                  json={"features": [float(i)] * 8},
                                  timeout=10)
                assert r.status_code == 200
            stats = requests.get(base + "/stats", timeout=10).json()
            assert stats["placement"]["mode"] == "tensor_parallel"
            assert stats["placement"]["mesh"] == {"data": 1, "model": 2}
            assert stats["placement"]["sharded_leaves"] >= 1
            assert srv.n_recompiles == rec0
        finally:
            srv.stop()

    def test_dispatch_span_carries_placement(self):
        _, pf = _mlp()
        tracer = Tracer(clock=ManualClock())
        srv = ServingServer(self._model(pf, 2), max_batch_size=4,
                            max_latency_ms=1.0, tracer=tracer,
                            slow_trace_ms=0.0, pipeline=False)
        srv.start()
        try:
            base = f"http://{srv.host}:{srv.port}"
            r = requests.post(base + "/predict",
                              json={"features": [0.5] * 8},
                              headers={"X-Trace-Id": "tp-span-1"},
                              timeout=10)
            assert r.status_code == 200
            tr = tracer.get_trace("tp-span-1")
            dispatch = [s for s in tr["spans"] if s["name"] == "dispatch"]
            assert dispatch, [s["name"] for s in tr["spans"]]
            assert dispatch[0]["attrs"]["placement"] == "data=1,model=2"
        finally:
            srv.stop()

    def test_several_processes_are_refused(self, monkeypatch):
        """In a world of P processes tensor parallelism spreads over the
        world, as JAX's spans its global devices: ``{"data": P / t,
        "model": t}``, or ``{"data": 1, "model": t}`` where t >= P, and a
        width that neither divides nor is divided by the world raises.
        Its runs over processes: ``tests/test_torch_process_axes.py``."""
        from mmlspark_tpu_torch.models import nn as PNN_MOD
        from mmlspark_tpu_torch.parallel.topology import Mesh
        _, pf = _mlp()
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        asked = []

        def train_mesh(shape, dev):
            # the world's mesh, stood in for by a hosted one
            asked.append(shape)
            return Mesh(shape, torch.device("cpu"), hosted=True)
        monkeypatch.setattr(PNN_MOD._dist, "train_mesh", train_mesh)
        x = DataFrame({"features": np.zeros((2, 8), np.float32)})
        for world, tp in ((2, 2), (4, 2), (2, 4)):
            monkeypatch.setattr(torch.distributed, "get_world_size",
                                lambda *a, w=world: w)
            self._model(pf, tp).transform(x)
        assert asked == [{"data": 1, "model": 2}, {"data": 2, "model": 2},
                         {"data": 1, "model": 4}]
        monkeypatch.setattr(torch.distributed, "get_world_size",
                            lambda *a: 3)
        with pytest.raises(ValueError, match="does not divide the 3-process"):
            self._model(pf, 2).transform(x)


# -- parallel/dist.py ------------------------------------------------------------

class TestShardingRules:

    def test_state_shardings_mirror_jaxs_specs(self):
        import optax
        params = {"w": np.zeros((32, 16), np.float32),
                  "b": np.zeros((16,), np.float32),
                  "k": np.zeros((3, 3, 4, 8), np.float32)}
        mesh = dist.train_mesh({"data": 2, "model": 4}, "cpu")
        jmesh = _jmesh({"data": 2, "model": 4})
        got = dist.state_shardings(params, mesh)
        want = JD.state_shardings(params, jmesh)
        for k in params:
            assert got[k] == tuple(want[k].spec) + (None,) * (
                len(got[k]) - len(want[k].spec)), k
        # the adam moments have the params' shapes: the same layout
        opt = optax.adam(1e-3).init(jax.tree.map(np.asarray, params))
        mu = dist.state_shardings({k: np.asarray(v) for k, v in
                                   opt[0].mu.items()}, mesh)
        assert mu == got

    def test_placement_report_and_label(self):
        mesh = dist.train_mesh({"data": 4, "model": 2}, "cpu")
        tree = {"w": np.zeros((64, 32), np.float32),
                "b": np.zeros((32,), np.float32)}
        for t in (tree, dist.shard_state(tree, mesh)):
            rep = dist.placement_report(t, mesh)
            assert rep["mesh"] == {"data": 4, "model": 2}
            assert rep["n_devices"] == 8
            assert rep["sharded_leaves"] == 1
            assert rep["replicated_leaves"] == 1
            w, b = 64 * 32 * 4, 32 * 4
            assert rep["state_bytes"] == w + b
            assert rep["state_bytes_per_device"] == w // 2 + b
        assert dist.placement_label(mesh) == "data=4,model=2"

    def test_shard_state_holds_jaxs_shards(self):
        """Each sharded leaf is its model ranks' slices, of the shapes of
        JAX's addressable shards; gathered, the leaf itself."""
        rng = np.random.default_rng(0)
        tree = {"w": rng.standard_normal((12, 8)).astype(np.float32),
                "k": rng.standard_normal((3, 3, 4, 6)).astype(np.float32),
                "b": rng.standard_normal((8,)).astype(np.float32)}
        mesh = dist.train_mesh({"data": 1, "model": 2}, "cpu")
        placed = dist.shard_state(tree, mesh)
        jplaced = JD.shard_state(tree, _jmesh({"data": 1, "model": 2}))
        for k, v in tree.items():
            shard_shapes = {s.data.shape for s in
                            jplaced[k].addressable_shards}
            leaf = placed[k]
            if isinstance(leaf, dist.Shards):
                assert {tuple(p.shape) for p in leaf.parts} == shard_shapes
                assert len(leaf.parts) == 2
                assert all(p.is_contiguous() for p in leaf.parts)
            else:
                assert shard_shapes == {v.shape}
            np.testing.assert_array_equal(dist.gathered(leaf).numpy(), v)
        assert isinstance(placed["w"], dist.Shards)
        assert not isinstance(placed["b"], dist.Shards)
        # the host array is copied, never aliased
        tree["b"][0] = 99.0
        assert float(placed["b"][0]) != 99.0

    def test_put_batch_pads_and_shards(self):
        mesh = dist.train_mesh({"data": 4, "model": 2}, "cpu")
        out, n = dist.put_batch({"x": np.ones((6, 3), np.float32)}, mesh)
        jout, jn = JD.put_batch({"x": np.ones((6, 3), np.float32)},
                                _jmesh({"data": 4, "model": 2}))
        assert n == jn == 6
        assert tuple(out["x"].shape) == jout["x"].shape == (8, 3)
        np.testing.assert_array_equal(out["x"].numpy(), np.asarray(jout["x"]))
        assert dist.batch_shardings(mesh) == ("data",)
        assert tuple(JD.batch_shardings(_jmesh({"data": 4, "model": 2}))
                     .spec) == ("data",)


class TestPutBatchPadCache:
    """``tests/test_dist.py::TestPutBatchPadCache`` on the port."""

    @staticmethod
    def _buffers(cache):
        return [v for v in cache.values() if isinstance(v, np.ndarray)]

    def test_tail_reuses_one_buffer(self):
        mesh = dist.train_mesh({"data": 4}, "cpu")
        cache: dict = {}
        a1 = np.ones((6, 3), np.float32)
        out1, n1 = dist.put_batch({"x": a1}, mesh, pad_cache=cache)
        assert n1 == 6 and tuple(out1["x"].shape) == (8, 3)
        assert len(self._buffers(cache)) == 1
        buf1 = self._buffers(cache)[0]
        a2 = np.full((6, 3), 2.0, np.float32)
        out2, _ = dist.put_batch({"x": a2}, mesh, pad_cache=cache)
        assert self._buffers(cache)[0] is buf1
        host = out2["x"].numpy()
        np.testing.assert_array_equal(host[:6], a2)
        np.testing.assert_array_equal(host[6:], 0.0)
        # the first call's tensor is a copy: the reuse did not touch it
        np.testing.assert_array_equal(out1["x"].numpy()[:6], a1)

    def test_smaller_tail_recleans_dirty_pad_rows(self):
        mesh = dist.train_mesh({"data": 4}, "cpu")
        cache: dict = {}
        dist.put_batch({"w": np.full((7,), 9.0, np.float32)}, mesh,
                       pad_cache=cache)
        out, n = dist.put_batch({"w": np.full((5,), 2.0, np.float32)},
                                mesh, pad_cache=cache)
        host = out["w"].numpy()
        assert n == 5
        np.testing.assert_array_equal(host[:5], 2.0)
        np.testing.assert_array_equal(host[5:], 0.0)

    def test_divisible_batches_bypass_the_cache(self):
        mesh = dist.train_mesh({"data": 4}, "cpu")
        cache: dict = {}
        out, n = dist.put_batch({"x": np.ones((8, 3), np.float32)},
                                mesh, pad_cache=cache)
        assert n == 8 and not cache

    def test_distinct_shapes_get_distinct_buffers(self):
        mesh = dist.train_mesh({"data": 4}, "cpu")
        cache: dict = {}
        dist.put_batch({"x": np.ones((6, 3), np.float32)}, mesh,
                       pad_cache=cache)
        dist.put_batch({"x": np.ones((2, 3), np.float32),
                        "y": np.ones((2,), np.float32)}, mesh,
                       pad_cache=cache)
        assert len(self._buffers(cache)) == 3


# -- NNLearner on a mesh ---------------------------------------------------------

COMMON = dict(optimizer="adam", learning_rate=0.01, batch_size=64,
              log_every=0, seed=3)
ARCH = {"builder": "mlp", "hidden": [16], "num_outputs": 2}


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(42)
    n = 192
    x = np.concatenate([rng.normal(-2.0, size=(n, 4)),
                        rng.normal(2.0, size=(n, 4))]).astype(np.float32)
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.int64)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def _start(seed=5):
    jf = JF.init(ARCH, (4,), seed=seed)
    return jax.tree.map(np.asarray, jf.params)


def _jax_fit(x, y, mesh_shape, params, epochs):
    # JAX's fit donates what it is given: hand it a copy
    fn = JF(arch=dict(ARCH), params=jax.tree.map(np.array, params))
    return JNNLearner(model=fn, epochs=epochs, mesh_shape=mesh_shape,
                      arch=ARCH, **COMMON).fit(JDF({"features": x,
                                                   "label": y}))


def _port_fit(x, y, mesh_shape, params, epochs):
    fn = PF(arch=dict(ARCH), params=jax.tree.map(np.array, params))
    return NNLearner(model=fn, epochs=epochs, mesh_shape=mesh_shape,
                     arch=ARCH, device="cpu", **COMMON).fit(
                         DataFrame({"features": x, "label": y}))


def _params_diff(a, b) -> float:
    fa, fb = flatten_params(a), flatten_params(b)
    assert fa.keys() == fb.keys()
    return max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)


def test_model_axis_fit_matches_jax_and_the_data_only_fit(blobs):
    """``TestPjitTrainer::test_tensor_parallel_fit_matches_single_device``:
    the hosted model axis lays the state out over ``model`` and fits as
    the data-only fit does."""
    x, y = blobs
    start = _start()
    m1 = _port_fit(x, y, {"data": 1}, start, 4)
    m2 = _port_fit(x, y, {"data": 2, "model": 2}, start, 4)
    j2 = _jax_fit(x, y, {"data": 2, "model": 2}, start, 4)
    df = DataFrame({"features": x})
    s1 = m1.transform(df)["scores"]
    s2 = m2.transform(df)["scores"]
    js = j2.transform(JDF({"features": x}))["scores"]
    np.testing.assert_allclose(s2, s1, atol=FIT_TOL)
    np.testing.assert_allclose(s2, js, atol=FIT_TOL)
    assert _params_diff(m2.model.params, j2.model.params) < FIT_TOL
    assert float((s2.argmax(axis=1) == y).mean()) > 0.95


def test_model_axis_state_is_laid_out_over_model(blobs, monkeypatch):
    """The step's tensors are the rule's slices: the model-sharded
    leaves' halves and the replicated leaves, and the optimizer's
    moments are shaped (so laid out) as they are."""
    from mmlspark_tpu_torch.models import trainer as PT
    seen = {}
    build = PT.NNLearner.build_train_step

    def spy(self, module, tx, loss_fn, mesh=None):
        step = build(self, module, tx, loss_fn, mesh)
        seen["module"], seen["state"] = module, step.state
        return step

    monkeypatch.setattr(PT.NNLearner, "build_train_step", spy)
    x, y = blobs
    _port_fit(x[:64], y[:64], {"data": 2, "model": 2}, _start(), 1)
    placed = seen["module"]
    rep = dist.placement_report(placed.state, placed.mesh)
    jrep = JD.placement_report(_start(), _jmesh({"data": 2, "model": 2}))
    for k in ("sharded_leaves", "replicated_leaves", "state_bytes",
              "state_bytes_per_device"):
        assert rep[k] == jrep[k], k
    assert rep["sharded_leaves"] >= 1
    shapes = [tuple(t.shape) for t in placed.tensors()]
    assert [tuple(t.shape) for t in seen["state"]["mu"]] == shapes
    assert sum(t.numel() * 4 for t in placed.tensors()) \
        == rep["state_bytes"]


def test_single_device_scope_places_no_mesh(blobs):
    x, y = blobs
    start = _start()
    with single_device_scope():
        m = _port_fit(x[:64], y[:64], {"data": 2, "model": 2}, start, 1)
    ref = _port_fit(x[:64], y[:64], {"data": 1}, start, 1)
    assert _params_diff(m.model.params, ref.model.params) == 0.0


def test_gloo_data_axis_fit_equals_the_hosted_fit_and_jax(tmp_path):
    """Two processes, ``{"data": 2}``, one rank each: 45 rows and a batch
    of 64 make every step a ragged batch (46 rows after the pad, 23 and
    22 real rows a process), three epochs."""
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.normal(-2.0, size=(23, 4)),
                        rng.normal(2.0, size=(22, 4))]).astype(np.float32)
    y = np.r_[np.zeros(23), np.ones(22)].astype(np.int64)
    start = _start(seed=6)
    data = str(tmp_path / "fit.npz")
    learner_fit.save_inputs(data, x, y, PF(arch=dict(ARCH), params=start))
    cfg = dict(COMMON, epochs=3)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.learner_fit",
         "--init", f"file://{tmp_path / 'rendezvous'}", "--world", "2",
         "--rank", str(r), "--data", data, "--cfg", json.dumps(cfg),
         "--device", "cpu", "--out", str(tmp_path / f"rank{r}.npz")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the gloo ranks did not finish within 120 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    want = learner_fit.run(data, {"data": 2}, cfg, device="cpu")
    jfit = _jax_fit(x, y, {"data": 2}, start, 3)
    jflat = flatten_params(jfit.model.params)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, atol=GLOO_TOL,
                                       rtol=0, err_msg=f"rank {r} {key}")
        for key, value in jflat.items():
            np.testing.assert_allclose(got[key], value, atol=FIT_TOL,
                                       rtol=0, err_msg=f"rank {r} {key}")
