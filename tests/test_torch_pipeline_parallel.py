"""The port's pipeline parallelism (``mmlspark_tpu_torch/parallel/
pipeline.py`` and ``NNModel(pipeline_parallel=...)``) against the JAX
package's, on the CPU: ``tests/test_pipeline_parallel.py``'s contracts.

* ``plan_stages``, ``split_rows`` and ``bubble_ratio`` equal JAX's on the
  same costs and rows, refusals included (the port's stages take the
  hosted ranks' labels where JAX's take devices).
* The pipelined ``NNModel``, alone and with tensor parallelism, scores
  within 1e-5 (JAX's tolerance) of JAX's pipelined ``NNModel`` on bridged
  weights and of the port's single-device forward; a ResNet's conv
  kernels split as JAX splits them (their specs reckoned on flax's
  shapes).
* The report and placement surfaces carry JAX's keys; the values the
  hosted mesh changes on purpose (ROADMAP queue 3) are pinned here:
  ``batch_multiple`` 1 (JAX 4 and 2 on its 8 devices), the label
  ``"pipe=2,data=1,model=2"`` (JAX ``"pipe=2,data=2,model=2"``), a stage
  count of 3 engaged (JAX turns it off: 3 does not divide 8 devices),
  and each stage's devices are disjoint labels of hosted ranks.
* A live ``ServingServer`` over a pipelined model: its ``/stats``
  ``pipeline_parallel`` block, no recompile after warmup, and
  ``pipeline_stage`` spans for stages 0 and 1.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.models.nn import NNModel as JNN
from mmlspark_tpu.parallel import pipeline as JP
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.tracing import Tracer
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.nn import NNModel
from mmlspark_tpu_torch.parallel import pipeline as PP
from mmlspark_tpu_torch.parallel.topology import single_device_scope
from mmlspark_tpu_torch.serving.server import ServingServer

torch.set_num_threads(1)

ATOL = 1e-5


def _mlp(hidden, n_in=16, n_out=4, seed=0):
    """JAX's ``_mlp`` and the port's function on its weights."""
    jf = JF.init({"builder": "mlp", "hidden": list(hidden),
                  "num_outputs": n_out}, input_shape=(n_in,), seed=seed)
    return jf, PF(arch=dict(jf.arch),
                  params=jax.tree.map(np.asarray, jf.params))


def _frames(x):
    return JDF({"features": x}), DataFrame({"features": x})


class TestStagePlacement:

    @pytest.mark.parametrize("costs,k,n_dev", [
        ([1.0, 100.0, 1.0, 1.0], 2, 2),
        ([1.0] * 8, 4, 8),
        ([5.0, 1.0, 1.0, 1.0, 1.0, 5.0, 2.0], 3, 3),
        ([3.0, 3.0, 1.0, 9.0, 1.0, 1.0], 2, 4),
    ])
    def test_plan_stages_equals_jax(self, costs, k, n_dev):
        want = JP.plan_stages(costs, k, devices=jax.devices()[:n_dev])
        got = PP.plan_stages(costs, k, [f"r{i}" for i in range(n_dev)])
        assert got.boundaries == want.boundaries
        assert got.costs == want.costs
        assert [len(d) for d in got.devices] == [len(d) for d in
                                                 want.devices]
        flat = [d for sl in got.devices for d in sl]
        assert flat == [f"r{i}" for i in range(n_dev)]

    def test_refusals_equal_jax(self):
        for args, match in ((([1.0, 2.0], 1), "n_stages"),
                            (([1.0], 2), "layers")):
            with pytest.raises(ValueError, match=match):
                JP.plan_stages(*args, devices=jax.devices()[:2])
            with pytest.raises(ValueError, match=match):
                PP.plan_stages(*args, ["r0", "r1"])
        with pytest.raises(ValueError, match="equal slices"):
            JP.plan_stages([1.0, 1.0], 2, devices=jax.devices()[:3])
        with pytest.raises(ValueError, match="equal slices"):
            PP.plan_stages([1.0, 1.0], 2, ["r0", "r1", "r2"])
        with pytest.raises(ValueError, match="devices"):
            PP.plan_stages([1.0, 1.0], 2)

    @pytest.mark.parametrize("n,m,mult", [(16, 4, 2), (4, 8, 2), (0, 4, 2),
                                          (37, 4, 1), (24, 3, 4),
                                          (1, 2, 1)])
    def test_split_rows_equals_jax(self, n, m, mult):
        assert PP.split_rows(n, m, mult) == JP.split_rows(n, m, mult)

    def test_split_rows_refuses_unpadded_frames(self):
        with pytest.raises(ValueError, match="padded"):
            JP.split_rows(15, 4, 2)
        with pytest.raises(ValueError, match="padded"):
            PP.split_rows(15, 4, 2)

    @pytest.mark.parametrize("ts,m", [([2.0, 2.0], 4), ([1.0, 1.0, 1.0], 6),
                                      ([3.0], 4), ([1.0, 3.0], 4),
                                      ([0.5, 0.0, 2.0], 1)])
    def test_bubble_ratio_equals_jax(self, ts, m):
        assert PP.bubble_ratio(ts, m) == JP.bubble_ratio(ts, m)

    def test_bubble_ratio_is_gpipes_when_balanced(self):
        assert abs(PP.bubble_ratio([2.0, 2.0], 4) - 1.0 / 5.0) < 1e-9
        assert abs(PP.bubble_ratio([1.0, 1.0, 1.0], 6) - 2.0 / 8.0) < 1e-9


class TestPipelinedNNModel:

    def test_scores_match_jax_and_fused_forward(self):
        jf, pf = _mlp([32, 32, 16])
        x = np.random.default_rng(0).normal(size=(37, 16)).astype(
            np.float32)
        jdf, df = _frames(x)
        want = JNN(model=jf, input_col="features",
                   pipeline_parallel=2).transform(jdf)["scores"]
        fused = NNModel(model=pf, input_col="features",
                        device="cpu").transform(df)["scores"]
        got = NNModel(model=pf, input_col="features", device="cpu",
                      pipeline_parallel=2).transform(df)["scores"]
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, fused, atol=ATOL)

    def test_composes_with_tensor_parallel(self):
        jf, pf = _mlp([64, 64], n_in=32, seed=1)
        x = np.random.default_rng(1).normal(size=(24, 32)).astype(np.float32)
        jdf, df = _frames(x)
        jm = JNN(model=jf, input_col="features", pipeline_parallel=2,
                 tensor_parallel=2)
        want = jm.transform(jdf)["scores"]
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2, tensor_parallel=2)
        got = m.transform(df)["scores"]
        fused = NNModel(model=pf, input_col="features",
                        device="cpu").transform(df)["scores"]
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, fused, atol=ATOL)
        assert jm.placement_label == "pipe=2,data=2,model=2"
        assert m.placement_label == "pipe=2,data=1,model=2"

    def test_resnet_stages_split_conv_kernels_as_jax(self):
        """A ResNet cut into two stages, each over a model axis of 2:
        scores as JAX's, and each stage's placement (sharded and
        replicated leaves, bytes a rank) is JAX's rule on flax's conv
        shapes."""
        from mmlspark_tpu.parallel import dist as JD
        from mmlspark_tpu_torch.parallel import dist as PD
        arch = {"builder": "cifar_resnet", "depth": 8, "width": 4,
                "num_classes": 3}
        jf = JF.init(arch, (8, 8, 3), seed=4)
        pf = PF(arch=dict(arch), params=jax.tree.map(np.asarray, jf.params))
        x = np.random.default_rng(2).uniform(0, 1, (10, 8, 8, 3)).astype(
            np.float32)
        jdf, df = _frames(x)
        jm = JNN(model=jf, input_col="features", pipeline_parallel=2,
                 tensor_parallel=2)
        want = jm.transform(jdf)["scores"]
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2, tensor_parallel=2)
        got = m.transform(df)["scores"]
        np.testing.assert_allclose(got, want, atol=ATOL)
        jrunner, _ = jm._setup_pipeline
        runner, _ = m._setup_pipeline
        assert [p["layers"] for p in m.pipeline_report()["stages"]] == \
            [p["layers"] for p in jm.pipeline_report()["stages"]]
        keys = ("sharded_leaves", "replicated_leaves", "state_bytes",
                "state_bytes_per_device")
        for (_, jparams, _, _), (_, placed, _, _) in zip(jrunner.stages,
                                                         runner.stages):
            jrep = JD.placement_report(jparams, jparams_mesh(jparams))
            rep = PD.placement_report(placed.state, placed.mesh)
            assert {k: rep[k] for k in keys} == {k: jrep[k] for k in keys}

    def test_uint8_wire_dequantizes_in_the_first_stage(self):
        jf, pf = _mlp([32, 16])
        x = np.random.default_rng(3).integers(0, 256, (9, 16)).astype(
            np.uint8)
        jdf, df = _frames(x)
        want = JNN(model=jf, input_col="features", input_dtype="uint8",
                   pipeline_parallel=2).transform(jdf)["scores"]
        got = NNModel(model=pf, input_col="features", device="cpu",
                      input_dtype="uint8",
                      pipeline_parallel=2).transform(df)["scores"]
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_placement_and_report_surfaces(self):
        jf, pf = _mlp([32, 32, 16])
        x = np.random.default_rng(2).normal(size=(16, 16)).astype(
            np.float32)
        jdf, df = _frames(x)
        jm = JNN(model=jf, input_col="features", pipeline_parallel=2)
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2)
        assert m.pipeline_report() is None     # nothing dispatched yet
        jm.transform(jdf)
        m.transform(df)
        rep, jrep = m.pipeline_report(), jm.pipeline_report()
        assert rep.keys() == jrep.keys()
        for entry, jentry in zip(rep["stages"], jrep["stages"]):
            assert entry.keys() == jentry.keys()
            assert entry["layers"] == jentry["layers"]
            assert entry["param_bytes"] == jentry["param_bytes"]
        assert rep["n_stages"] == 2 and rep["stage_probe_valid"]
        assert 0.0 <= rep["bubble_ratio"] <= 1.0
        assert all(s["service_ms"] > 0 for s in rep["stages"])
        assert rep["last_n_micro"] == jrep["last_n_micro"]
        d0 = set(rep["stages"][0]["devices"])
        d1 = set(rep["stages"][1]["devices"])
        assert d0 and d1 and not (d0 & d1)
        pl, jpl = m.placement(), jm.placement()
        assert pl.keys() == jpl.keys()
        assert pl["mode"] == "pipeline_parallel" and pl["n_stages"] == 2
        assert pl["n_devices"] == 2

    def test_config_alone_never_claims_pipeline(self):
        jf, pf = _mlp([32, 16])
        x = np.random.default_rng(3).normal(size=(8, 16)).astype(np.float32)
        _, df = _frames(x)
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2)
        with single_device_scope():
            ref = NNModel(model=pf, input_col="features",
                          device="cpu").transform(df)
            out = m.transform(df)              # pinned scope: no stages
        np.testing.assert_allclose(out["scores"], ref["scores"], atol=1e-6)
        assert m.pipeline_report() is None
        assert m.placement()["mode"] == "single_device"
        # data_parallel off: no stages either
        off = NNModel(model=pf, input_col="features", device="cpu",
                      pipeline_parallel=2, data_parallel=False)
        off.transform(df)
        assert off.pipeline_report() is None
        # a hosted mesh has a slice for every stage: 3 engages (JAX's 8
        # devices do not split into 3 slices, so JAX turns it off)
        m3 = NNModel(model=pf, input_col="features", device="cpu",
                     pipeline_parallel=3)
        assert m3._pipeline_active()
        np.testing.assert_allclose(m3.transform(df)["scores"],
                                   ref["scores"], atol=ATOL)
        assert m3.pipeline_report()["n_stages"] == 3

    def test_empty_frame_keeps_output_width(self):
        _, pf = _mlp([32, 16])
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2)
        out = m.transform(DataFrame({"features":
                                     np.zeros((0, 16), np.float32)}))
        assert out["scores"].shape == (0, 4)
        assert out["scores"].dtype == np.float32

    def test_batch_multiple_is_the_hosted_data_axis(self):
        """JAX's ``test_batch_multiple_reflects_stage_slice`` reads 4 and 2
        on its 8 devices; a hosted stage's data axis has one rank."""
        jf, pf = _mlp([32, 16])
        assert JNN(model=jf, input_col="features",
                   pipeline_parallel=2).batch_multiple == 4
        assert NNModel(model=pf, input_col="features",
                       pipeline_parallel=2).batch_multiple == 1
        assert NNModel(model=pf, input_col="features", pipeline_parallel=2,
                       tensor_parallel=2).batch_multiple == 1

    def test_compute_quantization_is_refused_as_in_jax(self):
        from mmlspark_tpu_torch.serving.quant import QuantizationConfig
        _, pf = _mlp([32, 16])
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2,
                    quantization=QuantizationConfig.from_value(
                        {"compute": {}}))
        with pytest.raises(NotImplementedError, match="pipeline_parallel"):
            m.transform(DataFrame({"features":
                                   np.zeros((2, 16), np.float32)}))

    def test_several_processes_are_refused(self, monkeypatch):
        _, pf = _mlp([32, 16])
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        m = NNModel(model=pf, input_col="features", device="cpu",
                    pipeline_parallel=2)
        # JAX's device_put of a stage onto another process's devices
        # raises ValueError: the form JAX lacks
        with pytest.raises(ValueError,
                           match="pipeline_parallel=2 in a world of 2"):
            m.transform(DataFrame({"features":
                                   np.zeros((2, 16), np.float32)}))


def jparams_mesh(tree):
    """The JAX mesh a placed stage tree lives on."""
    return jax.tree.leaves(tree)[0].sharding.mesh


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path, timeout=10).read())


class TestPipelinedServing:

    def test_live_server_zero_recompiles_and_stats_block(self):
        _, pf = _mlp([32, 32, 16])
        model = NNModel(model=pf, input_col="features", device="cpu",
                        pipeline_parallel=2, pipeline_microbatches=2)
        direct = NNModel(model=pf, input_col="features", device="cpu")
        srv = ServingServer(model, max_batch_size=8, max_latency_ms=2.0)
        srv.warmup({"features": [0.0] * 16})
        srv.start()
        rng = np.random.default_rng(0)
        try:
            base = f"http://{srv.host}:{srv.port}"
            rec0 = srv.n_recompiles
            for _ in range(12):
                row = rng.normal(size=16).astype(np.float32)
                got = _post(base, "/predict",
                            {"features": [float(v) for v in row]})
                want = direct.transform(DataFrame(
                    {"features": row[None]}))["scores"][0]
                np.testing.assert_allclose(got["scores"], want, atol=ATOL)
            assert srv.n_recompiles == rec0, "pipelined dispatch retraced"
            stats = _get(base, "/stats")
            block = stats["pipeline_parallel"]
            assert block["n_stages"] == 2
            assert block["bubble_ratio"] is not None
            assert stats["placement"]["mode"] == "pipeline_parallel"
        finally:
            srv.stop()

    def test_dispatch_spans_carry_pipeline_stage(self):
        _, pf = _mlp([32, 16])
        model = NNModel(model=pf, input_col="features", device="cpu",
                        pipeline_parallel=2, pipeline_microbatches=2)
        tracer = Tracer(default_slow_ms=0.0)   # capture everything
        srv = ServingServer(model, max_batch_size=8, max_latency_ms=2.0,
                            tracer=tracer, slow_trace_ms=0,
                            adaptive_slow_trace=False)
        srv.warmup({"features": [0.0] * 16})
        srv.start()
        try:
            base = f"http://{srv.host}:{srv.port}"
            _post(base, "/predict", {"features": [0.5] * 16})
            tid = _get(base, "/traces")[0]["trace_id"]
            tree = _get(base, f"/trace/{tid}")

            def walk(node, out):
                out.append(node)
                for c in node.get("children", ()):
                    walk(c, out)
                return out

            spans = [s for s in walk(tree["tree"], [])
                     if s.get("name") == "pipeline_stage"]
            assert sorted(s["attrs"]["pipeline_stage"]
                          for s in spans) == [0, 1], spans
            assert all(s["attrs"]["devices"] for s in spans)
        finally:
            srv.stop()
