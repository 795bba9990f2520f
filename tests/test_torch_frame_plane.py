"""The port's frame plane (``mmlspark_tpu_torch`` ``models/function.py``,
``resnet.py``, ``convert.py``, ``zoo.py``, ``nn.py``, ``serving/quant.py``'s
compute section, ``gbdt/stages.py``, ``core/pipeline.py``,
``config.py``, ``schema.py``, ``environment.py``,
``serving/consolidator.py``) against the JAX package on the same numpy
inputs, on the CPU.

Weights cross as numpy through the weight bridge: a JAX-initialized
param tree loads into the port's modules, and parity is by bridged
weights, never by seed. Tolerances, as ``max |got - ref| <= tol x
max(1, max |ref|)``:

* f32: 1e-5 (summation order only; GroupNorm mirrors flax's
  ``E[x^2] - E[x]^2`` statistics, so the two cancel alike), but 5e-5
  for ResNet-50 at width 8: its sixteen bottleneck blocks normalize
  groups of one or two channels over 2x2 and 3x3 frames, where that
  cancellation magnifies the summation order (measured 3.3e-6 to
  1.1e-5 over two seeds; the same network at width 4 on 36x36
  frames read 2.7e-5);
* bf16 through ``NNFunction.apply``: 3e-2 (measured 0 to 7.3e-3 at
  these shapes: op-by-op, both round every bf16 result, and a conv sum
  rounded the other way near a bf16 boundary carries one ulp, 2^-8,
  onward);
* bf16 through ``NNModel.transform``: 3e-2 as well (measured up to
  1.2e-2): JAX jits the forward, and XLA keeps fused bf16 intermediates
  in f32 where the port rounds each op.

The zoo goldens hold at the JAX test's 1e-4; the int8 quantizer's
scales and values are bit-equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import config as JCONF
from mmlspark_tpu.core import schema as JSCHEMA
from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.core.pipeline import PipelineModel as JPipelineModel
from mmlspark_tpu.gbdt import booster as JB
from mmlspark_tpu.gbdt import stages as JG
from mmlspark_tpu.models import convert as JCV
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.models.nn import NNModel as JNN
from mmlspark_tpu.serving import quant as JQ
from mmlspark_tpu_torch.core import config as PCONF
from mmlspark_tpu_torch.core import environment as PENV
from mmlspark_tpu_torch.core import logs as PLOGS
from mmlspark_tpu_torch.core import schema as PSCHEMA
from mmlspark_tpu_torch.core import serialize as PSER
from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.gbdt import booster as PB
from mmlspark_tpu_torch.gbdt import stages as PG
from mmlspark_tpu_torch.models import convert as PCV
from mmlspark_tpu_torch.models import nn as PNN_MOD
from mmlspark_tpu_torch.models.function import (
    NNFunction as PF, flax_from_module, module_from_flax,
)
from mmlspark_tpu_torch.models.nn import NNModel as PNN
from mmlspark_tpu_torch.parallel.topology import Mesh
from mmlspark_tpu_torch.models.zoo import ModelDownloader
from mmlspark_tpu_torch.serving import quant as PQ
from mmlspark_tpu_torch.serving.consolidator import PartitionConsolidator

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
BF16_TOL = 3e-2


def scaled_err(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def bridged(arch, input_shape, seed=0):
    """A JAX-initialized function and the port's on the same weights."""
    jf = JF.init(arch, input_shape, seed=seed)
    return jf, PF(arch=dict(arch), params=np_tree(jf.params))


def t_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# -- builders ------------------------------------------------------------------

BUILDERS = [
    ("cifar_resnet8", {"builder": "cifar_resnet", "depth": 8, "width": 8,
                       "num_classes": 5}, (8, 8, 3)),
    ("cifar_resnet20", {"builder": "cifar_resnet", "depth": 20, "width": 4,
                        "num_classes": 5}, (8, 8, 3)),
    ("imagenet_resnet18", {"builder": "imagenet_resnet", "depth": 18,
                           "width": 8, "num_classes": 5}, (40, 40, 3)),
    ("imagenet_resnet50", {"builder": "imagenet_resnet", "depth": 50,
                           "width": 8, "num_classes": 5}, (48, 48, 3)),
    ("cifar_convnet", {"builder": "cifar_convnet", "num_classes": 5},
     (8, 8, 3)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,arch,shape", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_builder_matches_jax_at_every_layer(name, arch, shape, dtype):
    arch = dict(arch, dtype=dtype)
    jf, pf = bridged(arch, shape, seed=1)
    assert pf.layer_names == jf.layer_names
    x = np.random.default_rng(0).standard_normal((3, *shape)).astype(
        np.float32)
    tol = BF16_TOL if dtype == "bfloat16" else \
        5e-5 if name == "imagenet_resnet50" else F32_TOL
    for layer in [None] + jf.layer_names:
        ref = np.asarray(jf.apply(x, output_layer=layer), np.float32)
        got = t_np(pf.apply(x, output_layer=layer, device="cpu"))
        assert scaled_err(got, ref) <= tol, (layer, scaled_err(got, ref))


@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
def test_mlp_matches_jax(activation):
    arch = {"builder": "mlp", "hidden": [7, 6], "num_outputs": 3,
            "activation": activation}
    jf, pf = bridged(arch, (5,), seed=2)
    x = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    for layer in [None] + jf.layer_names:
        ref = np.asarray(jf.apply(x, output_layer=layer))
        got = t_np(pf.apply(x, output_layer=layer, device="cpu"))
        assert scaled_err(got, ref) <= F32_TOL, layer


def test_bridge_round_trips_the_tree():
    arch = {"builder": "imagenet_resnet", "depth": 18, "width": 4,
            "num_classes": 3}
    jf, pf = bridged(arch, (16, 16, 3))
    back = flax_from_module(module_from_flax(pf.params, pf.module(), "cpu"))
    want = np_tree(jf.params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_init_draws_flax_shaped_trees_from_a_generator():
    """``NNFunction.init`` gives the JAX tree's keys and shapes; draws
    come from an explicit generator, so a seed repeats and parity with
    JAX is by bridged weights only."""
    arch = {"builder": "cifar_resnet", "depth": 8, "width": 8,
            "num_classes": 4}
    a = PF.init(arch, (8, 8, 3), seed=3)
    b = PF.init(arch, (8, 8, 3), generator=torch.Generator().manual_seed(3))
    j = JF.init(arch, (8, 8, 3), seed=3)
    from mmlspark_tpu.models.function import flatten_params as jflat
    from mmlspark_tpu_torch.models.function import flatten_params as pflat
    fa, fj = pflat(a.params), jflat(np_tree(j.params))
    assert sorted(fa) == sorted(fj)
    for k in fa:
        assert fa[k].shape == fj[k].shape and fa[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(fa[k], pflat(b.params)[k])
    # LeCun-normal kernels, zero biases, unit norm scales
    assert fa["params/layers_5_1/bias"].max() == 0.0
    assert (fa["params/layers_1_1/ResNetBlock_0/GroupNorm_0/scale"]
            == 1.0).all()
    k = fa["params/layers_1_1/ResNetBlock_0/Conv_0/kernel"]
    assert 0.5 < k.std() * np.sqrt(3 * 3 * 8) < 1.5


def test_bad_layer_and_cut_resolution():
    pf = PF.init({"builder": "cifar_convnet", "num_classes": 10},
                 (8, 8, 3))
    with pytest.raises(KeyError):
        pf.apply(np.zeros((1, 8, 8, 3), np.float32), output_layer="nope",
                 device="cpu")
    assert pf.layer_name_for_cut(0) is None
    assert pf.layer_name_for_cut(1) == "relu4"
    with pytest.raises(ValueError):
        pf.layer_name_for_cut(99)


def test_f32_convs_run_without_tf32():
    """The forward holds cuDNN's and cuBLAS's TF32 flags off inside it
    and restores them after."""
    pf = PF.init({"builder": "cifar_resnet", "depth": 8, "width": 4,
                  "num_classes": 2}, (8, 8, 1))
    seen = []
    mod = pf.to_module("cpu")
    mod.layers["layers_0_1"].register_forward_hook(
        lambda *a: seen.append((torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32)))
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    mod(torch.zeros((1, 8, 8, 1)))
    assert seen == [(False, False)]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


# -- the zoo -------------------------------------------------------------------

ZOO = [("digits_resnet8", lambda x: x),
       ("digits32_resnet14", lambda x: x),
       ("cifar10s_resnet20", lambda x: x.astype(np.float32) / 255.0)]


@pytest.mark.parametrize("name,prep", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_golden_logits(name, prep, tmp_path):
    """Hash-verified fetch from ``zoo/``, then the committed golden
    logits at the JAX test's 1e-4."""
    dl = ModelDownloader(str(tmp_path / "cache"),
                         repo=os.path.join(REPO, "zoo"))
    meta = dl.download_by_name(name)
    assert meta.uri.startswith(str(tmp_path))
    fn = dl.load(name)
    g = np.load(os.path.join(REPO, "tests", "resources",
                             f"golden_{name}.npz"))
    got = t_np(fn.apply(prep(g["x"]), device="cpu"))
    np.testing.assert_allclose(got, g["logits"], rtol=1e-4, atol=1e-4)


def test_zoo_hashes_and_manifest_match_jax(tmp_path):
    from mmlspark_tpu.models import zoo as JZ
    from mmlspark_tpu_torch.models import zoo as PZ
    root = os.path.join(REPO, "zoo")
    pm, jm = PZ.ModelRepo(root).models(), JZ.ModelRepo(root).models()
    assert sorted(pm) == sorted(jm)
    for name in pm:
        assert pm[name].to_json() == jm[name].to_json()
        assert PZ._dir_sha256(pm[name].uri) == pm[name].hash
    # a corrupted cache copy fails its hash and is refetched
    dl = ModelDownloader(str(tmp_path / "c"), repo=root)
    meta = dl.download_by_name("digits_resnet8")
    with open(os.path.join(meta.uri, "arch.json"), "a") as f:
        f.write(" ")
    assert dl.download_by_name("digits_resnet8").hash == meta.hash
    assert PZ._dir_sha256(meta.uri) == meta.hash


def test_zoo_publish_matches_jax(tmp_path):
    from mmlspark_tpu.models import zoo as JZ
    from mmlspark_tpu_torch.models import zoo as PZ
    jf, pf = bridged({"builder": "cifar_resnet", "depth": 8, "width": 4,
                      "num_classes": 3}, (8, 8, 1))
    pmeta = PZ.ModelRepo(str(tmp_path / "p")).publish(
        "m", pf, dataset="d", input_shape=[8, 8, 1], num_classes=3)
    jmeta = JZ.ModelRepo(str(tmp_path / "j")).publish(
        "m", jf, dataset="d", input_shape=[8, 8, 1], num_classes=3)
    assert pmeta.layer_names == jmeta.layer_names
    assert json.load(open(tmp_path / "p" / "manifest.json"))[0]["uri"] == "m"


# -- NNFunction directories across the packages ----------------------------------

def test_nnfunction_dirs_load_across_packages(tmp_path):
    arch = {"builder": "cifar_resnet", "depth": 8, "width": 8,
            "num_classes": 4}
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    jf = JF.init(arch, (8, 8, 3), seed=5)
    jf.save(str(tmp_path / "jax"))
    pf = PF.load(str(tmp_path / "jax"))
    assert scaled_err(t_np(pf.apply(x, device="cpu")),
                      np.asarray(jf.apply(x))) <= F32_TOL
    # the port writes what the JAX package reads, file for file
    pf2 = PF.init(arch, (8, 8, 3), seed=9)
    pf2.save(str(tmp_path / "port"))
    jf2 = JF.load(str(tmp_path / "port"))
    assert scaled_err(np.asarray(jf2.apply(x)),
                      t_np(pf2.apply(x, device="cpu"))) <= F32_TOL
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    with np.load(tmp_path / "port" / "params.npz") as a, \
            np.load(tmp_path / "jax" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)


# -- the importers ---------------------------------------------------------------

def test_import_torch_state_dict_matches_the_twin():
    from test_convert import ARCH, TorchCifarResNet
    torch.manual_seed(0)
    tm = TorchCifarResNet(depth=8, width=8).eval()
    fn = PCV.import_torch_state_dict(tm.state_dict(), ARCH,
                                     input_shape=(32, 32, 3))
    jfn = JCV.import_torch_state_dict(tm.state_dict(), ARCH,
                                      input_shape=(32, 32, 3))
    from mmlspark_tpu.models.function import flatten_params as jflat
    from mmlspark_tpu_torch.models.function import flatten_params as pflat
    pa, ja = pflat(fn.params), jflat(np_tree(jfn.params))
    assert sorted(pa) == sorted(ja)
    for k in pa:
        np.testing.assert_array_equal(pa[k], ja[k])
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(t_np(fn.apply(x, device="cpu")), want,
                               rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        h = tm.conv_in(torch.from_numpy(x).permute(0, 3, 1, 2))
        feats = tm.group3(tm.group2(tm.group1(h))).mean(dim=(2, 3)).numpy()
    np.testing.assert_allclose(
        t_np(fn.apply(x, output_layer="pool", device="cpu")), feats,
        rtol=1e-4, atol=1e-4)


def test_importer_refusals_match_jax():
    from test_convert import ARCH
    sd = {"conv.weight": torch.zeros(8, 3, 3, 3),
          "bn.running_mean": torch.zeros(8),
          "bn.running_var": torch.ones(8)}
    with pytest.raises(ValueError, match="BatchNorm"):
        PCV.import_torch_state_dict(sd, ARCH, input_shape=(32, 32, 3))
    with pytest.raises(ValueError, match="tensor count"):
        PCV.import_torch_state_dict({"w": torch.zeros(3)}, ARCH,
                                    input_shape=(32, 32, 3))
    with pytest.raises(ValueError, match="param tree mismatch"):
        PCV.import_flax_params({"params": {}}, ARCH, input_shape=(32, 32, 3))


def test_import_flax_params_adopts_a_jax_tree():
    arch = {"builder": "cifar_resnet", "depth": 8, "width": 8}
    src = JF.init(arch, (32, 32, 3), seed=7)
    fn = PCV.import_flax_params(np_tree(src.params), arch,
                                input_shape=(32, 32, 3))
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    assert scaled_err(t_np(fn.apply(x, device="cpu")),
                      np.asarray(src.apply(x))) <= F32_TOL


# -- NNModel against JAX's ---------------------------------------------------------

ARCH8 = {"builder": "cifar_resnet", "depth": 8, "width": 8,
         "num_classes": 5}


@pytest.fixture(scope="module")
def resnets():
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = bridged(dict(ARCH8, dtype=dtype), (8, 8, 3), seed=1)
    return out


def _frame(wire, rng, n=37):
    if wire == "uint8":
        return rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    if wire == "int8":
        return rng.integers(-128, 128, (n, 8, 8, 3), dtype=np.int8)
    return rng.uniform(0, 1, (n, 8, 8, 3)).astype(np.float32)


WIRES = [("auto", {}), ("float32", {}), ("bfloat16", {}), ("uint8", {}),
         ("int8", {}),
         ("float32", {"input_scale": 0.5, "input_offset": -0.25})]


@pytest.mark.parametrize("fetch", [1, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire,extra", WIRES,
                         ids=["auto", "f32", "bf16", "u8", "i8", "scaled"])
def test_transform_matches_jax(resnets, wire, extra, dtype, fetch):
    jf, pf = resnets[dtype]
    X = _frame(wire, np.random.default_rng(3))
    kw = dict(input_col="x", batch_size=8, fetch_batches=fetch,
              input_dtype=wire, **extra)
    ref = np.asarray(JNN(model=jf, **kw).transform(JDF({"x": X}))["scores"],
                     np.float32)
    out = PNN(model=pf, device="cpu", **kw).transform(PDF({"x": X}))
    got = out["scores"]
    assert got.dtype == np.float32 and got.shape == ref.shape == (37, 5)
    tol = F32_TOL if dtype == "float32" and wire != "bfloat16" else BF16_TOL
    assert scaled_err(got, ref) <= tol
    assert out.get_metadata("scores")["role"] == "scores"


def test_transform_object_column_and_cut(resnets):
    jf, pf = resnets["float32"]
    rng = np.random.default_rng(4)
    col = np.empty(11, dtype=object)
    for i in range(11):
        col[i] = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    for kw in ({}, {"output_layer": "pool"}, {"cut_output_layers": 2},
               {"output_layer": "group2"}):
        ref = np.asarray(JNN(model=jf, input_col="x", batch_size=4, **kw)
                         .transform(JDF({"x": col}))["scores"])
        got = PNN(model=pf, input_col="x", batch_size=4, device="cpu",
                  **kw).transform(PDF({"x": col}))["scores"]
        assert scaled_err(got, ref) <= F32_TOL, kw


def test_transform_empty_frame_learns_the_width(resnets):
    jf, pf = resnets["float32"]
    X = np.zeros((0, 8, 8, 3), np.float32)
    ref = np.asarray(JNN(model=jf, input_col="x").transform(
        JDF({"x": X}))["scores"])
    got = PNN(model=pf, input_col="x", device="cpu").transform(
        PDF({"x": X}))["scores"]
    assert got.shape == ref.shape == (0, 5)
    empty = np.empty(0, dtype=object)
    got = PNN(model=pf, input_col="x", device="cpu").transform(
        PDF({"x": empty}))["scores"]
    assert got.shape == (0, 0)


def test_uint8_wire_equals_normalized_float(resnets):
    _, pf = resnets["float32"]
    u8 = np.random.default_rng(5).integers(0, 256, (20, 8, 8, 3),
                                            dtype=np.uint8)
    a = PNN(model=pf, input_col="x", input_dtype="uint8", batch_size=8,
            device="cpu").transform(PDF({"x": u8}))["scores"]
    b = PNN(model=pf, input_col="x", batch_size=8, device="cpu").transform(
        PDF({"x": (u8.astype(np.float32) / 255.0)}))["scores"]
    assert scaled_err(a, b) <= 1e-5


def test_bf16_host_cast_rounds_to_nearest_even():
    """The bf16 wire is cast on the host and handed on as uint16 bits:
    the same bits as ml_dtypes' (JAX's) round to nearest even."""
    import ml_dtypes
    x = np.random.default_rng(6).standard_normal(4099).astype(np.float32)
    x[:4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -0.0, np.inf]
    got = PNN_MOD._host_cast(x, "bfloat16")
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


class TestPlacementAndRefusals:

    def test_placement_names_the_device(self, resnets):
        _, pf = resnets["float32"]
        m = PNN(model=pf, input_col="x", device="cpu")
        assert m.placement()["mode"] == "unplaced"
        m.transform(PDF({"x": np.zeros((2, 8, 8, 3), np.float32)}))
        p = m.placement()
        assert p["mode"] == "single_device"
        assert p["devices"] == ["cpu"] and p["n_devices"] == 1

    @pytest.mark.parametrize("param", ["tensor_parallel",
                                       "pipeline_parallel"])
    def test_multi_device_modes_refused(self, resnets, param, monkeypatch):
        """Both modes serve on a hosted mesh (their parity:
        ``tests/test_torch_pipeline_parallel.py``,
        ``tests/test_torch_tp_frame.py``). In a world of several
        processes tensor parallelism spreads over them (its parity:
        ``tests/test_torch_process_axes.py``: the mesh it asks for is the
        world's), and the pipeline raises JAX's ``ValueError``."""
        _, pf = resnets["float32"]
        m = PNN(model=pf, input_col="x", device="cpu", **{param: 2})
        with monkeypatch.context() as mp:
            mp.setattr(torch.distributed, "is_initialized", lambda: True)
            mp.setattr(torch.distributed, "get_world_size", lambda *a: 2)
            asked = []

            def train_mesh(shape, dev):
                # the world's mesh, stood in for by a hosted one
                asked.append(shape)
                return Mesh(shape, torch.device("cpu"), hosted=True)
            mp.setattr(PNN_MOD._dist, "train_mesh", train_mesh)
            x = PDF({"x": np.zeros((2, 8, 8, 3), np.float32)})
            if param == "pipeline_parallel":
                with pytest.raises(ValueError,
                                   match="pipeline_parallel=2 in a world"):
                    m.transform(x)
            else:
                m.transform(x)
                assert asked == [{"data": 1, "model": 2}]
            m.__dict__.pop("_setup_sharded", None)
        m.transform(PDF({"x": np.zeros((2, 8, 8, 3), np.float32)}))
        assert m.placement()["mode"] == param
        # 0/1 and data_parallel on one device are no-ops
        PNN(model=pf, input_col="x", device="cpu", data_parallel=True,
            **{param: 1}).transform(
                PDF({"x": np.zeros((2, 8, 8, 3), np.float32)}))

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
    def test_the_card_is_the_default(self, resnets):
        _, pf = resnets["float32"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PNN(model=pf, input_col="x").transform(
                PDF({"x": np.zeros((2, 8, 8, 3), np.float32)}))


# -- the frame cache ------------------------------------------------------------------

@pytest.fixture
def clean_cache():
    PNN_MOD._frame_cache().clear()
    PNN_MOD._FRAME_SEEN.clear()
    yield
    PNN_MOD._frame_cache().clear()
    PNN_MOD._FRAME_SEEN.clear()


def _counting(monkeypatch):
    calls = []
    orig = PNN_MOD._device_put

    def counting(x, p, wire="float32"):
        calls.append(1)
        return orig(x, p, wire)
    monkeypatch.setattr(PNN_MOD, "_device_put", counting)
    return calls


class TestFrameCache:
    """JAX's ``test_input_cache_*`` (``tests/test_models.py``)."""

    def test_one_upload_across_models(self, resnets, clean_cache,
                                      monkeypatch):
        _, pf = resnets["float32"]
        calls = _counting(monkeypatch)
        X = np.random.default_rng(7).uniform(0, 1, (40, 8, 8, 3)).astype(
            np.float32)
        df = PDF({"image": X})
        pf2 = PF.init(ARCH8, (8, 8, 3), seed=7)
        m1 = PNN(model=pf, input_col="image", output_col="s",
                 batch_size=16, device="cpu")
        m2 = PNN(model=pf2, input_col="image", output_col="s",
                 batch_size=16, device="cpu")
        out1 = m1.transform(df)["s"]           # sighting 1: no store
        n1 = len(calls)
        out1b = m1.transform(df)["s"]          # sighting 2: stores
        n2 = len(calls)
        assert n2 - n1 == 3                    # 40 rows / 16 = 3 batches
        out2 = m2.transform(df)["s"]           # hit: zero uploads
        out1c = m1.transform(df)["s"]
        assert len(calls) == n2
        np.testing.assert_array_equal(out1b, out1)
        np.testing.assert_array_equal(out1c, out1)
        assert out2.shape == out1.shape
        X[0] += 1.0                            # edited content misses
        m1.transform(df)
        assert len(PNN_MOD._frame_cache()) == 2

    def test_object_column_mutation_detected(self, resnets, clean_cache):
        _, pf = resnets["float32"]
        rng = np.random.default_rng(8)
        col = np.empty(16, dtype=object)
        for i in range(16):
            col[i] = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        df = PDF({"image": col})
        m = PNN(model=pf, input_col="image", output_col="s", batch_size=16,
                device="cpu")
        m.transform(df)
        out_a = m.transform(df)["s"]           # stored this pass
        assert len(PNN_MOD._frame_cache()) == 1
        col[0][:] = 0.0                        # in-place element edit
        out_b = m.transform(df)["s"]
        assert not np.allclose(out_a[0], out_b[0])

    def test_midbuffer_mutation_detected(self, resnets, clean_cache):
        _, pf = resnets["float32"]
        X = np.random.default_rng(9).uniform(0, 1, (32, 8, 8, 3)).astype(
            np.float32)
        df = PDF({"image": X})
        m = PNN(model=pf, input_col="image", output_col="s", batch_size=16,
                device="cpu")
        m.transform(df)
        out_a = m.transform(df)["s"]
        assert len(PNN_MOD._frame_cache()) == 1
        X[16][:] = 0.0                         # middle row only
        out_b = m.transform(df)["s"]
        assert not np.allclose(out_a[16], out_b[16])

    def test_disabled(self, resnets, clean_cache, monkeypatch):
        _, pf = resnets["float32"]
        calls = _counting(monkeypatch)
        X = np.zeros((16, 8, 8, 3), np.float32)
        m = PNN(model=pf, input_col="image", output_col="s", batch_size=16,
                cache_inputs=False, device="cpu")
        m.transform(PDF({"image": X}))
        n1 = len(calls)
        m.transform(PDF({"image": X}))
        assert len(PNN_MOD._frame_cache()) == 0
        assert n1 == 1 and len(calls) == 2


# -- compute quantization --------------------------------------------------------------

COMPUTE = [{"weight_dtype": "int8", "activation_dtype": "bfloat16"},
           {"weight_dtype": "int8", "activation_dtype": "float32",
            "scale_multiplier": 1.5}]


@pytest.mark.parametrize("comp", COMPUTE, ids=["bf16", "f32x1.5"])
def test_quantized_tree_and_scales_bit_equal(comp):
    arch = {"builder": "cifar_convnet", "num_classes": 4}
    jf, pf = bridged(arch, (8, 8, 3), seed=3)
    jq, js = JQ.quantize_param_tree(jf.params, JQ.ComputeQuantization(**comp))
    pq, ps = PQ.quantize_param_tree(pf.params, PQ.ComputeQuantization(**comp))
    assert sorted(ps) == sorted(js)
    assert "['params']['layers_11_1']['kernel']" in ps
    for k in js:
        assert ps[k].dtype == js[k].dtype
        np.testing.assert_array_equal(ps[k].view(np.uint32),
                                      np.asarray(js[k]).view(np.uint32))
    jl = jax.tree_util.tree_leaves_with_path(jq)
    for path, leaf in jl:
        node = pq
        for key in path:
            node = node[key.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))
    jd = JQ.dequantize_param_tree(jq, js, comp["activation_dtype"])
    pd = PQ.dequantize_param_tree(pq, ps, comp["activation_dtype"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(jd):
        node = pd
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(
            node.float().numpy() if torch.is_tensor(node)
            else np.asarray(node, np.float32),
            np.asarray(leaf, np.float32))


@pytest.mark.parametrize("comp", COMPUTE[:1] + [
    {"weight_dtype": "int8", "activation_dtype": "float32"}],
    ids=["bf16", "f32"])
def test_int8_compute_forward_matches_jax(resnets, comp):
    jf, pf = resnets["float32"]
    X = _frame("uint8", np.random.default_rng(10), n=20)
    qv = {"wire_dtype": "uint8", "compute": comp}
    jm = JNN(model=jf, input_col="x", batch_size=8,
             quantization=JQ.QuantizationConfig.from_value(qv))
    pm = PNN(model=pf, input_col="x", batch_size=8, device="cpu",
             quantization=PQ.QuantizationConfig.from_value(qv))
    ref = np.asarray(jm.transform(JDF({"x": X}))["scores"])
    got = pm.transform(PDF({"x": X}))["scores"]
    tol = F32_TOL if comp["activation_dtype"] == "float32" else BF16_TOL
    assert scaled_err(got, ref) <= tol
    jr = jm.quant_parity_report(JDF({"x": X}))
    pr = pm.quant_parity_report(PDF({"x": X}))
    assert pr["passed"] and jr["passed"]
    assert pr["rows"] == jr["rows"] == 20
    assert pr["max_rel"] == pytest.approx(jr["max_rel"], abs=2e-3)
    # a corrupted scale fails the verify step on both sides
    bad = dict(qv, compute=dict(comp, scale_multiplier=3.0))
    pm.quantization = PQ.QuantizationConfig.from_value(bad)
    assert not pm.quant_parity_report(PDF({"x": X}))["passed"]


def test_int8_kernels_persist_only_as_int8(resnets):
    """The served module holds int8 kernels; the forward dequantizes
    inside the call and leaves no f32 copy behind."""
    _, pf = resnets["float32"]
    qv = {"wire_dtype": "none", "compute": {"weight_dtype": "int8"}}
    m = PNN(model=pf, input_col="x", device="cpu",
            quantization=PQ.QuantizationConfig.from_value(qv))
    m.transform(PDF({"x": np.zeros((2, 8, 8, 3), np.float32)}))
    mod = m._setup_single_cache["cpu"]
    dtypes = {n: p.dtype for n, p in mod.named_parameters()}
    kernels = [n for n in dtypes if n.endswith("weight")
               and "GroupNorm" not in n]
    assert kernels and all(dtypes[n] == torch.int8 for n in kernels)


# -- persistence, pipelines, the consolidator ---------------------------------------------

def test_nnmodel_save_load_with_quantization(resnets, tmp_path):
    _, pf = resnets["float32"]
    qv = {"wire_dtype": "uint8", "compute": {"weight_dtype": "int8"}}
    m = PNN(model=pf, input_col="x", batch_size=8, device="cpu",
            quantization=PQ.QuantizationConfig.from_value(qv))
    X = _frame("uint8", np.random.default_rng(11), n=9)
    want = m.transform(PDF({"x": X}))["scores"]
    m.save(str(tmp_path / "m"))
    meta = json.load(open(tmp_path / "m" / "metadata.json"))
    assert "device" not in meta["params"]
    loaded = PipelineStage.load(str(tmp_path / "m"), device="cpu")
    assert loaded.device == "cpu"
    assert loaded.quantization == m.quantization
    np.testing.assert_array_equal(loaded.transform(PDF({"x": X}))["scores"],
                                  want)
    m2 = PNN.load_from_function(str(tmp_path / "m" / "nnfunction"),
                                input_col="x", device="cpu")
    assert m2.model.arch == pf.arch


def _gbdt_frame(seed=0, n=120):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    return X, X[:, 0] * 2.0 - X[:, 1] + 0.1 * rng.normal(size=n)


def test_pipeline_fit_save_load(resnets, tmp_path):
    """A fitted pipeline (GBDT estimator + NNModel transformer) saves
    and loads with every stage on the loader's device."""
    X, y = _gbdt_frame()
    df = PDF({"features": X, "label": y,
              "x": np.random.default_rng(1).uniform(
                  0, 1, (len(X), 8, 8, 3)).astype(np.float32)})
    _, pf = resnets["float32"]
    pipe = Pipeline(stages=[
        PG.GBDTRegressor(num_iterations=4, num_leaves=4, min_data_in_leaf=5,
                         device="cpu"),
        PNN(model=pf, input_col="x", batch_size=32, device="cpu")])
    fitted = pipe.fit(df)
    assert isinstance(fitted, PipelineModel)
    want = fitted.transform(df)
    fitted.save(str(tmp_path / "pm"))
    back = PipelineStage.load(str(tmp_path / "pm"), device="cpu")
    assert [s.device for s in back.stages] == ["cpu", "cpu"]
    got = back.transform(df)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_array_equal(got["scores"], want["scores"])
    pipe.save(str(tmp_path / "p"))
    assert len(PipelineStage.load(str(tmp_path / "p"),
                                  device="cpu").stages) == 2


def test_default_load_device_reaches_nested_stages(resnets, tmp_path):
    _, pf = resnets["float32"]
    inner = PNN(model=pf, input_col="x", device="cpu")
    PartitionConsolidator(stage=inner).save(str(tmp_path / "c"))
    PSER.set_default_load_device("cpu")
    try:
        back = PipelineStage.load(str(tmp_path / "c"))
    finally:
        PSER.set_default_load_device(None)
    assert back.stage.device == "cpu"
    X = np.zeros((3, 8, 8, 3), np.float32)
    np.testing.assert_array_equal(back.transform(PDF({"x": X}))["scores"],
                                  inner.transform(PDF({"x": X}))["scores"])
    assert PipelineStage.load(str(tmp_path / "c")).stage.device is None


# -- the GBDT stages ------------------------------------------------------------------------

def _jframe(X, y):
    from mmlspark_tpu.core.dataframe import obj_col
    return JDF({"features": obj_col(list(X)), "label": y})


def _pframe(X, y):
    from mmlspark_tpu_torch.core.dataframe import obj_col
    return PDF({"features": obj_col(list(X)), "label": y})


def test_gbdt_regressor_transform_matches_jax_on_one_fit():
    X, y = _gbdt_frame(2)
    jm = JG.GBDTRegressor(num_iterations=5, num_leaves=5,
                          min_data_in_leaf=5).fit(_jframe(X, y))
    pm = PG.GBDTRegressionModel(
        booster=PB.Booster.from_string(jm.booster.model_to_string(),
                                       device="cpu"), device="cpu")
    ref = np.asarray(jm.transform(_jframe(X, y))["prediction"])
    got = pm.transform(_pframe(X, y))["prediction"]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # and the port's own fit predicts what the JAX booster reads from it
    pfit = PG.GBDTRegressor(num_iterations=5, num_leaves=5,
                            min_data_in_leaf=5, device="cpu").fit(
                                _pframe(X, y))
    jb = JB.Booster.from_string(pfit.booster.model_to_string())
    np.testing.assert_allclose(pfit.transform(_pframe(X, y))["prediction"],
                               np.asarray(jb.predict(X)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n_class", [2, 3])
def test_gbdt_classifier_transform_matches_jax_on_one_fit(n_class):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(150, 3))
    y = (np.digitize(X[:, 0], [-0.4, 0.4]) % n_class).astype(float) + 1
    jm = JG.GBDTClassifier(num_iterations=4, num_leaves=4,
                           min_data_in_leaf=5).fit(_jframe(X, y))
    pm = PG.GBDTClassificationModel(
        booster=PB.Booster.from_string(jm.booster.model_to_string(),
                                       device="cpu"),
        classes=jm.classes, device="cpu")
    ref = jm.transform(_jframe(X, y))
    got = pm.transform(_pframe(X, y))
    for col in ("raw_prediction", "probability"):
        np.testing.assert_allclose(got[col], np.asarray(ref[col]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["prediction"],
                                  np.asarray(ref["prediction"]))
    assert got.get_metadata("probability")["role"] == \
        JSCHEMA.SCORED_PROBABILITIES_KIND
    pfit = PG.GBDTClassifier(num_iterations=4, num_leaves=4,
                             min_data_in_leaf=5, device="cpu").fit(
                                 _pframe(X, y))
    assert pfit.classes == jm.classes
    acc = (pfit.transform(_pframe(X, y))["prediction"] == y).mean()
    assert acc > 0.8


def test_gbdt_model_save_load_and_native(tmp_path):
    X, y = _gbdt_frame(4)
    m = PG.GBDTRegressor(num_iterations=3, num_leaves=3, min_data_in_leaf=5,
                         device="cpu").fit(_pframe(X, y))
    m.save(str(tmp_path / "g"))
    back = PipelineStage.load(str(tmp_path / "g"), device="cpu")
    np.testing.assert_array_equal(back.transform(_pframe(X, y))["prediction"],
                                  m.transform(_pframe(X, y))["prediction"])
    m.save_native_model(str(tmp_path / "native.txt"))
    nat = PG.load_native_model(str(tmp_path / "native.txt"),
                               is_classifier=False, device="cpu")
    np.testing.assert_allclose(nat.transform(_pframe(X, y))["prediction"],
                               m.transform(_pframe(X, y))["prediction"],
                               rtol=1e-6, atol=1e-6)
    assert m.feature_importances().sum() > 0


# -- core: config, schema, environment, logs -------------------------------------------------

def test_config_layers_match_jax(monkeypatch, tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"demo": {"a": 1, "b": "file"}}))
    monkeypatch.setenv("MMLSPARK_TPU_CONFIG", str(cfg))
    monkeypatch.setenv("MMLSPARK_TPU_DEMO_B", '"env"')
    monkeypatch.setenv("MMLSPARK_TPU_DEMO_C", "[1, 2]")
    monkeypatch.setenv("MMLSPARK_TPU_NATIVE_X", "1")
    for mod in (PCONF, JCONF):
        mod.register_defaults("demo", {"a": 0, "d": True})
    assert PCONF.MMLConfig.get("demo") == JCONF.MMLConfig.get("demo") == \
        {"a": 1, "b": "env", "c": [1, 2], "d": True}
    assert PCONF.MMLConfig.get("native") == {}


def test_logs_read_their_level_through_the_config(monkeypatch):
    import logging
    monkeypatch.setenv("MMLSPARK_TPU_LOGGING_LEVEL", "DEBUG")
    PLOGS.get_logger("t")
    PLOGS.reconfigure()
    try:
        assert logging.getLogger("mmlspark_tpu_torch").level == \
            logging.DEBUG
    finally:
        monkeypatch.delenv("MMLSPARK_TPU_LOGGING_LEVEL")
        PLOGS.reconfigure()
    assert logging.getLogger("mmlspark_tpu_torch").level == logging.INFO


def test_schema_matches_jax():
    for fn in ("make_categorical_meta", "make_features_meta"):
        assert getattr(PSCHEMA, fn)(["a", "b"]) == \
            getattr(JSCHEMA, fn)(["a", "b"])
    meta = PSCHEMA.make_features_meta(["x", "c"], {"c": [1, 2]})
    assert PSCHEMA.categorical_slot_indexes(meta) == \
        JSCHEMA.categorical_slot_indexes(meta) == [1]
    df = PDF({"s": np.zeros(2)}).with_column(
        "t", np.zeros(2), metadata=PSCHEMA.make_role_meta("scores", "u"))
    assert PSCHEMA.find_column_by_role(df, "scores") == "t"
    assert PSCHEMA.find_unused_column_name("s", df) == "s_1"


def test_environment_describes_the_host():
    assert PENV.accelerator_count() == (torch.cuda.device_count()
                                        if torch.cuda.is_available() else 0)
    d = PENV.describe()
    assert "device(s)" in d
    if not torch.cuda.is_available():
        assert d.startswith("cpu:cpu")


def test_jax_pipeline_model_persistence_is_refused(tmp_path):
    """A pipeline the JAX package wrote names its classes; the port's
    registry refuses them rather than import that package."""
    JPipelineModel(stages=[]).save(str(tmp_path / "j"))
    with pytest.raises(KeyError, match="JAX package"):
        PipelineStage.load(str(tmp_path / "j"))
