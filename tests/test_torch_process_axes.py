"""The model, expert and pipe axes over processes, against the JAX package
on the CPU: meshes of several processes that each host ranks (the mixed
form), the shard_map and pjit train steps on them, tensor-parallel decode
and ``NNModel`` scoring one rank per process, ``NNLearner``'s model axis
over processes, and the cooperative checkpoint of a mixed mesh.

Each world is two processes over gloo
(:mod:`mmlspark_tpu_torch.testing.process_world`), spawned once a module
where its cases can share it. The tolerances:

* train steps at ``tests/test_transformer.py``'s sizes: against JAX's
  single-process 8-device mesh, the losses within 1e-5 and every
  parameter within 2e-4 (``TestPjitFormulation``'s limits); against the
  port's hosted run of the same mesh, both within 1e-6;
* decode: token for token;
* scoring and fits: ``tests/test_torch_tp_frame.py``'s 1e-5.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.io import checkpoint as JC
from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.parallel import dist as JDIST
from mmlspark_tpu.parallel.topology import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.topology import build_mesh as jbuild_mesh
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.parallel import collectives as C
from mmlspark_tpu_torch.parallel import dist as PD
from mmlspark_tpu_torch.parallel import topology as TP
from mmlspark_tpu_torch.serving import decode as D
from mmlspark_tpu_torch.testing import process_world as W

torch.set_num_threads(1)

LOSS_TOL, PARAM_TOL = 1e-5, 2e-4       # TestPjitFormulation's
HOSTED_TOL = 1e-6
FRAME_TOL = 1e-5
DENSE = dict(vocab=64, d_model=16, n_heads=4, d_head=8, d_ff=32)
MOE = dict(DENSE, layers_per_stage=1, n_experts=4, moe_top_k=2,
           moe_aux_weight=0.01, moe_zloss_weight=1e-3)
#: run id -> (mesh shape, config fields, impl)
RUNS = {
    "pipe2_data4_shard_map": ({"pipe": 2, "data": 4},
                              dict(DENSE, n_stages=2, microbatches=2),
                              "shard_map"),
    "pipe2_data4_pjit": ({"pipe": 2, "data": 4},
                         dict(DENSE, n_stages=2, microbatches=2), "pjit"),
    "data8_shard_map": ({"data": 8}, dict(DENSE, layers_per_stage=2),
                        "shard_map"),
    "data8_pjit": ({"data": 8}, dict(DENSE, layers_per_stage=2), "pjit"),
    # the model axis split between 2 hosted ranks and the 2 processes,
    # wholly hosted beside a data axis across them, wholly across beside
    # a hosted data axis
    "model4_shard_map": ({"model": 4}, dict(DENSE, layers_per_stage=2),
                         "shard_map"),
    "data2_model4_shard_map": ({"data": 2, "model": 4},
                               dict(DENSE, layers_per_stage=2), "shard_map"),
    "model2_data4_shard_map": ({"model": 2, "data": 4},
                               dict(DENSE, layers_per_stage=2), "shard_map"),
    # the expert axis split, and wholly across beside a hosted data axis
    "expert4_shard_map": ({"expert": 4}, MOE, "shard_map"),
    "expert2_data4_shard_map": ({"expert": 2, "data": 4}, MOE, "shard_map"),
}
STEPS, B, S = 3, 8, 16


def _jtree(kw):
    return jax.tree.map(np.asarray, JT.init_params(
        JT.TransformerConfig(**kw), seed=0))


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return jbuild_mesh(JMeshSpec.from_dict(shape), devices=jax.devices()[:n])


def _jax_steps(shape, kw, impl):
    jcfg = JT.TransformerConfig(**kw)
    mesh = _jmesh(shape)
    step = JT.build_spmd_train_step(jcfg, mesh, 0.1, 0.9, donate=False,
                                    impl=impl)
    tree = _jtree(kw)
    p = JT.shard_params(jax.tree.map(jax.numpy.asarray, tree), jcfg, mesh)
    v = JT.shard_params(jax.tree.map(jax.numpy.zeros_like, tree), jcfg, mesh)
    batch = JT.make_batch(np.random.default_rng(7), jcfg, B, S)
    losses = []
    for _ in range(STEPS):
        p, v, loss = step(p, v, *batch)
        losses.append(float(loss))
    return losses, W.flat_tree(jax.tree.map(np.asarray, jax.device_get(p)))


def _hosted_steps(shape, kw, impl):
    cfg = T.TransformerConfig(**kw)
    mesh = TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")
    params = T.shard_params(_jtree(kw), cfg, mesh)
    velocity = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, 0.1, 0.9, impl=impl)
    batch = T.make_batch(np.random.default_rng(7), cfg, B, S, "cpu")
    losses = [float(step(params, velocity, *batch)[2]) for _ in range(STEPS)]
    return losses, W.flat_tree(T.params_to_numpy(params))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """run id -> each process's result of the 2-process world."""
    tmp = tmp_path_factory.mktemp("steps")
    runs = {}
    for key, (shape, kw, impl) in RUNS.items():
        path = str(tmp / f"{key}.npz")
        np.savez(path, **W.flat_tree(_jtree(kw)))
        runs[key] = {"mesh": shape, "cfg": kw, "impl": impl, "tree": path,
                     "steps": STEPS, "batch": B, "seq": S}
    world = W.spawn("train_step", 2, {"runs": runs}, device="cpu",
                    workdir=str(tmp), timeout=240)
    return {key: [w[key] for w in world] for key in RUNS}


@pytest.mark.parametrize("key", sorted(RUNS))
def test_mixed_mesh_steps_match_jax_and_the_hosted_run(steps, key):
    """Two processes hosting ranks: ``{"pipe": 2, "data": 4}`` with the
    pipe axis as the process boundary (JAX's
    ``tools/launch_multiprocess.py`` pipe phase), ``{"data": 8}``, whose
    data axis has a hosted and a cross-process part, the model axis
    split (``{"model": 4}``: each process folds two model ranks into its
    branches and sums with the other), hosted and across, and the expert
    axis split and across (a mixture of 4 experts, top-2)."""
    shape, kw, impl = RUNS[key]
    jl, jp = _jax_steps(shape, kw, impl)
    hl, hp = _hosted_steps(shape, kw, impl)
    for r, got in enumerate(steps[key]):
        assert got["n_hosted"] == math.prod(shape.values()) // 2
        np.testing.assert_allclose(got["losses"], jl, atol=LOSS_TOL, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["losses"], hl, atol=HOSTED_TOL,
                                   rtol=0, err_msg=f"rank {r}")
        for name, value in got["params"].items():
            np.testing.assert_allclose(np.asarray(value), jp[name],
                                       atol=PARAM_TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(np.asarray(value), hp[name],
                                       atol=HOSTED_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape,axis", [({"seq": 8}, "seq"),
                                        ({"expert": 2, "data": 4}, "expert"),
                                        ({"data": 2, "model": 4}, "model")])
def test_collectives_on_mixed_axes_equal_the_hosted_mesh(tmp_path, shape,
                                                         axis):
    """An axis split between hosted ranks and processes, one wholly
    across them, one wholly inside them: the ring permutes, the sum, the
    all-to-all and a ring permute's gradient equal the hosted mesh's,
    rank for rank."""
    world = W.spawn("collectives", 2, {"mesh": shape, "axis": axis},
                    device="cpu", workdir=str(tmp_path), timeout=120)
    mesh = TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")
    ax = mesh.axis(axis)
    full = torch.from_numpy(np.random.default_rng(3).normal(
        size=(mesh.size, 8, 6)).astype(np.float32))
    g = full.clone().requires_grad_(True)
    (C.ring_permute(g, ax, 1) * torch.arange(6.0)).sum().backward()
    want = {"ring_fwd": C.ring_permute(full, ax, 1),
            "ring_back": C.ring_permute(full, ax, -1),
            "sum": C.allreduce_sum(full, ax),
            "a2a": C.all_to_all(full, ax, 0, 1), "ring_grad": g.grad}
    for p, got in enumerate(world):
        ranks = slice(p * 4, (p + 1) * 4)
        for k, v in want.items():
            np.testing.assert_allclose(np.asarray(got[k]), v[ranks].numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)


def test_the_process_boundary_splits_the_leading_axes(monkeypatch):
    """JAX orders global devices by process: a process's ranks are a
    contiguous block, so the leading axes lie across processes and the
    trailing ones inside them."""
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    cpu = torch.device("cpu")
    pipe = TP.Mesh({"pipe": 2, "data": 4}, cpu, hosted=False)
    assert pipe.ranks == [4, 5, 6, 7] and pipe.mixed
    assert pipe.hosted_shape == {"pipe": 1, "data": 4}
    assert pipe.across_shape == {"pipe": 2, "data": 1}
    assert [pipe.coords(r) for r in pipe.ranks] == [(1, c) for c in range(4)]
    data = TP.Mesh({"data": 8}, cpu, hosted=False)
    assert data.hosted_shape == {"data": 4} and data.axis("data").across_size == 2
    assert data.axis("data").index().tolist() == [4, 5, 6, 7]
    assert PD.process_local_rows(16, data) == (8, 16)
    assert PD.process_local_rows(16, pipe) == (0, 16)
    one = TP.Mesh({"model": 2}, cpu, hosted=False)
    assert one.ranks == [1] and not one.mixed and one.n_hosted == 1
    with pytest.raises(ValueError, match="not a block"):
        TP.Mesh({"data": 3, "model": 2}, cpu, hosted=False)
    with pytest.raises(ValueError, match="spread evenly"):
        TP.Mesh({"data": 3}, cpu, hosted=False)


def test_build_mesh_refuses_a_mesh_smaller_than_the_world(monkeypatch):
    """A fully fixed spec smaller than the world, or not a multiple of
    it, raises ``ValueError`` (the JAX ``build_mesh``'s refusal of a
    device subset across processes); a ``-1`` axis resolves against the
    world."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    for shape in ({"model": 2}, {"model": 2, "pipe": 3}):
        with pytest.raises(ValueError, match="every process must hold"):
            TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks: None)
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"model": 2, "data": -1}),
                         "cpu")
    assert mesh.shape == {"model": 2, "data": 2} and mesh.n_hosted == 1
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"pipe": 2, "data": 4}),
                         "cpu")
    assert mesh.n_hosted == 2 and mesh.hosted_shape["data"] == 2


def test_build_mesh_defaults_to_the_card(monkeypatch):
    """Over processes the device defaults to the card under gloo as under
    NCCL: without CUDA ``device=None`` raises, and ``"cpu"`` is the only
    way onto the CPU."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.build_mesh(TP.MeshSpec.from_dict({"data": 2}))
    assert TP.build_mesh(TP.MeshSpec.from_dict({"data": 2}),
                         "cpu").device == torch.device("cpu")


def test_axes_split_between_hosts_and_processes_build(monkeypatch):
    """A model or expert axis split between hosted ranks and processes
    builds the step and the decoder (their runs above and below)."""
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    cpu = torch.device("cpu")
    split = TP.Mesh({"model": 4}, cpu, hosted=False)
    assert split.hosted_shape == {"model": 2}
    cfg = T.TransformerConfig(**DENSE)
    assert callable(T.build_spmd_train_step(cfg, split))
    dec = D.TransformerDecoder(T.init_params_np(cfg), cfg, mesh=split,
                               **W.DECODE_KW)
    assert dec.tp == 2 and dec.model_axis.size == 2
    experts = TP.Mesh({"expert": 4}, cpu, hosted=False)
    assert callable(T.build_spmd_train_step(T.TransformerConfig(**MOE),
                                            experts))


# -- tensor-parallel decode over processes ----------------------------------

@pytest.fixture(scope="module")
def decode_world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("decode"))
    return {key: W.spawn("tp_decode", 2, {"mesh": shape, "max_new": 8},
                         device="cpu", workdir=tmp, timeout=180)
            for key, shape in (("per_process", {"data": 1, "model": 2}),
                               ("model_across", {"model": 2, "data": 2}),
                               ("model_hosted", {"data": 2, "model": 2}),
                               ("model_split", {"data": 1, "model": 4}))}


@pytest.fixture(scope="module")
def decode_refs():
    """JAX's tensor-parallel decoder on 2 devices, the port's hosted one
    and its single-device one, on the same weights and prompts, through
    the same lockstep loop (prefix hits included)."""
    cfg = T.TransformerConfig(**W.DECODE_CFG)
    tree = T.init_params_np(cfg, seed=0)
    prompts = W.decode_prompts(vocab=cfg.vocab)
    jdec = JD.TransformerDecoder(
        jax.tree.map(jax.numpy.asarray, tree),
        JT.TransformerConfig(**W.DECODE_CFG),
        mesh=JDIST.train_mesh({"data": 1, "model": 2},
                              devices=jax.devices()[:2]),
        attn_impl="dense", **W.DECODE_KW)
    hosted = D.TransformerDecoder(tree, cfg, mesh=PD.train_mesh(
        {"data": 1, "model": 2}, "cpu"), **W.DECODE_KW)
    return {"jax": W.greedy_lockstep(jdec, prompts, 8, 16),
            "hosted": W.greedy_lockstep(hosted, prompts, 8, 16),
            "hosted_placement": hosted.placement(),
            "single": W.greedy_lockstep(D.TransformerDecoder(
                tree, cfg, device="cpu", **W.DECODE_KW), prompts, 8, 16)}


@pytest.mark.parametrize("key", ["per_process", "model_across",
                                 "model_hosted", "model_split"])
def test_tp_decode_over_processes_is_jaxs_token_for_token(decode_world,
                                                          decode_refs, key):
    """``{"data": 1, "model": 2}`` one rank per process, ``{"model": 2,
    "data": 2}`` (the model axis across the processes, the data axis
    hosted), ``{"data": 2, "model": 2}`` (the model axis hosted in each
    process) and ``{"data": 1, "model": 4}`` (two model ranks hosted in
    each process, summed across): the tokens are JAX's tensor-parallel
    decoder's, the hosted decoder's and the single-device decoder's, on
    every process."""
    for r, got in enumerate(decode_world[key]):
        assert got["tokens"] == decode_refs["jax"], f"rank {r}"
        assert got["tokens"] == decode_refs["hosted"]
        assert got["tokens"] == decode_refs["single"]
    # each model rank's heads in pages of their own (hosted, every rank's
    # pages in the process's pool)
    tp = 4 if key == "model_split" else 2
    assert decode_world[key][0]["pool_heads"] == W.DECODE_CFG["n_heads"] // tp


def test_tp_decode_placement_over_processes_is_the_hosted_report(
        decode_world, decode_refs):
    """One rank per process, each process holds half the sharded bytes;
    the report (the whole state, a rank's share) is the hosted mesh's."""
    want = decode_refs["hosted_placement"]
    for got in decode_world["per_process"]:
        got = got["placement"]
        for k in ("mode", "label", "mesh", "n_devices", "sharded_leaves",
                  "replicated_leaves", "state_bytes",
                  "state_bytes_per_device"):
            assert got[k] == want[k], k


# -- NNModel and NNLearner over processes -----------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_nn_tensor_parallel_scores_over_processes(tmp_path, tp):
    """``NNModel(tensor_parallel=2)`` in a world of two is ``{"data": 1,
    "model": 2}`` one rank per process (JAX's on two single-device
    processes); ``tensor_parallel=4`` hosts two model ranks in each. The
    scores equal the single-device scores and JAX's tensor-parallel
    ``NNModel``'s."""
    from mmlspark_tpu.core.dataframe import DataFrame as JDF
    from mmlspark_tpu.models.function import NNFunction as JF
    from mmlspark_tpu.models.nn import NNModel as JNN
    world = W.spawn("nn_tp", 2, {"tensor_parallel": tp}, device="cpu",
                    workdir=str(tmp_path), timeout=120)
    fn, x = W.seeded_mlp({})
    jfn = JF(arch=dict(fn.arch), params=jax.tree.map(np.asarray, fn.params))
    want = np.stack(list(JNN(model=jfn, input_col="x", tensor_parallel=2)
                         .transform(JDF({"x": x}))["scores"]))
    for got in world:
        np.testing.assert_allclose(np.asarray(got["scores"]),
                                   np.asarray(got["single"]), atol=FRAME_TOL)
        np.testing.assert_allclose(np.asarray(got["scores"]), want,
                                   atol=FRAME_TOL)
        assert got["placement"]["mode"] == "tensor_parallel"
        assert got["placement"]["mesh"] == {"data": 1, "model": tp}


def test_nn_pipeline_over_processes_raises_jaxs_error(monkeypatch):
    """JAX's pipelined ``NNModel`` ``device_put``s each stage onto devices
    of the other processes and raises ``ValueError``; so does the port's."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.nn import NNModel
    fn, x = W.seeded_mlp({})
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="pipeline_parallel=2 in a world"):
        NNModel(model=fn, input_col="x", device="cpu",
                pipeline_parallel=2).transform(DataFrame({"x": x}))


@pytest.mark.parametrize("mesh", [{"data": 8}, {"data": 2, "model": 2}])
def test_learner_over_processes_matches_jax(tmp_path, mesh):
    """``{"data": 8}`` over two processes (four data ranks each) and the
    model axis hosted in each process of ``{"data": 2, "model": 2}``:
    every process's losses and scores equal the port's single-process
    fit and JAX's fit on the same mesh in one process (1e-5)."""
    from mmlspark_tpu.core.dataframe import DataFrame as JDF
    from mmlspark_tpu.models.function import NNFunction as JF
    from mmlspark_tpu.models.trainer import NNLearner as JNNLearner
    from mmlspark_tpu_torch.models.function import flatten_params
    jf = JF.init(W.LEARNER_ARCH, (4,), seed=5)
    start = str(tmp_path / "start.npz")
    np.savez(start, **flatten_params(jax.tree.map(np.asarray, jf.params)))
    world = W.spawn("learner", 2, {"mesh": mesh, "start": start},
                    device="cpu", workdir=str(tmp_path), timeout=180)
    one = W.learner_case("cpu", {"mesh": {"data": 1}, "start": start})
    x, y = W.learner_rows()
    jm = JNNLearner(model=JF(arch=dict(W.LEARNER_ARCH),
                             params=jax.tree.map(np.array, jf.params)),
                    mesh_shape=mesh, **W.LEARNER_KW).fit(
                        JDF({"features": x, "label": y}))
    js = np.asarray(jm.model.apply(x))
    for got in world:
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   atol=FRAME_TOL)
        np.testing.assert_allclose(np.asarray(got["scores"]), one["scores"],
                                   atol=FRAME_TOL)
        np.testing.assert_allclose(np.asarray(got["scores"]), js,
                                   atol=FRAME_TOL)


def test_learner_model_axis_one_rank_per_process_raises_jaxs_error(
        tmp_path):
    """JAX's ``put_batch`` refuses a data axis that does not divide over
    the processes, so its ``NNLearner`` has no model axis one rank per
    process; the port raises the same ``ValueError``."""
    with pytest.raises(RuntimeError,
                       match=r"ValueError: data axis \(1\) not divisible "
                             r"by process count \(2\)"):
        W.spawn("learner", 2, {"mesh": {"data": 1, "model": 2}},
                device="cpu", workdir=str(tmp_path), timeout=120)


# -- the cooperative checkpoint of a mixed mesh -----------------------------

def test_mixed_checkpoint_is_jaxs_file_for_file(tmp_path):
    """Two processes of four ranks save ``{"data": 4, "model": 2}``'s
    state into one directory, each its own slices: the index and every
    file equal JAX's save from the same mesh in one process, and it
    restores bit for bit in one process."""
    from mmlspark_tpu_torch.io import checkpoint as PC
    ppath, jpath = str(tmp_path / "port"), str(tmp_path / "jax")
    world = W.spawn("checkpoint", 2, {"mesh": {"data": 4, "model": 2},
                                      "dir": ppath}, device="cpu",
                    workdir=str(tmp_path), timeout=120)
    assert [w["ranks"] for w in world] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    tree = W.checkpoint_tree()
    JC.save_sharded(jpath, JDIST.shard_state(tree, _jmesh(
        {"data": 4, "model": 2})), extra={"step": 1})
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(ppath))
    for name in os.listdir(jpath):
        with open(os.path.join(jpath, name), "rb") as a, \
                open(os.path.join(ppath, name), "rb") as b:
            assert a.read() == b.read(), name
    back = PC.restore_sharded(ppath, tree, strict_digest=True)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])


def test_gbdt_learners_over_a_mixed_mesh_equal_the_hosted_fit(tmp_path):
    """The data, feature and voting learners on ``{"data": 8}`` over two
    processes of four ranks each: every process's model equals the
    hosted ``{"data": 8}`` fit's, split for split (leaf values 1e-6, as
    ``tests/test_torch_gbdt_distributed.py``'s gloo ranks)."""
    import mmlspark_tpu_torch.gbdt as TG
    from test_torch_gbdt_distributed import GLOO, GLOO_TOL, _gloo_data
    fits = {n: GLOO[n] for n in ("data", "feature", "voting",
                                 "data_goss", "voting_quantile")}
    data = str(tmp_path / "gbdt.npz")
    arrays = {}
    for name in fits:
        X, y, _ = _gloo_data(name)
        arrays[name + ".X"], arrays[name + ".y"] = X, y
    np.savez(data, **arrays)
    world = W.spawn("gbdt", 2, {"mesh": {"data": 8}, "data": data,
                                "fits": fits}, device="cpu",
                    workdir=str(tmp_path), timeout=180)
    assert world[0] == world[1]
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"data": 8}), "cpu")
    for name, kw in fits.items():
        X, y, X_eval = _gloo_data(name)
        want = TG.Booster.train(TG.BoosterParams(**kw), X, y, sharding=mesh)
        got = TG.Booster.from_string(world[0][name], device="cpu")
        assert len(got.trees) == len(want.trees), name
        for ta, tb in zip(got.trees, want.trees):
            for a, b in zip(ta, tb):
                for f in ("feature", "threshold_bin", "left", "right",
                          "missing_left", "cat_mask"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f),
                                                  err_msg=name)
                np.testing.assert_allclose(a.value, b.value, rtol=GLOO_TOL,
                                           atol=GLOO_TOL, err_msg=name)
        np.testing.assert_allclose(got.predict(X_eval), want.predict(X_eval),
                                   rtol=GLOO_TOL, atol=GLOO_TOL,
                                   err_msg=name)
