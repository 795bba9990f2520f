"""The port's sharded train-state store (``mmlspark_tpu_torch/io/
checkpoint.py``) and the transformer's ``save_train_state`` /
``restore_train_state`` against the JAX package's, on the CPU.

* Leaf names and order equal JAX's ``_leaf_names`` for the transformer
  tree (dense and MoE) and for ``NNLearner``'s state under the four
  optimizers, with and without clipping, under a schedule and a
  constant rate; the state's leaves have JAX's shapes and dtypes.
* A checkpoint JAX writes from a 2x2-sharded tree (f32, int32 and bf16
  leaves) restores bit-exact in the port, whole on the CPU and as a
  hosted ``{"data": 2, "model": 2}``'s ``Shards``; the port's plain,
  ``Shards`` and bf16 leaves restore bit-exact in JAX. The two packages
  write the same files byte for byte, the same ``index.json``, and each
  verifies the other's manifest strictly.
* ``tests/test_dist.py``'s store cases: an interrupted save is
  invisible, older partials are swept, retention prunes, a corrupt
  slice, a legacy digest-less directory under strict restore, dtype
  drift and a remote path all fail loudly.
* Two gloo processes save one directory cooperatively; one process (of
  either package) restores it bit-exact.
* ``test_checkpoint_resume_across_meshes`` (2e-5 on the loss): saved on
  a hosted ``{"data": 2, "model": 2}``, resumed on ``{"data": 4}`` and
  on the original mesh; and a JAX-saved train state resumed in the port
  reaches JAX's uninterrupted loss within 2e-5.
"""

import collections
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.io import checkpoint as JC
from mmlspark_tpu.models import trainer as JTR
from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.parallel import dist as JD
from mmlspark_tpu.parallel.topology import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.topology import build_mesh as jbuild_mesh
from mmlspark_tpu_torch.io import checkpoint as PC
from mmlspark_tpu_torch.models import trainer as PTR
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.parallel import dist as PD
from mmlspark_tpu_torch.parallel import topology as TP

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DENSE = dict(vocab=64, d_model=16, n_heads=4, d_head=8, d_ff=32)
MLP = {"builder": "mlp", "hidden": [8], "num_outputs": 3}
CNN = {"builder": "cifar_resnet", "depth": 8, "width": 4,
       "num_classes": 3}


def submesh(shape):
    n = int(np.prod(list(shape.values())))
    return jbuild_mesh(JMeshSpec.from_dict(shape), devices=jax.devices()[:n])


def hosted(shape):
    return TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")


def as_torch(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor; ml_dtypes' bfloat16 as torch's, bits
    kept."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """A leaf's bytes (a tensor, ``Shards`` or array of any dtype)."""
    x = PD.gathered(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(x).view(np.uint8)


def mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "i": rng.integers(-99, 99, size=(16, 8)).astype(np.int32),
            "wb": rng.normal(size=(8, 8)).astype(np.float32)
            .astype(ml_dtypes.bfloat16),
            "b": rng.normal(size=(32,)).astype(np.float32),
            "blocks": [{"k": rng.normal(size=(16, 8)).astype(np.float32)}]}


# -- leaf names ---------------------------------------------------------------

@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_transformer_leaf_names_are_jaxs(moe):
    kw = dict(DENSE, layers_per_stage=2)
    if moe:
        kw.update(n_experts=2, moe_top_k=1)
    jcfg = JT.TransformerConfig(**kw)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, seed=0))
    jn = JC._leaf_names({"params": tree, "velocity": tree})[0]
    p = T.params_from_jax(tree, "cpu")
    pn, leaves, _ = PC._leaf_names({"params": p,
                                    "velocity": T.init_velocity(p)})
    assert pn == jn
    tmpl = PC._leaf_names({"params": T._param_template(T.TransformerConfig(
        **kw)), "velocity": p})[1]
    assert [tuple(t.shape) for t in tmpl] == [tuple(t.shape)
                                              for t in leaves]


SCHED = {"const": 0.01,
         "sched": optax.warmup_cosine_decay_schedule(0.0, 0.01, 1, 10)}
SCHED_PORT = {"const": 0.01,
              "sched": PTR.warmup_cosine_decay_schedule(0.0, 0.01, 1, 10)}


def _states(arch, shape, name, clip, sched):
    """JAX's ``{"params", "opt_state"}`` and the port's, over the same
    initial weights."""
    params = PF.init(arch, shape, seed=0).params
    jtx = JTR.make_optimizer(name, SCHED[sched], clip_norm=clip)
    jstate = {"params": params, "opt_state": jtx.init(params)}
    ptx = PTR.make_optimizer(name, SCHED_PORT[sched], clip_norm=clip)
    net = PF(arch=arch, params=params).to_module("cpu")
    step = PTR.NNLearner().build_train_step(
        net, ptx, PTR.make_loss("softmax_cross_entropy"))
    return jstate, PTR.NNLearner._state_tree(net, step, ptx)


@pytest.mark.parametrize("sched", sorted(SCHED))
@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", PTR.OPTIMIZERS)
def test_learner_state_leaf_names_are_jaxs(name, clip, sched):
    jstate, pstate = _states(MLP, (5,), name, clip, sched)
    jn, jl, _ = JC._leaf_names(jstate)
    pn, pl, _ = PC._leaf_names(pstate)
    assert pn == jn
    for a, b in zip(jl, pl):
        assert tuple(np.shape(a)) == tuple(b.shape)
        assert np.asarray(a).dtype.str == PC._dtype_token(PC._leaf_dtype(b))
    # the weights in the flax layout, as JAX holds them
    for n, a, b in zip(jn, jl, pl):
        if ".params." in n:
            np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_conv_state_is_in_the_flax_layout():
    jstate, pstate = _states(CNN, (8, 8, 3), "momentum", 0.0, "sched")
    jn, jl, _ = JC._leaf_names(jstate)
    pn, pl, _ = PC._leaf_names(pstate)
    assert pn == jn
    for n, a, b in zip(jn, jl, pl):
        assert tuple(np.shape(a)) == tuple(b.shape), n
        if ".params." in n:
            np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


# -- crossing the packages ----------------------------------------------------

def test_jax_written_2x2_tree_restores_bit_exact_in_the_port(tmp_path):
    tree = mixed_tree()
    path = str(tmp_path / "jax")
    JC.save_sharded(path, JD.shard_state(
        tree, JD.train_mesh({"data": 2, "model": 2})), extra={"step": 1})
    ptree = jax.tree.map(as_torch, tree)
    whole = PC.restore_sharded(path, ptree, strict_digest=True)
    mesh = hosted({"data": 2, "model": 2})
    placed = PD.shard_state(ptree, mesh)
    sharded = PC.restore_sharded(path, placed, mesh=mesh)
    for a, b, c in zip(jax.tree.leaves(tree), PC._leaf_names(whole)[1],
                       PC._leaf_names(sharded)[1]):
        assert b.dtype == as_torch(a).dtype
        np.testing.assert_array_equal(bits(b), bits(a))
        np.testing.assert_array_equal(bits(c), bits(a))
    # the model-split leaves come back as the mesh's slices
    assert isinstance(sharded["w"], PD.Shards)
    assert [tuple(p.shape) for p in sharded["w"].parts] == [(32, 32)] * 2
    assert isinstance(sharded["wb"], PD.Shards)


def test_port_written_plain_shards_and_bf16_restore_bit_exact_in_jax(
        tmp_path):
    tree = mixed_tree(1)
    ptree = jax.tree.map(as_torch, tree)
    plain = str(tmp_path / "plain")
    PC.save_sharded(plain, ptree)
    split = str(tmp_path / "split")
    PC.save_sharded(split, PD.shard_state(ptree,
                                          hosted({"data": 2, "model": 2})))
    for path in (plain, split):
        for shardings in (None, JD.state_shardings(
                tree, JD.train_mesh({"data": 1, "model": 2}))):
            r = JC.restore_sharded(path, tree, shardings=shardings,
                                   strict_digest=True)
            for a, b in zip(jax.tree.leaves(r), jax.tree.leaves(tree)):
                assert np.asarray(a).dtype == b.dtype
                np.testing.assert_array_equal(bits(np.asarray(a)), bits(b))
    assert json.load(open(os.path.join(split, "index.json")))["leaves"][
        "leaf00003.w"]["shards"][1]["index"] == [[32, 64], [0, 32]]


def test_index_and_files_equal_and_digests_cross_verify(tmp_path):
    tree = mixed_tree(2)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    JC.save_sharded(jpath, JD.shard_state(
        tree, JD.train_mesh({"data": 2, "model": 2})), extra={"step": 7})
    PC.save_sharded(ppath, PD.shard_state(
        jax.tree.map(as_torch, tree), hosted({"data": 2, "model": 2})),
        extra={"step": 7})
    with open(os.path.join(jpath, "index.json")) as f:
        ji = json.load(f)
    with open(os.path.join(ppath, "index.json")) as f:
        pi = json.load(f)
    assert sorted(ji["leaves"]) == sorted(pi["leaves"])
    for name in ji["leaves"]:
        assert ji["leaves"][name] == pi["leaves"][name], name
    assert ji == pi
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(ppath))
    for name in os.listdir(jpath):
        with open(os.path.join(jpath, name), "rb") as a, \
                open(os.path.join(ppath, name), "rb") as b:
            assert a.read() == b.read(), name
    for path in (jpath, ppath):
        assert PC.verify_digest(path, strict=True) == (True, None)
        assert JC.verify_digest(path, strict=True) == (True, None)


def test_restore_onto_a_device_and_dtype_checks(tmp_path):
    tree = jax.tree.map(as_torch, mixed_tree(3))
    path = str(tmp_path / "ck")
    PC.save_sharded(path, tree)
    meta = PC.map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), tree)
    r = PC.restore_sharded(path, meta, device="cpu")
    assert r["wb"].dtype == torch.bfloat16 and r["i"].dtype == torch.int32
    assert torch.equal(r["wb"].view(torch.int16),
                       tree["wb"].view(torch.int16))
    # the restored tensors hold their own memory
    assert r["w"].data_ptr() != tree["w"].data_ptr()
    wrong = dict(meta, w=torch.empty((64, 32), dtype=torch.float16,
                                     device="meta"))
    with pytest.raises(PC.CheckpointIntegrityError, match="dtype"):
        PC.restore_sharded(path, wrong)
    with pytest.raises(PC.CheckpointIntegrityError, match="shape"):
        PC.restore_sharded(path, dict(meta, b=torch.empty(
            (31,), device="meta")))


def test_ordered_dict_leaves_cross_both_packages(tmp_path):
    """An ``OrderedDict`` flattens in insertion order in both packages
    (a plain dict and a ``defaultdict`` by sorted key): the same file
    names and ``index.json`` from either save, the values restored in
    the other, and the template's mapping type rebuilt."""
    rng = np.random.default_rng(5)
    z = rng.normal(size=(4, 3)).astype(np.float32)
    a = rng.normal(size=(5,)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    extra = rng.normal(size=(3,)).astype(np.float32)

    def tree(conv):
        dd = collections.defaultdict(list, {"y": conv(b), "x": conv(extra)})
        return {"p": collections.OrderedDict(z=conv(z), a=conv(a)),
                "d": dd}

    jtree, ptree = tree(np.asarray), tree(as_torch)
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    JC.save_sharded(jpath, jtree, extra={"step": 3})
    PC.save_sharded(ppath, ptree, extra={"step": 3})
    names = ["leaf00000.d.x", "leaf00001.d.y", "leaf00002.p.z",
             "leaf00003.p.a"]
    assert PC._leaf_names(ptree)[0] == names
    assert JC._leaf_names(jtree)[0] == names
    with open(os.path.join(jpath, "index.json")) as f:
        ji = json.load(f)
    with open(os.path.join(ppath, "index.json")) as f:
        pi = json.load(f)
    assert ji == pi
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(ppath))
    for name in os.listdir(jpath):
        with open(os.path.join(jpath, name), "rb") as fa, \
                open(os.path.join(ppath, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    from_jax = PC.restore_sharded(jpath, ptree, strict_digest=True)
    from_port = JC.restore_sharded(ppath, jtree, strict_digest=True)
    assert type(from_jax["p"]) is collections.OrderedDict
    assert list(from_jax["p"]) == ["z", "a"]
    assert type(from_jax["d"]) is collections.defaultdict
    assert from_jax["d"].default_factory is list
    for want, got in ((z, from_jax["p"]["z"]), (a, from_jax["p"]["a"]),
                      (b, from_jax["d"]["y"]), (extra, from_jax["d"]["x"])):
        np.testing.assert_array_equal(bits(got), bits(want))
    for want, got in ((z, from_port["p"]["z"]), (a, from_port["p"]["a"]),
                      (b, from_port["d"]["y"])):
        np.testing.assert_array_equal(bits(np.asarray(got)), bits(want))


# -- the store's cases (tests/test_dist.py) ----------------------------------

def _tree(rng):
    return {"w": torch.from_numpy(rng.normal(size=(64, 32))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(32,)).astype(np.float32)),
            "blocks": [{"k": torch.from_numpy(rng.normal(size=(16, 8))
                                              .astype(np.float32))}]}


def test_save_2x2_restore_4x1_and_single(rng, tmp_path):
    tree = _tree(rng)
    mngr = PC.manager(str(tmp_path / "ck"))
    mngr.save(3, PD.shard_state(tree, hosted({"data": 2, "model": 2})))
    ok, detail = PC.verify_digest(mngr._step_dir(3), strict=True)
    assert ok, detail
    for shape in ({"data": 4}, {"data": 1}, {"data": 2, "model": 4}):
        placed = PD.shard_state(tree, hosted(shape))
        r = mngr.restore(3, placed, strict_digest=True)
        for a, b in zip(PC._leaf_names(r)[1], PC._leaf_names(tree)[1]):
            assert torch.equal(PD.gathered(a), b)
    host = mngr.restore(3, tree)
    assert torch.equal(host["b"], tree["b"])


def test_interrupted_save_is_invisible(rng, tmp_path):
    tree = _tree(rng)
    mngr = PC.manager(str(tmp_path / "ck"))
    mngr.save(1, tree)
    part = mngr._step_dir(2)
    os.makedirs(part)
    with open(os.path.join(part, "leaf00000.b~0.npy"), "wb") as f:
        np.save(f, tree["b"].numpy())
    assert mngr.all_steps() == [1]
    assert mngr.latest_step() == 1


def test_corrupt_shard_detected(rng, tmp_path):
    tree = _tree(rng)
    mngr = PC.manager(str(tmp_path / "ck"))
    mngr.save(1, PD.shard_state(tree, hosted({"data": 2, "model": 2})))
    step_dir = mngr._step_dir(1)
    victim = next(f for f in sorted(os.listdir(step_dir))
                  if f.endswith(".npy"))
    with open(os.path.join(step_dir, victim), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(PC.CheckpointIntegrityError, match="digest"):
        mngr.restore(1, tree)
    # JAX sees the same corruption
    with pytest.raises(JC.CheckpointIntegrityError):
        JC.restore_sharded(step_dir, jax.tree.map(np.asarray, tree))


def test_strict_refuses_digestless_legacy(rng, tmp_path):
    tree = _tree(rng)
    mngr = PC.manager(str(tmp_path / "ck"))
    mngr.save(1, tree)
    os.remove(os.path.join(mngr._step_dir(1), PC.MANIFEST_FILE))
    with pytest.raises(PC.CheckpointIntegrityError):
        PC.restore_sharded(mngr._step_dir(1), tree, strict_digest=True)
    # non-strict: a legacy directory loads, unverified
    r = PC.restore_sharded(mngr._step_dir(1), tree)
    assert torch.equal(r["w"], tree["w"])


def test_retention_prunes_old_steps(rng, tmp_path):
    tree = {"x": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))}
    mngr = PC.manager(str(tmp_path / "ck"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mngr.save(s, tree)
    assert mngr.all_steps() == [3, 4]
    assert JC.manager(str(tmp_path / "ck")).all_steps() == [3, 4]


def test_remote_paths_refused_loudly():
    with pytest.raises(NotImplementedError, match="local"):
        PC.manager("gs://bucket/run")


def test_save_sweeps_older_interrupted_partials(rng, tmp_path):
    tree = {"x": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))}
    mngr = PC.manager(str(tmp_path / "ck"))
    mngr.save(5, tree)
    for step in (2, 9):
        part = mngr._step_dir(step)
        os.makedirs(part)
        with open(os.path.join(part, "leaf00000.x~0.npy"), "wb") as f:
            np.save(f, tree["x"].numpy())
    mngr.save(7, tree)
    assert not os.path.exists(mngr._step_dir(2))
    assert os.path.exists(mngr._step_dir(9))
    assert mngr.all_steps() == [5, 7]


def test_missing_checkpoint_raises(tmp_path):
    cfg = T.TransformerConfig(**DENSE)
    with pytest.raises(FileNotFoundError):
        T.restore_train_state(str(tmp_path / "nothing"), cfg, device="cpu")
    PC.manager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        T.restore_train_state(str(tmp_path / "empty"), cfg, device="cpu")


def test_restore_onto_the_card_raises_without_cuda(tmp_path, monkeypatch):
    cfg = T.TransformerConfig(**DENSE)
    p = T.params_from_jax(T.init_params_np(cfg), "cpu")
    T.save_train_state(str(tmp_path / "ck"), p, T.init_velocity(p), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.restore_train_state(str(tmp_path / "ck"), cfg)


# -- two processes, one directory ---------------------------------------------

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
from mmlspark_tpu_torch.io import checkpoint as C
from mmlspark_tpu_torch.parallel import topology as TP
mesh = TP.build_mesh(TP.MeshSpec.from_dict({"model": 2}), "cpu")
rng = np.random.default_rng(123)
w = rng.normal(size=(64, 32)).astype(np.float32)
b = rng.normal(size=(32,)).astype(np.float32)
wb = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)).to(
    torch.bfloat16)
tree = {"w": torch.from_numpy(w[rank * 32:(rank + 1) * 32]),
        "b": torch.from_numpy(b), "wb": wb[:, rank * 3:(rank + 1) * 3]}
specs = {"w": ("model", None), "b": (), "wb": (None, "model")}
C.manager(out).save(3, tree, specs=specs, mesh=mesh)
dist.destroy_process_group()
print(f"RANK{rank}_SAVED", flush=True)
"""


def test_two_process_save_restores_in_one_process(tmp_path):
    out = str(tmp_path / "ck2p")
    init = f"file://{tmp_path / 'rdv'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), init, out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK{r}_SAVED" in o, o[-3000:]
    rng = np.random.default_rng(123)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    wb = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)).to(
        torch.bfloat16)
    step_dir = PC.manager(out)._step_dir(3)
    index = PC.read_index(step_dir)
    # each model slice written once, by the rank that holds it
    assert [s["index"] for s in index["leaves"]["leaf00001.w"]["shards"]] \
        == [[[0, 32], [0, 32]], [[32, 64], [0, 32]]]
    assert not [f for f in os.listdir(step_dir) if "host_marker" in f]
    r = PC.manager(out).restore(None, {"w": w, "b": b, "wb": wb},
                                strict_digest=True)
    np.testing.assert_array_equal(r["w"].numpy(), w)
    np.testing.assert_array_equal(r["b"].numpy(), b)
    assert torch.equal(r["wb"].view(torch.int16), wb.view(torch.int16))
    jwb = wb.float().numpy().astype(ml_dtypes.bfloat16)
    j = JC.restore_sharded(step_dir, {"w": w, "b": b, "wb": jwb},
                           strict_digest=True)
    np.testing.assert_array_equal(np.asarray(j["w"]), w)
    np.testing.assert_array_equal(bits(np.asarray(j["wb"])), bits(jwb))


# -- train state: resume across meshes ---------------------------------------

CFG = dict(DENSE, layers_per_stage=2)
B, S = 8, 16


def _batch(cfg):
    return T.make_batch(np.random.default_rng(2), cfg, B, S, device="cpu")


def _run(cfg, mesh, params, vel, n):
    step = T.build_spmd_train_step(cfg, mesh, 0.1, 0.9)
    tokens, labels, mask = _batch(cfg)
    loss = None
    for _ in range(n):
        params, vel, loss = step(params, vel, tokens, labels, mask)
    return params, vel, float(loss)


def test_checkpoint_resume_across_meshes(tmp_path):
    cfg = T.TransformerConfig(**CFG)
    mesh_a = hosted({"data": 2, "model": 2})
    p0 = T.init_params_np(cfg, seed=0)
    sp, sv, _ = _run(cfg, mesh_a, T.shard_params(p0, cfg, mesh_a),
                     T.shard_params(jax.tree.map(np.zeros_like, p0), cfg,
                                    mesh_a), 2)
    path = str(tmp_path / "ckpt")
    T.save_train_state(path, sp, sv, step=2, cfg=cfg, mesh=mesh_a)
    # the model-split leaves were written one file per slice, as JAX's
    index = PC.read_index(PC.manager(path)._step_dir(2))
    assert len(index["leaves"]["leaf00000.params.blocks.0.b1"]["shards"]) \
        == 2
    saved = T.params_to_numpy(sp)
    _, _, loss_ref = _run(cfg, mesh_a, sp, sv, 2)
    for shape in ({"data": 4}, {"data": 2, "model": 2}):
        mesh_b = hosted(shape)
        rp, rv, at = T.restore_train_state(path, cfg, mesh_b)
        assert at == 2
        for a, b in zip(jax.tree.leaves(T.params_to_numpy(rp)),
                        jax.tree.leaves(saved)):
            np.testing.assert_array_equal(a, b)
        _, _, loss_res = _run(cfg, mesh_b, rp, rv, 2)
        assert abs(loss_res - loss_ref) < 2e-5, (shape, loss_res, loss_ref)


@functools.lru_cache(maxsize=None)
def _jax_saved(path):
    """JAX: 2 steps on ``{"data": 2, "model": 2}``, saved, then 2 more
    (the uninterrupted run's loss)."""
    jcfg = JT.TransformerConfig(**CFG)
    tokens, labels, mask = JT.make_batch(np.random.default_rng(2), jcfg,
                                         B, S)
    mesh = submesh({"data": 2, "model": 2})
    step = JT.build_spmd_train_step(jcfg, mesh, 0.1, 0.9)
    p0 = JT.init_params(jcfg, seed=0)
    p = JT.shard_params(p0, jcfg, mesh)
    v = JT.shard_params(jax.tree.map(jnp.zeros_like, p0), jcfg, mesh)
    for _ in range(2):
        p, v, _ = step(p, v, tokens, labels, mask)
    JT.save_train_state(path, p, v, step=2)
    for _ in range(2):
        p, v, loss = step(p, v, tokens, labels, mask)
    return float(loss)


def test_jax_saved_train_state_resumes_in_the_port(tmp_path):
    path = str(tmp_path / "jax_ckpt")
    loss_ref = _jax_saved(path)
    cfg = T.TransformerConfig(**CFG)
    rp, rv, at = T.restore_train_state(path, cfg, device="cpu")
    assert at == 2
    step = T.build_train_step(cfg, 0.1, 0.9, device="cpu")
    tokens, labels, mask = _batch(cfg)
    for _ in range(2):
        rp, rv, loss = step(rp, rv, tokens, labels, mask)
    assert abs(float(loss) - loss_ref) < 2e-5, (float(loss), loss_ref)
    # and the port's save of the resumed state reads back in JAX
    T.save_train_state(str(tmp_path / "port_ckpt"), rp, rv, step=4)
    jcfg = JT.TransformerConfig(**CFG)
    jp, jv, jat = JT.restore_train_state(str(tmp_path / "port_ckpt"), jcfg,
                                         submesh({"data": 1}))
    assert jat == 4
    for a, b in zip(jax.tree.leaves(jax.device_get(jp)),
                    jax.tree.leaves(T.params_to_numpy(rp))):
        np.testing.assert_array_equal(np.asarray(a), b)
