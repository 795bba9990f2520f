"""The port's train step over the model, pipe and expert axes against the
JAX package, on the CPU.

The meshes are ``tests/test_transformer.py``'s ``TestSpmdTrainStep``
cases: ``{"model": 2}`` (tensor parallelism), ``{"pipe": 2}`` with
``n_stages=2, microbatches=2`` (the GPipe schedule), the 5-axis mesh
``{"data": 1, "seq": 2, "model": 2, "expert": 1, "pipe": 2}`` with two
experts, and ``{"data": 2, "model": 2, "pipe": 2}``. The port runs them
hosted (every rank in this process), on the JAX ``init_params`` tree
carried across as numpy and the ``make_batch`` draws; JAX runs its
``build_spmd_train_step(impl="shard_map")`` on the 8-device CPU mesh,
jitted. Both are held to JAX's ``_compare`` golden (two steps of
``jax.value_and_grad(reference_loss)`` and momentum SGD, lr 0.1, 0.9)
and to each other, at ``_compare``'s tolerances: 2e-5 on the loss and
2e-4 on every parameter leaf.

bf16 on ``{"model": 2, "pipe": 2}`` is held against JAX's bf16 step at
the tolerances of ``tests/test_torch_spmd_train.py``'s bf16 case (loss
1e-4, parameters 5e-4 after two steps): the same values round at the
same points, and f32 sums in another order before a bf16 rounding move
a value by an ulp now and then.

Two gloo processes (``mmlspark_tpu_torch.testing.mesh_train``, a file
rendezvous under the test's tmp dir) run ``{"model": 2}``, ``{"pipe":
2}`` and ``{"expert": 2}`` (capacity dispatch through the per-process
``all_to_all``, and dense dispatch, both with the aux and the z-loss)
one rank per process; each rank's losses and gathered parameters must
equal the hosted runs' within 1e-6, and each process must hold only its
shards' bytes. Four gloo processes compose two axes at a time.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.parallel.topology import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.topology import build_mesh as jbuild_mesh
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel import topology as TP
from mmlspark_tpu_torch.testing import mesh_train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DENSE = dict(vocab=64, d_model=16, n_heads=4, d_head=8, d_ff=32)
B, S = 8, 16
LR, MOM = 0.1, 0.9
STEPS = 2
LOSS_TOL, PARAM_TOL = 2e-5, 2e-4
BF16_LOSS_TOL, BF16_PARAM_TOL = 1e-4, 5e-4
FIVE_AXIS = {"data": 1, "seq": 2, "model": 2, "expert": 1, "pipe": 2}

#: mesh id -> (mesh shape, config fields): TestSpmdTrainStep's cases
CASES = {
    "model2": ({"model": 2}, dict(DENSE, layers_per_stage=2)),
    "pipe2": ({"pipe": 2}, dict(DENSE, n_stages=2, microbatches=2)),
    "five_axis_moe": (FIVE_AXIS, dict(DENSE, n_stages=2, n_experts=2,
                                      microbatches=2)),
    "data2_model2_pipe2": ({"data": 2, "model": 2, "pipe": 2},
                           dict(DENSE, n_stages=2, microbatches=2)),
}


def submesh(shape):
    n = int(np.prod(list(shape.values())))
    return jbuild_mesh(JMeshSpec.from_dict(shape), devices=jax.devices()[:n])


def hosted(shape):
    return TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")


def _max_leaf_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                               strict=True))


@functools.lru_cache(maxsize=None)
def _tree(kw_items):
    return jax.tree.map(np.asarray, JT.init_params(
        JT.TransformerConfig(**dict(kw_items)), seed=0))


def _jbatch(jcfg, rng_seed=1):
    return JT.make_batch(np.random.default_rng(rng_seed), jcfg, B, S)


@functools.lru_cache(maxsize=None)
def _golden(kw_items):
    """``_compare``'s golden: reference_loss's exact gradient steps."""
    jcfg = JT.TransformerConfig(**dict(kw_items))
    tokens, labels, mask = _jbatch(jcfg)
    vg = jax.jit(jax.value_and_grad(JT.reference_loss), static_argnums=4)
    p = jax.tree.map(jnp.asarray, _tree(kw_items))
    v = jax.tree.map(jnp.zeros_like, p)
    losses = []
    for _ in range(STEPS):
        loss, g = vg(p, tokens, labels, mask, jcfg)
        v = jax.tree.map(lambda a, gr: MOM * a + gr, v, g)
        p = jax.tree.map(lambda a, b: a - LR * b, p, v)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _jax_steps(shape_items, kw_items, steps=STEPS, rng_seed=1):
    """JAX's own shard_map step on the CPU mesh."""
    jcfg = JT.TransformerConfig(**dict(kw_items))
    tokens, labels, mask = _jbatch(jcfg, rng_seed)
    mesh = submesh(dict(shape_items))
    step = JT.build_spmd_train_step(jcfg, mesh, LR, MOM, donate=False,
                                    impl="shard_map")
    tree = _tree(tuple((k, v) for k, v in kw_items if k != "dtype"
                       and k != "attention_impl"))
    p = JT.shard_params(jax.tree.map(jnp.asarray, tree), jcfg, mesh)
    v = JT.shard_params(jax.tree.map(jnp.zeros_like, tree), jcfg, mesh)
    losses = []
    for _ in range(steps):
        p, v, loss = step(p, v, tokens, labels, mask)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(p))


def _port_steps(shape, kw, steps=STEPS, rng_seed=1, tree=None):
    cfg = T.TransformerConfig(**kw)
    mesh = hosted(shape)
    tree = tree if tree is not None else _tree(tuple(
        (k, v) for k, v in kw.items() if k not in ("dtype",
                                                   "attention_impl")))
    params = T.shard_params(tree, cfg, mesh)
    velocity = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    batch = T.make_batch(np.random.default_rng(rng_seed), cfg, B, S, "cpu")
    losses = [float(step(params, velocity, *batch)[2]) for _ in range(steps)]
    return losses, T.params_to_numpy(params)


def _items(d):
    return tuple(sorted(d.items()))


@pytest.mark.parametrize("case", list(CASES))
def test_hosted_steps_match_jax_spmd_and_golden(case):
    shape, kw = CASES[case]
    losses, params = _port_steps(shape, kw)
    jl, jp = _jax_steps(_items(shape), _items(kw))
    gl, gp = _golden(_items(kw))
    assert abs(losses[-1] - jl[-1]) < LOSS_TOL
    np.testing.assert_allclose(losses, jl, atol=LOSS_TOL, rtol=0)
    assert _max_leaf_diff(params, jp) < PARAM_TOL
    # JAX's _compare: the last step's loss and the updated parameters
    assert abs(losses[-1] - gl[-1]) < LOSS_TOL
    assert abs(jl[-1] - gl[-1]) < LOSS_TOL
    assert _max_leaf_diff(params, gp) < PARAM_TOL
    assert _max_leaf_diff(jp, gp) < PARAM_TOL


def test_loss_decreases_on_data_model_pipe():
    """JAX's ``test_loss_decreases``: five steps on ``{"data": 2, "model":
    2, "pipe": 2}``, the batch of rng 3; the port's losses equal JAX's."""
    shape, kw = CASES["data2_model2_pipe2"]
    losses, _ = _port_steps(shape, kw, steps=5, rng_seed=3)
    jl, _ = _jax_steps(_items(shape), _items(kw), steps=5, rng_seed=3)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jl, atol=LOSS_TOL, rtol=0)


def test_bf16_model_pipe_matches_jax_spmd_step():
    """bf16 with dense attention, JAX's engine on the CPU: the model
    ranks' partial products round to bf16 before their f32 sum, as
    JAX's ``psum`` of bf16 einsum outputs."""
    kw = dict(DENSE, n_stages=2, microbatches=2, layers_per_stage=2,
              dtype="bfloat16", attention_impl="dense")
    shape = {"model": 2, "pipe": 2}
    losses, params = _port_steps(shape, kw)
    jl, jp = _jax_steps(_items(shape), _items(kw))
    np.testing.assert_allclose(losses, jl, atol=BF16_LOSS_TOL, rtol=0)
    assert _max_leaf_diff(params, jp) < BF16_PARAM_TOL


def test_model_ranks_fold_into_one_attention_call(monkeypatch):
    """Hosted, K7 (its plain version on the CPU) is called once a layer a
    tick with every model rank's heads in its batch: H / t heads, B / m x
    t rows."""
    calls = []
    folded = CA.flash_attention_folded

    def spy(q, k, v, causal=True, scale=None):
        calls.append(tuple(q.shape))
        return folded(q, k, v, causal, scale)

    monkeypatch.setattr(CA, "flash_attention_folded", spy)
    kw = dict(DENSE, n_stages=2, microbatches=2, layers_per_stage=2,
              attention_impl="folded")
    cfg = T.TransformerConfig(**kw)
    mesh = hosted({"model": 2, "pipe": 2})
    params = T.shard_params(_tree(_items(dict(
        DENSE, n_stages=2, microbatches=2, layers_per_stage=2))), cfg, mesh)
    batch = T.make_batch(np.random.default_rng(1), cfg, B, 128, "cpu")
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    step(params, T.init_velocity(params), *batch)
    ticks = cfg.microbatches + cfg.n_stages - 1
    # two pipe ranks x two model ranks x B / m rows, 4 / 2 heads each
    assert calls == [(2 * 2 * B // 2, 128, 2, 8)] * (
        ticks * cfg.layers_per_stage)


def test_pipe_stats_count_only_real_ticks():
    """MoE aux and z-loss through the GPipe loop: the fill and drain ticks
    carry garbage and must not count (JAX's ``real`` mask), so the hosted
    loss equals the unsharded ``reference_loss``."""
    kw = dict(DENSE, n_stages=2, n_experts=2, microbatches=2,
              moe_aux_weight=0.02, moe_zloss_weight=0.01)
    cfg = T.TransformerConfig(**kw)
    tree = _tree(_items(kw))
    batch = T.make_batch(np.random.default_rng(1), cfg, B, S, "cpu")
    mesh = hosted(FIVE_AXIS)
    params = T.shard_params(tree, cfg, mesh)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    got = float(step(params, T.init_velocity(params), *batch)[2])
    with torch.no_grad():
        want = float(T.reference_loss(T.params_from_jax(tree, "cpu"),
                                      *batch, cfg))
    assert abs(got - want) < 1e-5


def test_full_spmd_meshspec_matches_jax():
    for n in (1, 2, 8, 32):
        assert (TP.MeshSpec.full_spmd(n).resolve(n)
                == JMeshSpec.full_spmd(n).resolve(n))
    assert TP.MeshSpec.full_spmd(8).resolve(8) == FIVE_AXIS


def test_param_specs_match_jax_on_the_five_axis_mesh():
    kw = CASES["five_axis_moe"][1]
    specs = T.param_specs(T.TransformerConfig(**kw), hosted(FIVE_AXIS))
    want = JT.param_specs(JT.TransformerConfig(**kw), submesh(FIVE_AXIS))
    assert specs.keys() == want.keys()
    for bp, wp in zip(specs["blocks"], want["blocks"], strict=True):
        assert bp == {k: tuple(v) for k, v in wp.items()}


# -- validation ---------------------------------------------------------------

@pytest.mark.parametrize("kw,shape,exc,match", [
    (dict(DENSE, n_heads=3), {"model": 2}, ValueError,
     "n_heads must divide over the model axis"),
    (dict(DENSE, d_ff=33), {"model": 2}, ValueError,
     "d_ff must divide over the model axis"),
    (dict(DENSE, n_stages=2), {"pipe": 4}, ValueError,
     "n_stages=2 != pipe axis size 4"),
    (dict(DENSE, n_stages=2), {"data": 2}, ValueError,
     "n_stages > 1 requires a 'pipe' mesh axis"),
], ids=["heads", "d_ff", "stages_vs_pipe", "stages_without_pipe"])
def test_mesh_config_mismatches_raise(kw, shape, exc, match):
    with pytest.raises(exc, match=match):
        T.build_spmd_train_step(T.TransformerConfig(**kw), hosted(shape))


def test_pjit_is_refused_and_impl_is_checked(monkeypatch):
    """``impl="pjit"`` builds on a hosted mesh (its parity:
    ``tests/test_torch_pjit.py``) and one rank per process (its runs:
    ``tests/test_torch_process_axes.py``); an unknown impl raises, and
    "auto" and "shard_map" build."""
    cfg = T.TransformerConfig(**DENSE)
    assert callable(T.build_spmd_train_step(cfg, hosted({"model": 2}),
                                            impl="pjit"))
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "get_rank", lambda *a: 0)
        m.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        per_process = TP.Mesh({"model": 2}, torch.device("cpu"),
                              hosted=False)
        assert callable(T.build_spmd_train_step(cfg, per_process,
                                                impl="pjit"))
    with pytest.raises(ValueError, match="unknown train-step impl"):
        T.build_spmd_train_step(cfg, hosted({"model": 2}), impl="gspmd")
    for impl in ("auto", "shard_map"):
        T.build_spmd_train_step(cfg, hosted({"model": 2}), impl=impl)


def test_mixed_forms_and_smaller_meshes_raise(monkeypatch):
    """A mesh with fewer ranks than processes raises ``ValueError``, as the
    JAX ``build_mesh`` does across processes; several processes each
    hosting several ranks (the mixed form) build, each process its
    contiguous block of ranks (their runs:
    ``tests/test_torch_process_axes.py``)."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 3)
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks: None)
    with pytest.raises(ValueError, match="multi-process world has 4"):
        TP.build_mesh(TP.MeshSpec.from_dict({"model": 2}), "cpu")
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"model": 2, "pipe": 4}),
                         "cpu")
    assert mesh.mixed and mesh.ranks == [6, 7]
    assert mesh.hosted_shape == {"model": 1, "pipe": 2}


# -- one rank per process over gloo ------------------------------------------

GLOO = {
    "model=2": dict(mesh_train.SMALL),
    "pipe=2": dict(mesh_train.SMALL, layers_per_stage=1, n_stages=2,
                   microbatches=2),
    "expert=2": dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32,
                     layers_per_stage=2, n_experts=4, moe_top_k=2,
                     moe_capacity_factor=4.0, moe_aux_weight=0.02,
                     moe_zloss_weight=0.01),
}
#: dense dispatch on the expert axis, as a second mesh of its own
DENSE_EXPERT = ("expert=2,data=1", dict(GLOO["expert=2"],
                                        moe_capacity_factor=0.0))


def _shard_bytes(cfg, shape) -> int:
    """The bytes one rank holds: each leaf over the sizes of the axes its
    spec names."""
    mesh = hosted(shape)
    specs = T.param_specs(cfg, mesh)
    tree = T.init_params_np(cfg)
    total = 0
    for name in ("embed", "head", "final_norm"):
        total += tree[name].nbytes
    for bp, sp in zip(tree["blocks"], specs["blocks"], strict=True):
        for k, v in bp.items():
            total += v.nbytes // int(np.prod(
                [mesh.shape[a] for a in sp[k] if a is not None] or [1]))
    return total


def _gloo_runs(tmp_path, meshes, world):
    """``meshes`` (mesh argument -> config fields) run by ``world`` gloo
    processes of ``mesh_train``, one rank each, and on hosted meshes in
    this process: each rank's saved arrays, the hosted ones, the configs
    and the mesh shapes."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    args = sum((["--mesh", m, "--cfg", json.dumps(kw)]
                for m, kw in meshes.items()), [])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.mesh_train",
         "--init", f"file://{tmp_path / 'rendezvous'}", "--world",
         str(world), "--rank", str(r), *args,
         "--out", str(tmp_path / f"rank{r}.npz")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the gloo ranks did not finish within 180 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    cfgs = [dataclasses.replace(T.TransformerConfig(), **kw)
            for kw in meshes.values()]
    shapes = [mesh_train.parse_mesh(m) for m in meshes]
    want = mesh_train.run(cfgs, shapes, steps=STEPS)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for r, g in enumerate(got):
        assert sorted(g.files) == sorted(want)
        for key, value in want.items():
            if not key.endswith("/param_bytes"):
                np.testing.assert_allclose(g[key], value, atol=1e-6, rtol=0,
                                           err_msg=f"rank {r} {key}")
    return got, want, cfgs, shapes


def test_gloo_model_pipe_and_expert_ranks_equal_the_hosted_mesh(tmp_path):
    meshes = dict(GLOO, **dict([DENSE_EXPERT]))
    got, want, cfgs, shapes = _gloo_runs(tmp_path, meshes, 2)
    for g in got:
        for m, cfg, shape in zip(meshes, cfgs, shapes):
            key = mesh_train.mesh_key(shape)
            held = int(g[f"{key}/param_bytes"])
            assert held == _shard_bytes(cfg, shape), m
            assert held < int(want[f"{key}/param_bytes"]), m


def test_gloo_four_ranks_compose_the_axes(tmp_path):
    """Four gloo processes, two axes of 2 at once: the model axis with the
    pipe (tensor and pipeline parallelism together), with a seq ring and
    with the experts; the pipe beside data with MoE statistics on the
    real ticks only; the experts beside data at a tight capacity. Each
    equals the hosted mesh within 1e-6."""
    pipe = dict(mesh_train.SMALL, layers_per_stage=1, n_stages=2,
                microbatches=2)
    meshes = {"model=2,pipe=2": pipe,
              "data=2,pipe=2": dict(pipe, n_experts=2, moe_aux_weight=0.02,
                                    moe_zloss_weight=0.01),
              "seq=2,model=2": dict(mesh_train.SMALL),
              "model=2,expert=2": dict(mesh_train.SMALL, n_experts=2,
                                       moe_aux_weight=0.02),
              "data=2,expert=2": dict(GLOO["expert=2"],
                                      moe_capacity_factor=1.1)}
    _gloo_runs(tmp_path, meshes, 4)
