"""The port's MoE training (``mmlspark_tpu_torch.models.transformer``)
against the JAX package, on the CPU.

The sizes are ``tests/test_transformer.py``'s MoE sizes; weights are the
JAX ``init_params`` trees carried across as numpy, batches the JAX
``make_batch`` draws, and every other input is drawn from a seeded numpy
generator. JAX's ``local_loss`` and its ``shard_map`` steps run jitted.

Tolerances (f32): the routing building blocks and the capacity engines'
queues, combines and gradients within 1e-6; ``local_loss`` within 1e-5
and its gradient within 1e-5 (every reading so far is under 1e-6 for
the loss and 5e-8 for the gradients); three steps of
``build_spmd_train_step`` against the JAX step within 1e-5 on every loss
and every parameter (readings under 1e-6 and 2e-8). The sort and scatter
engines give identical steps, as JAX's ``test_dispatch_engines_agree``
holds its own: the same routings drop, the same rows reach the same
products, and the rows that differ carry a zero cotangent.
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
from mmlspark_tpu_torch.parallel import collectives as C
from mmlspark_tpu_torch.parallel import topology as TP
from mmlspark_tpu_torch.testing import mesh_train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# tests/test_transformer.py's MoE sizes: local_loss at its expert-parallel
# config, the steps at test_dispatch_engines_agree's
LOSS_KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32,
               layers_per_stage=2, n_experts=4)
STEP_KW = dict(vocab=64, d_model=32, n_heads=2, d_head=16, d_ff=64,
               layers_per_stage=2, n_experts=4, moe_top_k=2,
               moe_capacity_factor=1.1, moe_aux_weight=0.01,
               moe_zloss_weight=1e-3)
NO_AXES = JT._Axes(None, None, None, None, None)
BLOCK_TOL = 1e-6
LOSS_TOL = 1e-5
STEPS, LR, MOM = 3, 0.1, 0.9


def submesh(shape):
    n = int(np.prod(list(shape.values())))
    return jbuild_mesh(JMeshSpec.from_dict(shape), devices=jax.devices()[:n])


def hosted(shape):
    return TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


# ---------------------------------------------------------------------------
# the building blocks


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_top_k_matches_jax(k):
    logits = np.random.default_rng(k).normal(size=(2, 9, 6)).astype(
        np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    jw, ji = JT._route_top_k(probs, k)
    w, i = T._route_top_k(torch.softmax(_t(logits), dim=-1), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=BLOCK_TOL,
                               rtol=0)


def test_route_top_k_ties_pick_the_same_set():
    """Equal probabilities: ``jax.lax.top_k`` lists the lower index first,
    ``torch.topk`` promises no order. The chosen set and the weights
    agree; the order among equals is a documented difference."""
    probs = np.array([[0.1, 0.3, 0.3, 0.0, 0.3]], np.float32)
    jw, ji = JT._route_top_k(jnp.asarray(probs), 2)
    w, i = T._route_top_k(_t(probs), 2)
    assert np.asarray(ji).tolist() == [[1, 2]]
    assert set(i[0].tolist()) <= {1, 2, 4}
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=BLOCK_TOL)


def test_router_stats_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(5), size=40).astype(np.float32)
    top = rng.integers(0, 5, size=40)
    jf, jp = JT._router_stats(jnp.asarray(probs), jnp.asarray(top), 5, ())
    f, p = T._router_stats(_t(probs)[None], _t(top)[None], 5, ())
    np.testing.assert_allclose(f[0].numpy(), np.asarray(jf), atol=BLOCK_TOL)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(jp), atol=BLOCK_TOL)


ENGINES = {"sort": (JT._sorted_capacity_queues, T._sorted_capacity_queues),
           "scatter": (JT._scatter_capacity_queues,
                       T._scatter_capacity_queues)}


@pytest.mark.parametrize("C", [2, 5, 40], ids=["drops", "some", "no_drops"])
@pytest.mark.parametrize("engine", ["sort", "scatter"])
def test_capacity_engine_matches_jax(engine, C):
    """Dispatch, combine and the gradients of a scalar through both, with
    respect to the routing rows, the router weights and the expert
    outputs."""
    E, Tk, d = 4, 24, 6
    rng = np.random.default_rng(C)
    h = rng.normal(size=(Tk, d)).astype(np.float32)
    top = rng.integers(0, E, size=Tk)
    wf = rng.uniform(0.1, 1.0, size=Tk).astype(np.float32)
    y = rng.normal(size=(E, C, d)).astype(np.float32)
    gd = rng.normal(size=(E, C, d)).astype(np.float32)
    gc = rng.normal(size=(Tk, d)).astype(np.float32)
    jeng, peng = ENGINES[engine]

    def jf(h_, wf_, y_):
        disp, comb = jeng(h_, jnp.asarray(top), wf_, E, C, jnp.float32)
        out = comb(y_)
        return jnp.sum(disp * gd) + jnp.sum(out * gc), (disp, out)

    (jv, (jdisp, jout)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(h), jnp.asarray(wf), jnp.asarray(y))
    ph, pw, py = (_t(a)[None].requires_grad_(True) for a in (h, wf, y))
    disp, comb = peng(ph, _t(top)[None], pw, E, C, torch.float32)
    out = comb(py)
    v = (disp * _t(gd)).sum() + (out * _t(gc)).sum()
    pg = torch.autograd.grad(v, (ph, pw, py))
    # the sort engine's queue rows past an expert's count hold the next
    # groups' rows (JAX's too): compare the rows each engine fills
    np.testing.assert_allclose(disp[0].detach().numpy(), np.asarray(jdisp),
                               atol=BLOCK_TOL, rtol=0)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jout),
                               atol=BLOCK_TOL, rtol=0)
    assert abs(float(v.detach()) - float(jv)) < 1e-4
    for name, a, b in zip(("h", "wf", "y"), pg, jg):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b),
                                   atol=BLOCK_TOL, rtol=0, err_msg=name)


def test_all_to_all_matches_jax():
    """The hosted ``all_to_all`` against ``jax.lax.all_to_all(tiled=True)``
    under ``shard_map`` on ``{"data": 2, "expert": 2}``, both ways."""
    from jax.sharding import PartitionSpec as P
    shape = {"data": 2, "expert": 2}
    x = np.random.default_rng(0).normal(size=(4, 4, 3, 2)).astype(
        np.float32)
    spec = P(("data", "expert"))

    def jfn(a, split, concat):
        return jax.jit(jax.shard_map(
            lambda v: jax.lax.all_to_all(v[0], "expert", split, concat,
                                         tiled=True)[None],
            mesh=submesh(shape), in_specs=spec, out_specs=spec))(a)

    ax = hosted(shape).axis("expert")
    there = C.all_to_all(_t(x), ax, 0, 1)
    np.testing.assert_array_equal(there.numpy(), np.asarray(jfn(x, 0, 1)))
    back = C.all_to_all(there, ax, 1, 0)
    np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------------------
# local_loss and its gradient against the JAX local_loss (one device)


LOSS_CASES = {
    "dense_k1": {},
    "dense_k2_aux_z": dict(moe_top_k=2, moe_aux_weight=0.02,
                           moe_zloss_weight=0.01),
    **{f"cap{c}_{e}": dict(moe_top_k=2, moe_capacity_factor=c,
                           moe_dispatch=e, moe_aux_weight=0.01,
                           moe_zloss_weight=1e-3)
       for c in (4.0, 1.1, 0.5) for e in ("sort", "scatter")},
    "cap1.1_no_aux_no_z": dict(moe_top_k=2, moe_capacity_factor=1.1),
    "expert_choice_z": dict(moe_router="expert_choice",
                            moe_capacity_factor=1.0, moe_zloss_weight=0.01),
    "cap1.1_microbatches2": dict(moe_top_k=2, moe_capacity_factor=1.1,
                                 moe_aux_weight=0.01, moe_zloss_weight=1e-3,
                                 microbatches=2),
}


def _loss_batch(cfg):
    return JT.make_batch(np.random.default_rng(1), cfg, 4, 16)


def _jax_local_loss(case):
    # JAX's two capacity engines give bit-identical losses and gradients
    # (its test_dispatch_engines_agree holds its steps so): one reference
    # for both, computed by its sort engine
    kw = dict(LOSS_CASES[case])
    if kw.get("moe_dispatch") == "scatter":
        kw["moe_dispatch"] = "sort"
    return _jax_local_loss_cached(tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_local_loss_cached(case_kw):
    jcfg = JT.TransformerConfig(**LOSS_KW, **dict(case_kw))
    tokens, labels, mask = _loss_batch(jcfg)
    params = JT.init_params(jcfg, seed=0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JT.local_loss(p, tokens, labels, mask, jcfg, NO_AXES)))(
        params)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads),
            [np.asarray(a) for a in (tokens, labels, mask)])


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_local_loss_and_grads_match_jax(case):
    tree, want_loss, want_grads, batch = _jax_local_loss(case)
    cfg = T.TransformerConfig(**LOSS_KW, **LOSS_CASES[case])
    params = T.params_from_jax(tree, "cpu")
    leaves = T._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = T.local_loss(params, *(_t(a) for a in batch), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - want_loss) < LOSS_TOL
    want = T._leaves(T.params_from_jax(want_grads, "cpu"))
    for g, w in zip(grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=LOSS_TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# build_spmd_train_step against the JAX step


MESHES = {"data1": {"data": 1}, "data2": {"data": 2}, "seq2": {"seq": 2},
          "expert2": {"expert": 2}, "data2_expert2": {"data": 2, "expert": 2}}
#: per-rank grouping at a tight capacity, two microbatches a rank
MB_CASE = ("data2_expert2", dict(moe_capacity_factor=0.5, microbatches=2))


def _step_batch(cfg):
    return JT.make_batch(np.random.default_rng(0), cfg, 4, 16)


def _jax_steps(mesh_id, extra=()):
    # one cache key per (mesh, extra), however the caller passes them
    return _jax_steps_cached(mesh_id, tuple(extra))


@functools.lru_cache(maxsize=None)
def _jax_steps_cached(mesh_id, extra):
    jcfg = JT.TransformerConfig(**{**STEP_KW, **dict(extra)})
    mesh = submesh(MESHES[mesh_id])
    params = JT.init_params(jcfg, seed=0)
    tokens, labels, mask = _step_batch(jcfg)
    step = JT.build_spmd_train_step(jcfg, mesh, LR, MOM, donate=False,
                                    impl="shard_map")
    sp = JT.shard_params(params, jcfg, mesh)
    sv = JT.shard_params(jax.tree.map(jnp.zeros_like, params), jcfg, mesh)
    losses = []
    for _ in range(STEPS):
        sp, sv, loss = step(sp, sv, tokens, labels, mask)
        losses.append(float(loss))
    return (jax.tree.map(np.asarray, params), losses,
            jax.tree.map(np.asarray, jax.device_get(sp)))


def _port_steps(mesh_id, tree, steps=STEPS, **kw):
    cfg = T.TransformerConfig(**{**STEP_KW, **kw})
    mesh = hosted(MESHES[mesh_id])
    params = T.shard_params(tree, cfg, mesh)
    velocity = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    batch = [_t(a) for a in _step_batch(cfg)]
    losses = [float(step(params, velocity, *batch)[2]) for _ in range(steps)]
    return losses, T.params_to_numpy(params)


@pytest.mark.parametrize("mesh_id,extra", [
    *((m, ()) for m in MESHES), (MB_CASE[0], tuple(MB_CASE[1].items()))],
    ids=[*MESHES, "data2_expert2_cap0.5_mb2"])
def test_steps_match_jax(mesh_id, extra):
    tree, want_losses, want_params = _jax_steps(mesh_id, extra)
    losses, params = _port_steps(mesh_id, tree, **dict(extra))
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_TOL, rtol=0)
    assert _max_diff(params, want_params) < LOSS_TOL


@pytest.mark.parametrize("mesh_id", ["data1", "data2_expert2"])
def test_sort_and_scatter_steps_are_identical(mesh_id):
    tree = _jax_steps(mesh_id)[0]
    runs = [_port_steps(mesh_id, tree, moe_dispatch=e)
            for e in ("sort", "scatter")]
    assert runs[0][0] == runs[1][0]
    assert _max_diff(runs[0][1], runs[1][1]) == 0.0


def test_dense_dispatch_equals_capacity_4_on_the_expert_axis():
    """No routing drops at capacity 4.0, so the capacity dispatch computes
    dense dispatch's sums (in another order)."""
    tree = _jax_steps("expert2")[0]
    dense = _port_steps("expert2", tree, moe_capacity_factor=0.0)
    cap = _port_steps("expert2", tree, moe_capacity_factor=4.0)
    np.testing.assert_allclose(dense[0], cap[0], atol=LOSS_TOL, rtol=0)
    assert _max_diff(dense[1], cap[1]) < LOSS_TOL


EC_KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32,
             layers_per_stage=2, n_experts=4, moe_router="expert_choice",
             moe_capacity_factor=1.0, moe_zloss_weight=0.01)


@functools.lru_cache(maxsize=None)
def _jax_ec_reference(groups):
    """JAX's ``reference_loss(ec_groups=groups)`` and its gradient at the
    initial weights: ``(tree, batch, loss, grads)`` as numpy."""
    jcfg = JT.TransformerConfig(**EC_KW)
    jp = JT.init_params(jcfg, seed=0)
    batch = JT.make_batch(np.random.default_rng(1), jcfg, 8, 16)
    jv, jg = jax.jit(jax.value_and_grad(JT.reference_loss),
                     static_argnums=(4, 5))(jp, *batch, jcfg, groups)
    return (jax.tree.map(np.asarray, jp), [np.asarray(a) for a in batch],
            float(jv), jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("shape,groups", [({"expert": 2}, 2),
                                          ({"data": 2}, 2),
                                          ({"data": 2, "expert": 2}, 4)],
                         ids=["expert2", "data2", "data2_expert2"])
def test_expert_choice_step_equals_the_grouped_reference(shape, groups):
    """The first step's loss is ``reference_loss(ec_groups)`` at the
    initial weights (JAX's and the port's, which agree with each other
    in value and gradient)."""
    tree, batch, jv, jg = _jax_ec_reference(groups)
    cfg = T.TransformerConfig(**EC_KW)
    params = T.params_from_jax(tree, "cpu")
    leaves = T._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = [_t(a) for a in batch]
    ref = T.reference_loss(params, *batch, cfg, ec_groups=groups)
    grads = torch.autograd.grad(ref, leaves)
    assert abs(float(ref.detach()) - jv) < LOSS_TOL
    want = T._leaves(T.params_from_jax(jg, "cpu"))
    for g, w in zip(grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=LOSS_TOL,
                                   rtol=0)
    mesh = hosted(shape)
    pp = T.shard_params(tree, cfg, mesh)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    loss = float(step(pp, T.init_velocity(pp), *batch)[2])
    assert abs(loss - jv) < LOSS_TOL


def test_reference_logits_and_loss_match_jax():
    """Token-choice top-2 with the aux and the z-loss: the golden model's
    logits and loss, and the loss's gradient."""
    kw = dict(LOSS_KW, moe_top_k=2, moe_aux_weight=0.02,
              moe_zloss_weight=0.01)
    jcfg, cfg = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
    jp = JT.init_params(jcfg, seed=3)
    tokens, labels, mask = JT.make_batch(np.random.default_rng(2), jcfg,
                                         2, 12)
    jlog = jax.jit(JT.reference_logits, static_argnums=2)(jp, tokens, jcfg)
    jv = jax.jit(JT.reference_loss, static_argnums=4)(jp, tokens, labels,
                                                      mask, jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = [_t(a) for a in (tokens, labels, mask)]
    with torch.no_grad():
        logits = T.reference_logits(params, batch[0], cfg)
        loss = T.reference_loss(params, *batch, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=LOSS_TOL, rtol=0)
    assert abs(float(loss) - float(jv)) < LOSS_TOL


def test_param_specs_give_the_experts_the_expert_axis():
    shape = {"data": 2, "expert": 2}
    cfg = T.TransformerConfig(**STEP_KW)
    specs = T.param_specs(cfg, hosted(shape))
    want = JT.param_specs(JT.TransformerConfig(**STEP_KW), submesh(shape))
    for bp, wp in zip(specs["blocks"], want["blocks"], strict=True):
        assert bp.keys() == wp.keys()
        for k, spec in bp.items():
            assert spec == tuple(wp[k]), k
    assert specs["blocks"][0]["ew1"] == (None, "expert", None, None)


# ---------------------------------------------------------------------------
# refusals


def _one_step(cfg, shape, batch=(4, 16)):
    mesh = hosted(shape)
    params = T.shard_params(T.init_params_np(cfg, seed=0), cfg, mesh)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    return step(params, T.init_velocity(params),
                *T.make_batch(np.random.default_rng(0), cfg, *batch, "cpu"))


@pytest.mark.parametrize("kw,match", [
    (dict(moe_router="expert_choice"), "needs moe_capacity_factor > 0"),
    (dict(moe_router="softmax"), "unknown moe_router"),
    (dict(moe_capacity_factor=1.0, moe_dispatch="radix"),
     "unknown moe_dispatch"),
], ids=["expert_choice_without_capacity", "router", "dispatch"])
def test_config_errors(kw, match):
    cfg = T.TransformerConfig(**dict(LOSS_KW, **kw))
    with pytest.raises(ValueError, match=match):
        _one_step(cfg, {"data": 1})


@pytest.mark.parametrize("kw,kind", [
    (dict(moe_capacity_factor=1.0), "capacity MoE dispatch"),
    (dict(moe_router="expert_choice", moe_capacity_factor=1.0),
     "expert-choice MoE"),
], ids=["capacity", "expert_choice"])
def test_tokens_must_divide_over_the_expert_axis(kw, kind):
    cfg = T.TransformerConfig(**dict(LOSS_KW, **kw))
    with pytest.raises(ValueError, match=f"{kind} needs local tokens "
                                         r"\(15\) divisible by the expert "
                                         r"axis \(2\)"):
        _one_step(cfg, {"expert": 2}, batch=(1, 15))


def test_mesh_and_config_mismatches_raise():
    with pytest.raises(ValueError, match="n_experts must divide"):
        T.build_spmd_train_step(T.TransformerConfig(
            **dict(LOSS_KW, n_experts=3)), hosted({"expert": 2}))
    for k in (0, 5):
        with pytest.raises(ValueError, match=f"moe_top_k={k}"):
            T.build_spmd_train_step(T.TransformerConfig(
                **dict(LOSS_KW, moe_top_k=k)), hosted({"data": 1}))
        with pytest.raises(ValueError, match=f"moe_top_k={k}"):
            T.build_train_step(T.TransformerConfig(
                **dict(LOSS_KW, moe_top_k=k)), device="cpu")


def test_per_process_expert_axis_raises(tmp_path):
    """One rank per process, the expert axis runs: two gloo processes of
    ``{"data": 1, "expert": 2}`` at the steps' config (top-2, capacity
    1.1 with drops, the aux and the z-loss; the queues cross processes
    by the per-process ``all_to_all``) equal the hosted mesh within 1e-6,
    each process holding only its experts' ``ew1``/``ew2``."""
    shape = {"data": 1, "expert": 2}
    mesh_arg = "data=1,expert=2"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.mesh_train",
         "--init", f"file://{tmp_path / 'rendezvous'}", "--world", "2",
         "--rank", str(r), "--mesh", mesh_arg, "--cfg", json.dumps(STEP_KW),
         "--out", str(tmp_path / f"rank{r}.npz")],
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
    cfg = T.TransformerConfig(**STEP_KW)
    want = mesh_train.run(cfg, [shape])
    expert_bytes = sum(bp[k].nbytes for bp in T.init_params_np(cfg)["blocks"]
                       for k in ("ew1", "ew2"))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want)
        for key, value in want.items():
            if not key.endswith("/param_bytes"):
                np.testing.assert_allclose(got[key], value, atol=1e-6,
                                           rtol=0, err_msg=f"rank {r} {key}")
        held = int(got[f"{mesh_arg}/param_bytes"])
        assert held == int(want[f"{mesh_arg}/param_bytes"]) - expert_bytes // 2


def test_build_train_step_runs_moe_on_one_device():
    """``build_train_step`` (no mesh) equals the ``{"data": 1}`` step."""
    tree = _jax_steps("data1")[0]
    cfg = T.TransformerConfig(**STEP_KW)
    params = T.params_from_jax(tree, "cpu")
    velocity = T.init_velocity(params)
    step = T.build_train_step(cfg, LR, MOM, device="cpu")
    batch = [_t(a) for a in _step_batch(cfg)]
    losses = [float(step(params, velocity, *batch)[2]) for _ in range(STEPS)]
    want_losses, want_params = _port_steps("data1", tree)
    assert losses == want_losses
    assert _max_diff(T.params_to_numpy(params), want_params) == 0.0


def test_moe_step_keeps_parameters_in_place():
    cfg = dataclasses.replace(T.TransformerConfig(**STEP_KW),
                              moe_dispatch="scatter")
    mesh = hosted({"data": 2, "expert": 2})
    params = T.shard_params(T.init_params_np(cfg, seed=0), cfg, mesh)
    velocity = T.init_velocity(params)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(velocity)]
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    batch = T.make_batch(np.random.default_rng(0), cfg, 4, 16, "cpu")
    losses = [float(step(params, velocity, *batch)[2]) for _ in range(4)]
    assert [t.data_ptr() for t in T._leaves(params) + T._leaves(velocity)] \
        == ptrs
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_gloo_process_mesh_equals_the_hosted_mesh(tmp_path):
    """``{"data": 2}`` as two gloo processes, capacity dispatch with the
    aux and the z-loss: each process's routing statistics are pmean'd
    over the processes, with the gradient of its own share. Losses and
    parameters equal the hosted mesh's within 1e-6."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from mmlspark_tpu_torch.testing import mesh_train
    root = Path(__file__).resolve().parent.parent
    kw = dict(LOSS_KW, moe_top_k=2, moe_capacity_factor=1.1,
              moe_aux_weight=0.05, moe_zloss_weight=0.01)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.mesh_train",
         "--init", f"file://{tmp_path / 'rendezvous'}", "--world", "2",
         "--rank", str(r), "--mesh", "data=2", "--cfg", json.dumps(kw),
         "--out", str(tmp_path / f"rank{r}.npz")],
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
    want = mesh_train.run(T.TransformerConfig(**kw), [{"data": 2}])
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, atol=1e-6, rtol=0,
                                       err_msg=f"rank {r} {key}")
