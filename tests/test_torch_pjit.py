"""The port's pjit train-step formulation (``build_spmd_train_step(
impl="pjit")``, :func:`~mmlspark_tpu_torch.models.transformer.
build_pjit_train_step`) against its shard_map formulation and the JAX
package's pjit step, on the CPU.

* ``TestPjitFormulation``'s four contracts (``tests/test_transformer.py``)
  on hosted meshes: pjit builds anywhere hosted, an unknown impl is
  refused, ``"auto"`` keeps the shard_map path, and three steps of pjit
  equal three of shard_map (the loss within 2e-5, every parameter within
  2e-4, JAX's limits) on ``{"data": 2, "model": 2}``, the pipe and the
  5-axis MoE mesh;
* three steps of the port's pjit against JAX's ``impl="pjit"`` step on
  the same 4-device mesh (1e-5), dense and capacity MoE;
* the capacity (both engines) and expert-choice routers on ``{"data": 2,
  "expert": 2}`` at a capacity factor of 0.5, which drops about half
  the routings of every group: pjit against shard_map, drop for drop
  (1e-6 on the loss, 1e-6 on the parameters);
* ``ce_impl="cuda"``: on ``{"data": 2, "model": 2}`` and on one rank pjit
  runs the fused CE (the plain versions of K4's training variant and K6
  on the CPU) once a step over the global batch, without a warning,
  equal to the plain CE's step (1e-5).

The JAX side jits its steps on the 8-device CPU mesh and is cached per
(mesh, config).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.parallel.topology import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.topology import build_mesh as jbuild_mesh
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import topology as TP

torch.set_num_threads(1)

DENSE = dict(vocab=64, d_model=16, n_heads=4, d_head=8, d_ff=32)
B, S = 8, 16
LR, MOM = 0.1, 0.9
STEPS = 3
LOSS_TOL, PARAM_TOL = 2e-5, 2e-4       # TestPjitFormulation's
JAX_TOL = 1e-5
DROP_TOL = 1e-6
FIVE_AXIS = {"data": 1, "seq": 2, "model": 2, "expert": 1, "pipe": 2}
CAPACITY = dict(DENSE, layers_per_stage=2, n_experts=4, moe_top_k=2,
                moe_capacity_factor=0.5, moe_aux_weight=0.01,
                moe_zloss_weight=1e-3)

#: case id -> (mesh shape, config fields)
CASES = {
    "data2_model2": ({"data": 2, "model": 2},
                     dict(DENSE, layers_per_stage=2)),
    "model2_pipe2": ({"model": 2, "pipe": 2},
                     dict(DENSE, n_stages=2, microbatches=2)),
    "five_axis_moe": (FIVE_AXIS, dict(DENSE, n_stages=2, n_experts=2,
                                      microbatches=2)),
}


def hosted(shape):
    return TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")


def submesh(shape):
    n = int(np.prod(list(shape.values())))
    return jbuild_mesh(JMeshSpec.from_dict(shape), devices=jax.devices()[:n])


def _items(d):
    return tuple(sorted(d.items()))


def _max_leaf_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                               strict=True))


@functools.lru_cache(maxsize=None)
def _tree(kw_items):
    return jax.tree.map(np.asarray, JT.init_params(
        JT.TransformerConfig(**dict(kw_items)), seed=0))


def _port_steps(shape, kw, impl, steps=STEPS, rng_seed=7):
    cfg = T.TransformerConfig(**kw)
    mesh = hosted(shape)
    params = T.shard_params(_tree(_items(kw)), cfg, mesh)
    velocity = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM, impl=impl)
    batch = T.make_batch(np.random.default_rng(rng_seed), cfg, B, S, "cpu")
    losses = []
    for _ in range(steps):
        params, velocity, loss = step(params, velocity, *batch)
        losses.append(float(loss))
    return losses, T.params_to_numpy(params)


@functools.lru_cache(maxsize=None)
def _jax_pjit_steps(shape_items, kw_items, steps=STEPS, rng_seed=7):
    """JAX's ``impl="pjit"`` step on the CPU mesh."""
    jcfg = JT.TransformerConfig(**dict(kw_items))
    mesh = submesh(dict(shape_items))
    step = JT.build_spmd_train_step(jcfg, mesh, LR, MOM, donate=False,
                                    impl="pjit")
    tree = _tree(kw_items)
    p = JT.shard_params(jax.tree.map(jnp.asarray, tree), jcfg, mesh)
    v = JT.shard_params(jax.tree.map(jnp.zeros_like, tree), jcfg, mesh)
    tokens, labels, mask = JT.make_batch(np.random.default_rng(rng_seed),
                                         jcfg, B, S)
    losses = []
    for _ in range(steps):
        p, v, loss = step(p, v, tokens, labels, mask)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(p))


class TestPjitFormulation:
    """``tests/test_transformer.py::TestPjitFormulation``'s contracts."""

    def test_explicit_pjit_impl_builds_anywhere(self):
        cfg = T.TransformerConfig(**DENSE, layers_per_stage=2)
        mesh = hosted({"data": 2, "model": 2})
        step = T.build_spmd_train_step(cfg, mesh, 0.1, 0.9, impl="pjit")
        tokens, labels, mask = T.make_batch(np.random.default_rng(3), cfg,
                                            8, 16, "cpu")
        sp = T.shard_params(_tree(_items(dict(DENSE, layers_per_stage=2))),
                            cfg, mesh)
        _, _, loss = step(sp, T.init_velocity(sp), tokens, labels, mask)
        assert np.isfinite(float(loss))

    def test_unknown_impl_refused(self):
        cfg = T.TransformerConfig(**DENSE)
        with pytest.raises(ValueError, match="impl"):
            T.build_spmd_train_step(cfg, hosted({"data": 2}), impl="magic")

    def test_auto_keeps_shard_map_path(self, monkeypatch):
        """JAX's ``test_check_vma_false_keeps_shard_map_path``: the port
        has no ``check_vma``; its contract is that ``"auto"`` builds the
        shard_map formulation (the per-rank ``local_loss``), never the
        pjit one."""
        cfg = T.TransformerConfig(**DENSE, layers_per_stage=1)
        mesh = hosted({"data": 2})
        calls = []
        local = T.local_loss

        def spy(*args, **kw):
            calls.append(1)
            return local(*args, **kw)

        def refuse(*args, **kw):
            raise AssertionError("auto reached the pjit loss")

        monkeypatch.setattr(T, "local_loss", spy)
        monkeypatch.setattr(T, "_pjit_loss", refuse)
        step = T.build_spmd_train_step(cfg, mesh, 0.1, 0.0)
        params = T.shard_params(_tree(_items(dict(DENSE,
                                                  layers_per_stage=1))),
                                cfg, mesh)
        batch = T.make_batch(np.random.default_rng(1), cfg, 4, 16, "cpu")
        _, _, loss = step(params, T.init_velocity(params), *batch)
        assert calls and np.isfinite(float(loss))

    @pytest.mark.parametrize("case", list(CASES))
    def test_pjit_matches_shard_map_fixed_seed(self, case):
        shape, kw = CASES[case]
        results = {impl: _port_steps(shape, kw, impl)
                   for impl in ("shard_map", "pjit")}
        assert abs(results["pjit"][0][-1]
                   - results["shard_map"][0][-1]) < LOSS_TOL
        assert _max_leaf_diff(results["pjit"][1],
                              results["shard_map"][1]) < PARAM_TOL


@pytest.mark.parametrize("shape,kw", [
    ({"data": 2, "model": 2}, dict(DENSE, layers_per_stage=2)),
    ({"data": 2, "expert": 2}, CAPACITY),
], ids=["dense", "capacity_moe"])
def test_pjit_matches_jax_pjit_step(shape, kw):
    losses, params = _port_steps(shape, kw, "pjit")
    jl, jp = _jax_pjit_steps(_items(shape), _items(kw))
    np.testing.assert_allclose(losses, jl, atol=JAX_TOL, rtol=0)
    assert _max_leaf_diff(params, jp) < JAX_TOL


@pytest.mark.parametrize("kw", [
    CAPACITY,
    dict(CAPACITY, moe_dispatch="scatter"),
    dict(CAPACITY, moe_router="expert_choice", moe_aux_weight=0.0),
], ids=["capacity_sort", "capacity_scatter", "expert_choice"])
def test_moe_groups_drop_as_the_shard_map_ranks(kw):
    """At factor 0.5 every group's queues hold about half its routings:
    each (data, expert) rank's shard of 32 tokens, top-2 over 4 experts,
    C = ceil(0.5 * 32 * 2 / 4) = 8 slots, 32 of 64 routings kept at
    most (expert choice: 4 of 32 tokens an expert). The pjit groups must
    be the ranks' shards for the two steps to agree."""
    shape = {"data": 2, "expert": 2}
    t_sh = B * S // 4
    k = kw.get("moe_top_k", 1) if kw.get("moe_router") != "expert_choice" \
        else 1
    C = int(np.ceil(0.5 * t_sh * k / 4))
    assert C * 4 < t_sh * k           # tokens are dropped in every group
    results = {impl: _port_steps(shape, kw, impl)
               for impl in ("shard_map", "pjit")}
    np.testing.assert_allclose(results["pjit"][0], results["shard_map"][0],
                               atol=DROP_TOL, rtol=0)
    assert _max_leaf_diff(results["pjit"][1],
                          results["shard_map"][1]) < DROP_TOL


def test_token_groups_are_jaxs_and_invert():
    x = np.random.default_rng(0).standard_normal((4, 6, 3)).astype(
        np.float32)
    for D, Q in ((1, 1), (2, 1), (2, 3), (4, 2)):
        got = T._token_groups(torch.from_numpy(x), D, Q)
        want = np.asarray(JT._token_groups(jnp.asarray(x), D, Q))
        np.testing.assert_array_equal(got.numpy(), want)
        back = T._ungroup_tokens(got, D, Q, 4, 6)
        np.testing.assert_array_equal(back.numpy(), x)


def test_grouping_changes_which_tokens_drop():
    """The group count is what the drops depend on: one global group
    keeps other routings than the four ranks' groups (the pjit step's
    grouping is not a no-op the parity above could miss)."""
    cfg = T.TransformerConfig(**CAPACITY)
    tree = T.params_from_jax(_tree(_items(CAPACITY)), "cpu")
    bp = {k: v[0] for k, v in tree["blocks"][0].items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    y4, _ = T._pjit_moe(bp, x, cfg, 2, 1, 2)
    y1, _ = T._pjit_moe(bp, x, cfg, 1, 1, 1)
    assert float((y4 - y1).abs().max()) > 1e-3


def _fused_ce_steps(monkeypatch, shape):
    """Three pjit steps with ``ce_impl="cuda"`` on ``shape``, counting
    the fused CE's calls; no warning may be raised. Returns the calls and
    the steps' and the plain CE's ``(losses, params)``."""
    kw = dict(DENSE, layers_per_stage=2)
    calls = []
    fused = FC.fused_softmax_xent

    def spy(*a, **k):
        calls.append(1)
        return fused(*a, **k)

    monkeypatch.setattr(FC, "fused_softmax_xent", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _port_steps(shape, dict(kw, ce_impl="cuda"), "pjit")
    want = _port_steps(shape, dict(kw, ce_impl="dense"), "pjit")
    return calls, got, want


def test_cuda_ce_on_several_ranks_warns_and_runs_the_plain_ce(monkeypatch):
    """Now checks the opposite of its name: on ``{"data": 2, "model": 2}``
    the pjit step runs the fused CE once a step over the global batch
    (every hosted rank is on the one device, so JAX's per-device reason
    to fall back does not hold), warns nothing, and equals the plain
    CE's step (1e-5)."""
    calls, got, want = _fused_ce_steps(monkeypatch, {"data": 2, "model": 2})
    assert len(calls) == STEPS
    np.testing.assert_allclose(got[0], want[0], atol=JAX_TOL, rtol=0)
    assert _max_leaf_diff(got[1], want[1]) < JAX_TOL


def test_cuda_ce_on_one_rank_runs_the_fused_ce_once_a_step(monkeypatch):
    """``{"data": 1}``: K4's training variant and K6 (their plain versions
    on the CPU) once a step, equal to the plain CE's step (1e-5)."""
    calls, got, want = _fused_ce_steps(monkeypatch, {"data": 1})
    assert len(calls) == STEPS
    np.testing.assert_allclose(got[0], want[0], atol=JAX_TOL, rtol=0)
    assert _max_leaf_diff(got[1], want[1]) < JAX_TOL


def test_pjit_one_rank_per_process_is_refused(monkeypatch):
    """One rank per process the pjit step is built, no longer refused:
    its program is split by the mesh as the shard_map step splits it,
    with the pjit formulation's engines (dense attention, the dense CE
    for ``"auto"``). Its runs over processes against JAX:
    ``tests/test_torch_process_axes.py``."""
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    mesh = TP.Mesh({"data": 2}, torch.device("cpu"), hosted=False)
    cfg = T.TransformerConfig(**dict(DENSE, attention_impl="folded"))
    built = []
    spmd = T.build_spmd_train_step

    def spy(c, m, *a, **k):
        built.append((c.attention_impl, c.ce_impl, k.get("impl")))
        return spmd(c, m, *a, **k)
    monkeypatch.setattr(T, "build_spmd_train_step", spy)
    assert callable(T.build_pjit_train_step(cfg, mesh))
    assert built == [("dense", "dense", "shard_map")]


def test_pjit_pads_rows_to_the_data_axis_as_shard_map():
    """Seven rows on ``{"data": 2}``: both formulations pad the eighth
    with mask 0 and agree."""
    kw = dict(DENSE, layers_per_stage=1)
    cfg = T.TransformerConfig(**kw)
    mesh = hosted({"data": 2})
    batch = T.make_batch(np.random.default_rng(5), cfg, 7, S, "cpu")
    out = {}
    for impl in ("shard_map", "pjit"):
        params = T.shard_params(_tree(_items(kw)), cfg, mesh)
        step = T.build_spmd_train_step(cfg, mesh, LR, MOM, impl=impl)
        _, _, loss = step(params, T.init_velocity(params), *batch)
        out[impl] = (float(loss), T.params_to_numpy(params))
    assert abs(out["pjit"][0] - out["shard_map"][0]) < LOSS_TOL
    assert _max_leaf_diff(out["pjit"][1], out["shard_map"][1]) < PARAM_TOL
