"""The port's sequence-parallel train step (``build_spmd_train_step`` over a
(data, seq) mesh) against the JAX package, on the CPU.

The golden is ``tests/test_transformer.py``'s ``_compare``: two steps of
``jax.value_and_grad(reference_loss)`` plus momentum SGD (lr 0.1, 0.9) at
the small dense config, B 8 x S 16; the port's weights come from the JAX
``init_params`` tree through ``params_from_jax`` and its batch from
``make_batch``'s numpy draws. Tolerances are the JAX test's own: loss
2e-5, every parameter leaf 2e-4.

bf16 mixed precision is held against the JAX ``build_spmd_train_step``
itself on the same ``{"seq": 4}`` mesh (dense ring, bf16 products): the
same values round at the same points, but f32 sums in another order
before a bf16 rounding move a value by an ulp now and then, and the
gradients carry it into both steps' updates: loss within 1e-4,
parameters within 5e-4 after two steps, about 4x the readings (loss
2.0e-5 and parameters 1.12e-4 for the dense ring; 1.4e-5 and 1.13e-4
for the folded ring, whose backward rounds ``ds`` where JAX's dense
ring differentiates through its bf16 products).

The process mesh runs two ranks in two processes over gloo (file
rendezvous under the test's tmp dir, so parallel test workers never
share a port), each rank its own process of
``mmlspark_tpu_torch.testing.mesh_train``; each rank's losses and
parameters must equal the hosted mesh's within 1e-6.
"""

import dataclasses
import functools
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
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import topology as TP
from mmlspark_tpu_torch.testing import mesh_train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(mesh_train.SMALL)
B, S = 8, 16
LR, MOM = 0.1, 0.9
STEPS = 2


def hosted(shape):
    return TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_tree():
    return jax.tree.map(np.asarray, JT.init_params(JT.TransformerConfig(
        **CFG), seed=0))


def _batch(cfg):
    return T.make_batch(np.random.default_rng(1), cfg, B, S, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_golden():
    jcfg = JT.TransformerConfig(**CFG)
    tokens, labels, mask = JT.make_batch(np.random.default_rng(1), jcfg, B, S)
    vg = jax.jit(jax.value_and_grad(JT.reference_loss), static_argnums=4)
    p = jax.tree.map(jnp.asarray, _jax_tree())
    vel = jax.tree.map(jnp.zeros_like, p)
    losses = []
    for _ in range(STEPS):
        loss, g = vg(p, tokens, labels, mask, jcfg)
        vel = jax.tree.map(lambda v, gr: MOM * v + gr, vel, g)
        p = jax.tree.map(lambda a, v: a - LR * v, p, vel)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _jax_spmd_bf16():
    """The JAX step itself in bf16 on ``{"seq": 4}`` (dense ring)."""
    jcfg = JT.TransformerConfig(**CFG, dtype="bfloat16",
                                attention_impl="dense")
    tokens, labels, mask = JT.make_batch(np.random.default_rng(1), jcfg, B, S)
    n = 4
    mesh = jbuild_mesh(JMeshSpec.from_dict({"seq": n}),
                       devices=jax.devices()[:n])
    step = JT.build_spmd_train_step(jcfg, mesh, LR, MOM, donate=False,
                                    impl="shard_map")
    p = JT.shard_params(jax.tree.map(jnp.asarray, _jax_tree()), jcfg, mesh)
    v = JT.shard_params(jax.tree.map(jnp.zeros_like, p), jcfg, mesh)
    losses = []
    for _ in range(STEPS):
        p, v, loss = step(p, v, tokens, labels, mask)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(p))


def _max_leaf_diff(a, b) -> float:
    return max(float(np.abs(x - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _port_steps(shape, **kw):
    cfg = T.TransformerConfig(**CFG, **kw)
    mesh = hosted(shape)
    params = T.shard_params(_jax_tree(), cfg, mesh)
    velocity = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    batch = _batch(cfg)
    losses = [float(step(params, velocity, *batch)[2]) for _ in range(STEPS)]
    return losses, T.params_to_numpy(params)


@pytest.mark.parametrize("attention_impl", ["dense", "folded", "auto"])
@pytest.mark.parametrize("shape", [{"seq": 4}, {"data": 2, "seq": 2},
                                   {"seq": 1}],
                         ids=["seq4", "data2_seq2", "seq1"])
def test_two_steps_match_jax_golden(shape, attention_impl):
    losses, params = _port_steps(shape, attention_impl=attention_impl)
    want_losses, want_params = _jax_golden()
    np.testing.assert_allclose(losses, want_losses, atol=2e-5, rtol=0)
    assert _max_leaf_diff(params, want_params) < 2e-4


def test_data_parallel_matches_jax_golden():
    losses, params = _port_steps({"data": 2})
    want_losses, want_params = _jax_golden()
    np.testing.assert_allclose(losses, want_losses, atol=2e-5, rtol=0)
    assert _max_leaf_diff(params, want_params) < 2e-4


@pytest.mark.parametrize("attention_impl", ["dense", "folded"])
def test_bf16_matches_jax_spmd_step(attention_impl):
    losses, params = _port_steps({"seq": 4}, dtype="bfloat16",
                                 attention_impl=attention_impl)
    want_losses, want_params = _jax_spmd_bf16()
    np.testing.assert_allclose(losses, want_losses, atol=1e-4, rtol=0)
    assert _max_leaf_diff(params, want_params) < 5e-4


def test_step_updates_in_place_and_keeps_the_global_loss():
    """One set of parameters for every hosted rank, updated in place; the
    loss is the whole batch's (the single-device step's)."""
    cfg = T.TransformerConfig(**CFG)
    mesh = hosted({"data": 2, "seq": 2})
    params = T.shard_params(_jax_tree(), cfg, mesh)
    velocity = T.init_velocity(params)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(velocity)]
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    p2, v2, loss = step(params, velocity, *_batch(cfg))
    assert p2 is params and v2 is velocity
    assert [t.data_ptr() for t in T._leaves(p2) + T._leaves(v2)] == ptrs
    assert not any(t.requires_grad for t in T._leaves(p2))
    assert abs(float(loss) - _jax_golden()[0][0]) < 2e-5


def test_uneven_rows_are_padded_with_mask_zero():
    """B 7 over data 2: the JAX ``shard_batch`` rule pads a row whose mask
    is 0, so the loss is the 7 rows' (the single-device step's)."""
    cfg = T.TransformerConfig(**CFG)
    tokens, labels, mask = (x[:7] for x in _batch(cfg))
    params = T.shard_params(_jax_tree(), cfg, hosted({"data": 2}))
    with torch.no_grad():
        want = float(T.local_loss(params, tokens, labels, mask, cfg))
    step = T.build_spmd_train_step(cfg, hosted({"data": 2}), LR, MOM)
    loss = step(params, T.init_velocity(params), tokens, labels, mask)[2]
    assert abs(float(loss) - want) < 1e-6


def test_ce_gate_counts_one_ranks_tokens(monkeypatch):
    """The auto CE engine's token gate sees one rank's tokens, as the JAX
    step gates on ``b_loc * s_loc``: on ``{"seq": 4}`` at B 8 x S 128
    each rank holds 256 tokens (below the gate's 512), 1024 in all."""
    seen = []
    gate = T.train_ce_engine

    def spy(cfg, n_tokens, device=None):
        seen.append(n_tokens)
        return gate(cfg, n_tokens, device)

    monkeypatch.setattr(T, "train_ce_engine", spy)
    cfg = T.TransformerConfig(**CFG)
    mesh = hosted({"seq": 4})
    params = T.shard_params(_jax_tree(), cfg, mesh)
    step = T.build_spmd_train_step(cfg, mesh, LR, MOM)
    batch = T.make_batch(np.random.default_rng(1), cfg, 8, 128, "cpu")
    loss = step(params, T.init_velocity(params), *batch)[2]
    per_rank = 8 * 128 // 4
    assert per_rank < FC.T_TILE <= 4 * per_rank
    assert seen and set(seen) == {per_rank}
    assert np.isfinite(float(loss))


def test_gloo_process_mesh_equals_the_hosted_mesh(tmp_path):
    """Two ranks in two gloo processes, ``{"seq": 2}`` then ``{"data":
    2}``, against the same runs on hosted meshes in this process."""
    meshes = ["seq=2", "data=2"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.mesh_train",
         "--init", f"file://{tmp_path / 'rendezvous'}", "--world", "2",
         "--rank", str(r), *sum((["--mesh", m] for m in meshes), []),
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
    want = mesh_train.run(T.TransformerConfig(**CFG),
                          [{"seq": 2}, {"data": 2}], steps=STEPS)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(got.files) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, atol=1e-6, rtol=0,
                                       err_msg=f"rank {r} {key}")


def test_mesh_and_config_mismatches_raise():
    cfg = T.TransformerConfig(**CFG)
    with pytest.raises(ValueError, match="requires a 'pipe'"):
        T.build_spmd_train_step(dataclasses.replace(cfg, n_stages=2),
                                hosted({"seq": 2}))
    with pytest.raises(ValueError, match="pipe axis size"):
        T.build_spmd_train_step(dataclasses.replace(cfg, n_stages=2),
                                hosted({"seq": 2, "pipe": 1}))
    step = T.build_spmd_train_step(dataclasses.replace(cfg, microbatches=3),
                                   hosted({"data": 2}))
    params = T.shard_params(_jax_tree(), cfg, hosted({"data": 2}))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, T.init_velocity(params), *_batch(cfg))
    step = T.build_spmd_train_step(cfg, hosted({"seq": 3}))
    with pytest.raises(ValueError, match="does not split"):
        step(params, T.init_velocity(params), *_batch(cfg))


@pytest.mark.parametrize("axis", ["model", "expert", "pipe"])
def test_model_expert_and_pipe_axes_are_not_ported(axis):
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        hosted({"seq": 2, axis: 2})


def test_param_specs_replicate_every_leaf():
    """The JAX specs' tree and lengths, every entry replicated."""
    specs = T.param_specs(T.TransformerConfig(**CFG),
                          hosted({"data": 2, "seq": 2}))
    want = JT.param_specs(JT.TransformerConfig(**CFG), jbuild_mesh(
        JMeshSpec.from_dict({"data": 2, "seq": 2}),
        devices=jax.devices()[:4]))
    assert specs.keys() == want.keys()
    for name in ("embed", "head", "final_norm"):
        assert specs[name] == tuple(want[name]) == ()
    for bp, wp in zip(specs["blocks"], want["blocks"], strict=True):
        assert bp.keys() == wp.keys()
        for k, spec in bp.items():
            assert spec == tuple(wp[k]) == (None,) * len(wp[k]), k
