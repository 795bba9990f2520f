"""The port's transformer train step (``build_train_step``, ``local_loss``,
``reference_loss``) against the JAX package's, on the CPU.

The port's tree comes from the JAX ``init_params`` tree through
``params_from_jax`` (f32 masters), and its batch from ``make_batch``'s
numpy draws, so both sides see the same numbers. On the CPU every engine
runs its plain versions, the folded attention and the fused CE through
their autograd Functions. The golden test is ``tests/test_fused_ce.py``'s
single-device one without a mesh: two momentum-SGD steps against
``jax.value_and_grad(reference_loss)`` plus the same update, loss within
2e-5 and every parameter leaf within 5e-5 (f32).

bf16 mixed precision is held against JAX ``local_loss`` under
``dtype="bfloat16"`` on a one-device ``_Axes`` (every axis None, no
mesh), by value and grad. With the dense attention both sides round the
same values at the same points, but sums in another order before each
bf16 rounding move a few values by an ulp: loss within 5e-5, grads
within 2e-3 absolute (1.0e-5 and 4.4e-4 measured). The folded engine
rounds ``p`` before normalizing where the dense one rounds after (JAX's
folded kernel does the same, and JAX's folded engine does not run on the
CPU), so it is held to 3e-4 on the loss and 1e-2 on the grads (8.8e-5
and 3.8e-3 measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu_torch.models import transformer as T

torch.set_num_threads(1)

CFG = dict(vocab=256, d_model=128, n_heads=2, d_head=16, d_ff=64,
           layers_per_stage=2)
B, S = 2, 128            # S = 128: the folded engine's smallest tile
LR, MOM = 0.1, 0.9
AX = JT._Axes(None, None, None, None, None)


@functools.lru_cache(maxsize=None)
def _jax_tree():
    return jax.tree.map(np.asarray, JT.init_params(JT.TransformerConfig(
        **CFG), seed=0))


def _jax_batch(jcfg):
    return JT.make_batch(np.random.default_rng(1), jcfg, B, S)


@functools.lru_cache(maxsize=None)
def _jax_golden():
    """Two steps of ``reference_loss`` + momentum SGD: the losses and the
    params after step 2."""
    jcfg = JT.TransformerConfig(**CFG)
    tokens, labels, mask = _jax_batch(jcfg)
    vg = jax.jit(jax.value_and_grad(JT.reference_loss), static_argnums=4)
    p = jax.tree.map(jnp.asarray, _jax_tree())
    vel = jax.tree.map(jnp.zeros_like, p)
    losses = []
    for _ in range(2):
        loss, g = vg(p, tokens, labels, mask, jcfg)
        vel = jax.tree.map(lambda v, gr: MOM * v + gr, vel, g)
        p = jax.tree.map(lambda a, v: a - LR * v, p, vel)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _jax_local(ce_impl: str, dtype: str):
    """JAX ``local_loss`` and its grads on the one-device axes."""
    jcfg = JT.TransformerConfig(**CFG, dtype=dtype, ce_impl=ce_impl,
                                attention_impl="dense")
    tokens, labels, mask = _jax_batch(jcfg)
    vg = jax.jit(jax.value_and_grad(JT.local_loss), static_argnums=(4, 5))
    loss, g = vg(jax.tree.map(jnp.asarray, _jax_tree()), tokens, labels,
                 mask, jcfg, AX)
    return float(loss), jax.tree.map(np.asarray, g)


def _port(**kw):
    cfg = T.TransformerConfig(**CFG, **kw)
    params = T.params_from_jax(_jax_tree(), "cpu")
    batch = T.make_batch(np.random.default_rng(1), cfg, B, S, "cpu")
    return cfg, params, batch


def _loss_and_grads(cfg, params, batch, fn=T.local_loss):
    leaves = T._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = fn(params, *batch, cfg)
    loss.backward()
    grads = {"embed": params["embed"].grad, "head": params["head"].grad,
             "final_norm": params["final_norm"].grad,
             "blocks": [{k: v.grad for k, v in bp.items()}
                        for bp in params["blocks"]]}
    return loss.item(), T.params_to_numpy(grads)


def _max_leaf_diff(a, b) -> float:
    return max(float(np.abs(x - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_make_batch_draws_the_jax_tokens():
    cfg, _, (tokens, labels, mask) = _port()
    jt, jl, jm = _jax_batch(JT.TransformerConfig(**CFG))
    assert tokens.dtype == labels.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


def test_local_and_reference_loss_match_jax():
    cfg, params, batch = _port()
    jcfg = JT.TransformerConfig(**CFG)
    jp = jax.tree.map(jnp.asarray, _jax_tree())
    want = float(JT.reference_loss(jp, *_jax_batch(jcfg), jcfg))
    with torch.no_grad():
        assert abs(float(T.reference_loss(params, *batch, cfg)) - want) < 2e-5
        assert abs(float(T.local_loss(params, *batch, cfg)) - want) < 2e-5
    assert abs(_jax_local("xla", "float32")[0] - want) < 2e-5


@pytest.mark.parametrize("attention_impl", ["dense", "folded"])
def test_microbatches_split_only_the_blocks(attention_impl):
    """``microbatches=2`` runs the blocks per half batch and the loss
    over the whole: the same loss and grads as one microbatch."""
    one = _loss_and_grads(*_port(attention_impl=attention_impl))
    two = _loss_and_grads(*_port(attention_impl=attention_impl,
                                 microbatches=2))
    assert abs(one[0] - two[0]) < 1e-6
    assert _max_leaf_diff(one[1], two[1]) < 1e-6


@pytest.mark.parametrize("ce_impl", ["dense", "cuda"])
@pytest.mark.parametrize("attention_impl", ["dense", "folded", "flash"])
def test_two_steps_match_jax_golden(attention_impl, ce_impl):
    cfg, params, batch = _port(attention_impl=attention_impl,
                               ce_impl=ce_impl)
    velocity = T.init_velocity(params)
    step = T.build_train_step(cfg, LR, MOM, device="cpu")
    losses = []
    for _ in range(2):
        params, velocity, loss = step(params, velocity, *batch)
        losses.append(float(loss))
    want_losses, want_params = _jax_golden()
    np.testing.assert_allclose(losses, want_losses, atol=2e-5, rtol=0)
    assert _max_leaf_diff(T.params_to_numpy(params), want_params) < 5e-5


@pytest.mark.parametrize("attention_impl,ce_impl,jax_ce,loss_tol,grad_tol", [
    ("dense", "dense", "xla", 5e-5, 2e-3),
    ("dense", "cuda", "fused_interpret", 5e-5, 2e-3),
    ("folded", "cuda", "fused_interpret", 3e-4, 1e-2),
])
def test_bf16_matches_jax_local_loss(attention_impl, ce_impl, jax_ce,
                                     loss_tol, grad_tol):
    cfg, params, batch = _port(dtype="bfloat16",
                               attention_impl=attention_impl,
                               ce_impl=ce_impl)
    loss, grads = _loss_and_grads(cfg, params, batch)
    want_loss, want_grads = _jax_local(jax_ce, "bfloat16")
    assert abs(loss - want_loss) < loss_tol
    assert _max_leaf_diff(grads, want_grads) < grad_tol


def test_step_updates_in_place():
    """The port's donation: the same dicts come back, every leaf keeps
    its storage and changed, and no leaf is left requiring grad."""
    cfg, params, batch = _port(ce_impl="cuda", attention_impl="folded")
    velocity = T.init_velocity(params)
    ptrs = [t.data_ptr() for t in T._leaves(params) + T._leaves(velocity)]
    before = T.params_to_numpy(params)
    step = T.build_train_step(cfg, LR, MOM, device="cpu")
    p2, v2, _ = step(params, velocity, *batch)
    p2, v2, _ = step(p2, v2, *batch)
    assert p2 is params and v2 is velocity
    assert [t.data_ptr() for t in T._leaves(p2) + T._leaves(v2)] == ptrs
    assert not any(t.requires_grad for t in T._leaves(p2))
    assert _max_leaf_diff(T.params_to_numpy(p2), before) > 0


def test_device_none_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_train_step(T.TransformerConfig(**CFG))


def test_engine_rules():
    cfg = T.TransformerConfig(**CFG)
    # auto: dense on the CPU whatever the shape; the JAX gates on CUDA
    assert T.attention_engine(cfg, 1024, "cpu") == "dense"
    assert T.train_ce_engine(cfg, 8192, "cpu") == "dense"
    named = T.TransformerConfig(**CFG, attention_impl="folded",
                                ce_impl="cuda")
    assert T.attention_engine(named, 128, "cpu") == "folded"
    assert T.train_ce_engine(named, 4, "cpu") == "cuda"
    with pytest.raises(ValueError, match="folded"):
        T.attention_engine(named, 100, "cpu")
    with pytest.raises(ValueError, match="unknown attention_impl"):
        T.attention_engine(T.TransformerConfig(attention_impl="ring"), 8,
                           "cpu")
    with pytest.raises(ValueError, match="unknown ce_impl"):
        T.train_ce_engine(T.TransformerConfig(ce_impl="fused"), 8, "cpu")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(n_stages=2), ValueError, "requires a 'pipe' mesh axis"),
    (dict(dtype="float16"), ValueError, "unknown dtype"),
    (dict(microbatches=0), ValueError, "microbatches"),
    (dict(microbatches=3), ValueError, "not divisible"),
])
def test_train_config_refusals(kw, exc, match):
    cfg = T.TransformerConfig(**{**CFG, **kw})
    params = T.params_from_jax(_jax_tree(), "cpu")
    batch = T.make_batch(np.random.default_rng(1), cfg, B, 8, "cpu")
    with pytest.raises(exc, match=match):
        T.local_loss(params, *batch, cfg)


def test_step_refuses_tensors_off_its_device():
    cfg, params, (tokens, labels, mask) = _port()
    step = T.build_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="tokens is on meta"):
        step(params, T.init_velocity(params), tokens.to("meta"), labels,
             mask)
