"""The port's ring attention (``parallel/ring_attention.py``) and its block
kernel K8's plain versions (``parallel/cuda_attention.py``) against the
JAX package, on the CPU.

Inputs are numpy draws from a seed, handed to both. JAX runs its Pallas
kernels in interpret mode and its rings under ``shard_map`` over the
virtual CPU devices of ``tests/conftest.py``; the port runs the plain
versions (CPU tensors) and its rings on hosted meshes (every rank in
this process). Tolerances:

* block partials, f32: the JAX test's own (m within 2e-5; l and o within
  rtol 1e-5, atol 2e-5). bf16: both cast m, l and o to bf16 after f32
  sums in another order, so an output may round one bf16 ulp apart:
  rtol 2^-7 (1 ulp) plus atol 1e-5 (measured: 6.1e-7 of max |ref|);
* block backward, f32: 1e-5 x max(1, max |ref|) (sum order only). bf16:
  p and ds round to bf16 at the same values on both sides at S = 128
  (one JAX tile), and a sum in another order moves a rounding by an
  ulp: 2e-4 x max(1, max |ref|) (measured: 3.1e-5);
* rings: JAX's own (2e-6 dense, 2e-5 for the kernel paths), the folded
  ring's gradients against JAX's dense ring 5e-5 (the JAX
  ``test_folded_ring_is_differentiable`` tolerance, on its fast dense
  side).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mmlspark_tpu.parallel import collectives as JC
from mmlspark_tpu.parallel import pallas_attention as JPA
from mmlspark_tpu.parallel.topology import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.topology import build_mesh as jbuild_mesh
from mmlspark_tpu_torch.parallel import collectives as C
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel import ring_attention as RA
from mmlspark_tpu_torch.parallel import topology as TP
from mmlspark_tpu_torch.parallel.dist import process_local_rows
from mmlspark_tpu_torch.parallel.sharding import gather_shards, shard_batch

# the JAX package re-exports a function under the module's name
JRA = importlib.import_module("mmlspark_tpu.parallel.ring_attention")
torch.set_num_threads(1)

B, S, H, D = 2, 128, 3, 16
SCALE = D ** -0.5
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def submesh(shape):
    n = int(np.prod(list(shape.values())))
    return jbuild_mesh(JMeshSpec.from_dict(shape), devices=jax.devices()[:n])


def hosted(shape):
    return TP.build_mesh(TP.MeshSpec.from_dict(shape), "cpu")


def draws(seed, *shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def both(x, tag):
    """One numpy draw as a port tensor and a JAX array of ``tag``'s
    dtype (bf16 rounds the same way on both sides)."""
    _, tdt, jdt = DTYPES[tag]
    return torch.tensor(x).to(tdt), jnp.asarray(x).astype(jdt)


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


# the ring's three visibilities (queries / keys as block offsets), a
# padded tail of keys, and the diagonal block with its keys' positions in
# a seeded permutation and a fifth of the keys padded at scattered rows
# (positions the ring never makes, which the kernels take all the same)
VISIBILITY = {"diagonal": (0, 0), "full": (S, 0), "none": (0, S)}


def positions(vis):
    qo, ko = VISIBILITY.get(vis, (0, 0))
    q_pos = np.arange(S, dtype=np.int32) + qo
    k_pos = np.arange(S, dtype=np.int32) + ko
    if vis == "padded":
        k_pos[S - 40:] = CA.PAD_POS
    elif vis == "shuffled":
        rng = np.random.default_rng(17)
        k_pos = rng.permutation(k_pos)
        k_pos[rng.choice(S, S // 5, replace=False)] = CA.PAD_POS
    return q_pos, k_pos


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
# the JAX folded twin is never handed padded keys: only the flash twin pads
@pytest.mark.parametrize("twin,vis", [
    (twin, vis) for twin in ("folded", "flash")
    for vis in ("diagonal", "full", "none", "padded", "shuffled")
    if twin == "flash" or vis not in ("padded", "shuffled")])
def test_block_partials_match_jax_kernels(twin, vis, causal, tag):
    (tq, jq), (tk, jk), (tv, jv) = (both(x, tag) for x in
                                    draws(7, B, S, H, D))
    q_pos, k_pos = positions(vis)
    jfn = JPA.folded_block_attn if twin == "folded" else JPA.flash_block_attn
    tfn = CA.folded_block_attn if twin == "folded" else CA.flash_block_attn
    jm, jl, jo = jfn(jq, jk, jv, SCALE, jnp.asarray(q_pos),
                     jnp.asarray(k_pos), causal, interpret=True)
    tm, tl, to = tfn(tq, tk, tv, SCALE, torch.tensor(q_pos),
                     torch.tensor(k_pos), causal, interpret=True)
    assert tm.dtype == tl.dtype == to.dtype == tq.dtype
    if tag == "f32":
        np.testing.assert_allclose(f32(tm), f32(jm), atol=2e-5)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(f32(to), f32(jo), rtol=1e-5, atol=2e-5)
    else:
        for t, j in ((tm, jm), (tl, jl), (to, jo)):
            np.testing.assert_allclose(f32(t), f32(j), rtol=2 ** -7,
                                       atol=1e-5)
    if causal and vis == "none":
        # no visible key: exactly "no data"
        assert float(tl.abs().max()) == 0.0
        assert float(to.abs().max()) == 0.0
        sentinel = torch.tensor(-1e30).to(tq.dtype)
        assert bool((tm == sentinel).all())


def test_block_partials_match_dense_block():
    """The kernel's plain partials against the ring's dense partials
    (``_block_attn``) of the same pair: the JAX test's tolerances."""
    q, k, v = (torch.tensor(x) for x in draws(3, B, S, H, D))
    q_pos, k_pos = (torch.tensor(p) for p in positions("full"))
    o, m, l = CA.ring_block_fwd(q, k, v, q_pos, k_pos, True)
    rm, rl, ro = RA._block_attn(q, k, v, SCALE, q_pos, k_pos, True)
    np.testing.assert_allclose(m.numpy(), rm.numpy(), atol=2e-5)
    np.testing.assert_allclose(l.numpy(), rl.numpy(), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=1e-5, atol=2e-5)


def _ring_lse_delta(tq, tk, tv, tdo, q_pos, k_pos, causal):
    """lse (with the +1e30 sentinel) and delta over the f32 normalized
    output, as the folded ring's forward keeps them."""
    o, m, l = CA.ring_block_fwd(tq, tk, tv, q_pos, k_pos, causal)
    l_safe = l.clamp(min=1e-30)
    out = o / l_safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(l_safe), 1e30)
    delta = (tdo.float() * out).sum(-1).transpose(1, 2).contiguous()
    return lse, delta


def _backward_against_jax(q_pos, k_pos, causal, tag):
    """K8's plain dq, dk, dv and their lse against JAX
    ``_fring_bwd_call`` in interpret mode on the same draws."""
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (
        both(x, tag) for x in draws(11, B, S, H, D, n=4))
    tqp, tkp = torch.tensor(q_pos), torch.tensor(k_pos)
    lse, delta = _ring_lse_delta(tq, tk, tv, tdo, tqp, tkp, causal)
    dq = CA.ring_block_bwd_dq(tq, tk, tv, tdo, lse, delta, tqp, tkp, causal)
    dk, dv = CA.ring_block_bwd_dkdv(tq, tk, tv, tdo, lse, delta, tqp, tkp,
                                    causal)
    fold = JPA._to_folded
    jdq, jdk, jdv = JPA._fring_bwd_call(
        fold(jq), fold(jk), fold(jv), fold(jdo), jnp.asarray(lse.numpy()),
        jnp.asarray(delta.numpy()), jnp.asarray(q_pos)[None],
        jnp.asarray(k_pos)[:, None], H, SCALE, causal, True)
    tol = 1e-5 if tag == "f32" else 2e-4
    for name, t, j in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert t.dtype == torch.float32
        ref = np.asarray(JPA._from_folded(j, H))
        err = float(np.abs(t.numpy() - ref).max())
        assert err <= tol * max(1.0, float(np.abs(ref).max())), (name, err)
    return lse, dq, dk, dv


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_block_backward_matches_jax_kernel(causal, tag):
    """K8's plain backward against JAX ``_fring_bwd_call`` in interpret
    mode. Keys start half a block after the queries, so the first half
    of the query rows sees no key under the causal mask: their lse is
    the +1e30 sentinel and their p must come out exactly 0."""
    q_pos = np.arange(S, dtype=np.int32)
    lse, dq, _, _ = _backward_against_jax(q_pos, q_pos + S // 2, causal, tag)
    if causal:
        assert bool((lse[:, :, :S // 2] == 1e30).all())
        assert float(dq[:, :S // 2].abs().max()) == 0.0


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_block_backward_matches_jax_kernel_on_shuffled_positions(causal,
                                                                 tag):
    """The same with the keys' positions in a seeded permutation and a
    fifth of the keys padded at scattered rows: the visibility the card's
    kernels list tile by tile from unsorted positions. A padded key's dk
    and dv, and the dq of a row that sees no key, are exactly 0."""
    q_pos, k_pos = positions("shuffled")
    lse, dq, dk, dv = _backward_against_jax(q_pos, k_pos, causal, tag)
    pad = torch.tensor(k_pos == CA.PAD_POS)
    assert float(dk[:, pad].abs().max()) == float(dv[:, pad].abs().max()) \
        == 0.0
    empty = lse == 1e30
    if causal:
        assert bool(empty.any())
    assert not bool(dq.transpose(1, 2)[empty].any())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl,tol", [("dense", 2e-6),
                                      ("flash_interpret", 2e-5),
                                      ("folded_interpret", 2e-5)])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring(n, impl, tol, causal):
    """The port's ring on a hosted ``{"seq": n}`` mesh against the JAX
    ring under ``shard_map``; 128 positions a rank, the JAX folded
    tile."""
    s = 128 * n
    q, k, v = draws(n, 1, s, 2, 8)
    want = JRA.ring_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              submesh({"seq": n}), causal=causal,
                              block_impl=impl)
    got = RA.ring_attention(*(torch.tensor(x) for x in (q, k, v)),
                            hosted({"seq": n}), causal=causal,
                            block_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


def test_ring_over_data_and_seq_matches_dense():
    """A hosted ``{"data": 2, "seq": 4}`` mesh (the JAX ring test's mesh)
    against dense attention on the whole sequence."""
    q, k, v = (torch.tensor(x) for x in draws(5, 4, 32, 2, 8))
    for causal in (True, False):
        got = RA.ring_attention(q, k, v, hosted({"data": 2, "seq": 4}),
                                causal=causal)
        want = RA.dense_attention(q, k, v, causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_folded_ring_grads_match_jax_dense_ring(causal):
    """The folded ring's backward (a second ring, dk/dv travelling with
    their block) against JAX's dense ring differentiated by JAX, on
    ``{"seq": 2}`` with 384 positions a rank."""
    q, k, v, w = draws(9, 1, 768, 2, 8, n=4)
    spec = JP(None, "seq")
    jring = jax.jit(JC.shard_map_fn(
        lambda q_, k_, v_: JRA.ring_attention_local(q_, k_, v_, "seq",
                                                    causal,
                                                    block_impl="dense"),
        submesh({"seq": 2}), in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False))
    jw = jnp.asarray(w)
    jout = jring(*(jnp.asarray(x) for x in (q, k, v)))
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(jring(*a)) * jw),
                              argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    tout = RA.ring_attention(tq, tk, tv, hosted({"seq": 2}), causal=causal,
                             block_impl="folded")
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=2e-5)
    tgrads = torch.autograd.grad((torch.sin(tout) * torch.tensor(w)).sum(),
                                 (tq, tk, tv))
    for name, t, j in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-5,
                                   err_msg=f"d{name}")


def test_folded_ring_keeps_the_input_dtype():
    q, k, v, g = (torch.tensor(x).to(torch.bfloat16).requires_grad_()
                  for x in draws(2, 2, 64, 2, 8, n=4))
    out = RA.ring_attention(q, k, v, hosted({"seq": 4}), block_impl="folded")
    out.backward(g.detach())
    assert out.dtype == q.grad.dtype == k.grad.dtype == torch.bfloat16


def test_resolve_block_impl_follows_the_jax_policy():
    cuda = torch.device("cuda")
    # auto: folded from 256 positions at short heads, flash below (not
    # when training), dense on the CPU
    assert RA._resolve_block_impl(1024, 64, h=8, device=cuda) == "folded"
    assert RA._resolve_block_impl(128, 64, h=8, device=cuda) == "flash"
    assert RA._resolve_block_impl(128, 64, True, 8, cuda) == "dense"
    assert RA._resolve_block_impl(1000, 64, h=8, device=cuda) == "flash"
    assert RA._resolve_block_impl(1024, 64, h=8,
                                  device=torch.device("cpu")) == "dense"
    with pytest.raises(ValueError, match="unknown block_impl"):
        RA.ring_attention(*(torch.zeros(1, 8, 1, 8) for _ in range(3)),
                          hosted({"seq": 2}), block_impl="pallas")


def test_folded_block_attn_keeps_the_jax_shape_rule():
    x = torch.zeros(1, 100, 2, 8)
    pos = torch.arange(100)
    with pytest.raises(ValueError, match="128-tileable"):
        CA.folded_block_attn(x, x, x, 1.0, pos, pos, True)
    # the flash twin takes any shape
    m, l, o = CA.flash_block_attn(x, x, x, 1.0, pos, pos, True)
    assert o.shape == x.shape and m.shape == (1, 2, 100)


def test_ring_permute_matches_jax_ppermute():
    """Rank i's block goes to rank i + shift (mod n), on a hosted mesh as
    under ``shard_map``."""
    x = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    spec = JP("seq")
    for shift in (1, -1, 2):
        want = JC.shard_map_fn(lambda a: JC.ring_permute(a, "seq", shift),
                               submesh({"seq": 4}), in_specs=(spec,),
                               out_specs=spec)(jnp.asarray(x))
        got = C.ring_permute(torch.tensor(x)[:, None], hosted(
            {"seq": 4}).axis("seq"), shift)[:, 0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_collectives_on_a_hosted_mesh():
    mesh = hosted({"data": 2, "seq": 3})
    x = torch.arange(6, dtype=torch.float32)             # rank r holds r
    assert C.allreduce_sum(x, mesh.axis("seq")).tolist() == \
        [3, 3, 3, 12, 12, 12]
    assert C.allreduce_mean(x, mesh.axis("data")).tolist() == \
        [1.5, 2.5, 3.5, 1.5, 2.5, 3.5]
    assert C.axis_index(mesh.axis("seq")).tolist() == [0, 1, 2, 0, 1, 2]
    assert C.axis_index(mesh.axis("data")).tolist() == [0, 0, 0, 1, 1, 1]


def test_shard_batch_splits_rows_over_data_and_columns_over_seq():
    mesh = hosted({"data": 2, "seq": 2})
    x = np.arange(3 * 8).reshape(3, 8)
    local, n = shard_batch({"x": x}, mesh)
    assert n == 3 and local["x"].shape == (4, 2, 4)
    # rank (data 1, seq 0): rows 2-3 (row 3 padded with 0), columns 0-3
    np.testing.assert_array_equal(local["x"][2].numpy(),
                                  [[16, 17, 18, 19], [0, 0, 0, 0]])
    np.testing.assert_array_equal(gather_shards(local["x"], mesh)[:n].numpy(),
                                  x)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": np.zeros((2, 7))}, mesh)
    assert process_local_rows(8, mesh) == (0, 8)


def test_mesh_spec_and_build_mesh():
    spec = TP.MeshSpec.from_dict({"data": -1, "seq": 2})
    assert spec.axis_names == ("data", "seq")
    assert spec.resolve(8) == {"data": 4, "seq": 2}
    with pytest.raises(ValueError, match="at most one"):
        TP.MeshSpec.from_dict({"data": -1, "seq": -1}).resolve(4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        TP.MeshSpec.from_dict({"data": 2, "seq": 2}).resolve(2)
    mesh = TP.build_mesh(spec, "cpu")                    # -1 -> 1, hosted
    assert mesh.shape == {"data": 1, "seq": 2} and mesh.n_hosted == 2
    assert mesh.hosted and mesh.coords(1) == (0, 1)


@pytest.mark.parametrize("axis", ["model", "expert", "pipe"])
def test_unsupported_axes_raise(axis):
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        hosted({"data": 1, axis: 2})
    assert hosted({"seq": 2, axis: 1}).n_hosted == 2
    with pytest.raises(ValueError, match="unknown mesh axis"):
        hosted({"tensor": 2})
