"""The port's attention kernels (K1-K3) against the JAX package.

For each kernel the port's plain PyTorch version — what its wrapper runs
on CPU tensors, and what the Hopper kernel is held against on the card —
must match the JAX Pallas kernel in interpret mode AND the JAX dense
path on the same numpy inputs, within f32 reassociation tolerance
(atol = rtol = 1e-5). The wrappers must route CPU tensors to the plain
versions without counting a launch, and refuse what the kernels do not
take. The kernel-against-plain checks need the card: they live in
``test_torch_kernels_gpu.py`` (which imports no JAX, so it runs on the
card's machine) and in ``chip_smoke.py`` at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel.pallas_attention import (
    flash_prefill_attention as jax_flash_prefill,
    paged_decode_attention as jax_paged_decode,
    paged_prefix_prefill_attention as jax_paged_prefix,
)
from mmlspark_tpu.parallel.ring_attention import dense_attention
from mmlspark_tpu_torch.parallel import cuda_attention as CA

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
H, D = 2, 8


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _jax_dense_decode(q, kp, vp, tables, pos, ps):
    """transformer.py's paged step, dense engine (lane gather + masked
    softmax), in JAX."""
    n, h, d = q.shape
    lane = tables.shape[1] * ps
    lk = jnp.asarray(kp)[tables].reshape(n, lane, h, d)
    lv = jnp.asarray(vp)[tables].reshape(n, lane, h, d)
    s = jnp.einsum("nhk,nshk->nhs", q, lk) * d ** -0.5
    s = jnp.where(jnp.arange(lane)[None, None, :] <= pos[:, None, None],
                  s, -1e30)
    return jnp.einsum("nhs,nshk->nhk", jax.nn.softmax(s, axis=-1), lv)


def _jax_dense_prefix(q, kp, vp, table, hit, ps):
    """transformer.py's prefix prefill, dense engine, in JAX."""
    s_len, h, d = q.shape
    lane = table.shape[0] * ps
    lk = jnp.asarray(kp)[table].reshape(lane, h, d)
    lv = jnp.asarray(vp)[table].reshape(lane, h, d)
    s = jnp.einsum("shk,vhk->shv", q, lk) * d ** -0.5
    qpos = hit + jnp.arange(s_len)
    s = jnp.where(jnp.arange(lane)[None, None, :] <= qpos[:, None, None],
                  s, -1e30)
    return jnp.einsum("shv,vhk->shk", jax.nn.softmax(s, axis=-1), lv)


def _decode_inputs(seed, pos, ps=8, pps=4):
    rng = np.random.default_rng(seed)
    n = len(pos)
    n_pages = 1 + n * pps
    kp = rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
    q = rng.normal(size=(n, H, D)).astype(np.float32)
    # scrambled, non-contiguous page tables
    tables = rng.permutation(np.arange(1, n_pages)).reshape(n, pps) \
        .astype(np.int32)
    return q, kp, vp, tables, np.asarray(pos, np.int32)


def _prefix_inputs(seed, pps, hit_pages, suffix, ps=8):
    rng = np.random.default_rng(seed)
    bucket = 1
    while bucket < suffix:
        bucket *= 2
    kp = rng.normal(size=(1 + pps, ps, H, D)).astype(np.float32)
    vp = rng.normal(size=(1 + pps, ps, H, D)).astype(np.float32)
    q = rng.normal(size=(bucket, H, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, 1 + pps)).astype(np.int32)
    return q, kp, vp, table, hit_pages * ps


class TestPagedDecodeAttention:

    # pos 0 (a lane's first row), the lane end (31), and page edges
    @pytest.mark.parametrize("pos", [[0, 17, 31], [7, 8, 0], [31, 31, 16],
                                     [1, 23, 9]])
    def test_plain_matches_jax_kernel_and_dense(self, pos):
        q, kp, vp, tables, p = _decode_inputs(sum(pos), pos)
        got = CA.paged_decode_attention_plain(
            _t(q), _t(kp), _t(vp), _t(tables, torch.int32),
            _t(p, torch.int32), D ** -0.5, 8).numpy()
        kern = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(p), scale=D ** -0.5,
                                page_size=8, interpret=True)
        dense = _jax_dense_decode(jnp.asarray(q), kp, vp, tables,
                                  jnp.asarray(p), 8)
        np.testing.assert_allclose(got, np.asarray(kern), **TOL)
        np.testing.assert_allclose(got, np.asarray(dense), **TOL)


class TestFlashPrefillAttention:

    @pytest.mark.parametrize("s", [1, 5, 16, 63])
    def test_plain_matches_jax_kernel_and_dense(self, s):
        rng = np.random.default_rng(s)
        q, k, v = (rng.normal(size=(2, s, 3, D)).astype(np.float32)
                   for _ in range(3))
        got = CA.flash_prefill_attention_plain(_t(q), _t(k), _t(v)).numpy()
        kern = jax_flash_prefill(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), interpret=True)
        dense = dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True)
        np.testing.assert_allclose(got, np.asarray(kern), **TOL)
        np.testing.assert_allclose(got, np.asarray(dense), **TOL)


class TestPagedPrefixAttention:

    # the JAX TestFlashPrefill cases; (7, 4, 17) pads the 17-row suffix
    # to a 32-row bucket that reaches past the 7-page lane
    @pytest.mark.parametrize("pps,hit_pages,suffix", [
        (4, 1, 11), (4, 2, 5), (7, 4, 17), (4, 0, 16)])
    def test_plain_matches_jax_kernel_and_dense(self, pps, hit_pages,
                                                suffix):
        q, kp, vp, table, hit = _prefix_inputs(pps + suffix, pps,
                                               hit_pages, suffix)
        got = CA.paged_prefix_prefill_attention_plain(
            _t(q), _t(kp), _t(vp), _t(table, torch.int32), hit,
            D ** -0.5, 8).numpy()
        kern = jax_paged_prefix(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.int32(hit), scale=D ** -0.5,
                                page_size=8, interpret=True)
        dense = _jax_dense_prefix(jnp.asarray(q), kp, vp, table, hit, 8)
        np.testing.assert_allclose(got, np.asarray(kern), **TOL)
        np.testing.assert_allclose(got, np.asarray(dense), **TOL)


def _cpu_calls():
    """Each wrapper's arguments on CPU tensors + its plain version."""
    q, kp, vp, tables, pos = _decode_inputs(0, [3, 9, 30])
    k1 = ((_t(q), _t(kp), _t(vp), _t(tables, torch.int32),
           _t(pos, torch.int32), D ** -0.5, 8),
          CA.paged_decode_attention, CA.paged_decode_attention_plain)
    rng = np.random.default_rng(1)
    qkv = tuple(_t(rng.normal(size=(1, 9, H, D)).astype(np.float32))
                for _ in range(3))
    k2 = (qkv, CA.flash_prefill_attention,
          CA.flash_prefill_attention_plain)
    q, kp, vp, table, hit = _prefix_inputs(2, 4, 1, 11)
    k3 = ((_t(q), _t(kp), _t(vp), _t(table, torch.int32), hit,
           D ** -0.5, 8),
          CA.paged_prefix_prefill_attention,
          CA.paged_prefix_prefill_attention_plain)
    return {"paged_decode_attention": k1, "flash_prefill_attention": k2,
            "paged_prefix_prefill_attention": k3}


NAMES = ["paged_decode_attention", "flash_prefill_attention",
         "paged_prefix_prefill_attention"]


class TestWrappers:

    @pytest.mark.parametrize("name", NAMES)
    def test_cpu_tensors_take_the_plain_version(self, name):
        args, wrapper, plain = _cpu_calls()[name]
        before = dict(CA.LAUNCHES)
        got = wrapper(*args)
        assert torch.equal(got, plain(*args))
        assert CA.LAUNCHES == before          # no kernel was launched

    @pytest.mark.parametrize("name", NAMES)
    def test_refuses_wrong_dtype(self, name):
        args, wrapper, _ = _cpu_calls()[name]
        bad = (args[0].double(),) + tuple(args[1:])
        with pytest.raises(TypeError, match="float32"):
            wrapper(*bad)

    @pytest.mark.parametrize("name", NAMES)
    def test_refuses_wrong_shape(self, name):
        args, wrapper, _ = _cpu_calls()[name]
        bad = (args[0],) + (args[1][..., :-1].contiguous(),) \
            + tuple(args[2:])
        with pytest.raises(ValueError, match="shape"):
            wrapper(*bad)

    @pytest.mark.parametrize("name", NAMES)
    def test_refuses_non_contiguous(self, name):
        args, wrapper, _ = _cpu_calls()[name]
        k = args[1]
        strided = torch.empty(k.shape[:-1] + (2 * k.shape[-1],))[..., ::2]
        strided.copy_(k)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(*((args[0], strided) + tuple(args[2:])))

    def test_decode_refuses_int64_tables(self):
        args, wrapper, _ = _cpu_calls()["paged_decode_attention"]
        bad = args[:3] + (args[3].long(),) + args[4:]
        with pytest.raises(TypeError, match="int32"):
            wrapper(*bad)

    def test_prefix_refuses_tensor_hit_len(self):
        args, wrapper, _ = _cpu_calls()["paged_prefix_prefill_attention"]
        bad = args[:4] + (torch.tensor(8),) + args[5:]
        with pytest.raises(TypeError, match="hit_len"):
            wrapper(*bad)

    def test_mixed_devices_refused(self):
        args, wrapper, _ = _cpu_calls()["flash_prefill_attention"]
        with pytest.raises(ValueError, match="on meta"):
            wrapper(args[0], args[1].to("meta"), args[2])
