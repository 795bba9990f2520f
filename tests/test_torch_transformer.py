"""The port's decode numerics (``mmlspark_tpu_torch.models.transformer``)
against the JAX package's builders on the same weights and inputs.

Weights are the JAX ``init_params`` tree carried across as numpy; every
prompt and table is made with numpy from a seed and fed to both sides.
Tolerances: logits within 1e-4 (the JAX engine-parity tests' bound),
written cache rows within 1e-5, greedy tokens exactly equal. Page 0 is
the scratch page: duplicate writes land there in either framework in no
defined order, so it is left out of cache comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu_torch.models import transformer as T

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32, n_stages=1,
          layers_per_stage=2)
JCFG = JT.TransformerConfig(**KW)
CFG = T.TransformerConfig(**KW)
PS, PPS = 8, 4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# (port engine, JAX engine): the plain attention against the JAX dense
# engine, and the port's kernel wrappers (which run the plain versions on
# CPU tensors) against the JAX Pallas kernels in interpret mode
ENGINES = [("dense", "dense"), ("cuda", "pallas_interpret")]
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def params():
    jp = JT.init_params(JCFG, seed=0)
    return jp, T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _bucket(n):
    b = 1
    while b < n:
        b *= 2
    return b


def _pad(prompt, bucket):
    out = np.zeros(bucket, np.int32)
    out[:len(prompt)] = prompt
    return out


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _cache_to_port(jcache):
    return {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}


def _assert_cache(port, jcache):
    for k in ("k", "v"):
        np.testing.assert_allclose(port[k].numpy()[:, 1:],
                                   np.asarray(jcache[k])[:, 1:],
                                   **CACHE_TOL)


class TestParams:

    def test_params_from_jax_round_trips(self, params):
        jp, p = params
        back = jax.tree.map(lambda t: t.numpy(), p)
        ref = jax.tree.map(np.asarray, jp)
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_moe_and_int8_trees_refused(self):
        moe = JT.TransformerConfig(**dict(KW, n_experts=2))
        with pytest.raises(NotImplementedError, match="MoE"):
            T.params_from_jax(JT.init_params(moe, seed=0), "cpu")
        q = JT.quantize_decode_ffn(JT.init_params(JCFG, seed=0), JCFG)
        with pytest.raises(NotImplementedError, match="int8"):
            T.params_from_jax(q, "cpu")

    def test_init_params_np_layout(self):
        tree = T.init_params_np(CFG, seed=3)
        ref = jax.tree.map(np.asarray, JT.init_params(JCFG, seed=0))
        assert jax.tree.structure(tree) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == np.float32

    def test_device_none_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_paged_kv_cache(CFG, 5, PS)


class TestNumerics:

    @pytest.mark.parametrize("seq", [1, 6, 13])
    def test_reference_logits_match_jax(self, params, seq):
        jp, p = params
        toks = np.random.default_rng(seq).integers(
            0, KW["vocab"], size=(2, seq)).astype(np.int32)
        ref = JT.reference_logits(jp, jnp.asarray(toks), JCFG)
        got = T.reference_logits(p, torch.from_numpy(toks).long(), CFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   **LOGIT_TOL)

    def test_rope_pairs_interleaved_channels(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(1, 5, 2, 8)).astype(np.float32)
        pos = np.arange(3, 8)
        ref = JT._rope(jnp.asarray(x), jnp.asarray(pos))
        got = T._rope(torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-6)
        xa = rng.normal(size=(4, 2, 8)).astype(np.float32)
        pa = np.array([0, 9, 31, 200], np.int32)
        ref = JT._rope_at(jnp.asarray(xa), jnp.asarray(pa))
        got = T._rope_at(torch.from_numpy(xa), _i32(pa))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-5)

    def test_unknown_impl_refused(self):
        for build in (lambda: T.build_paged_prefill(CFG, PS, PPS, "pallas"),
                      lambda: T.build_paged_prefix_prefill(CFG, PS, PPS,
                                                           "pallas"),
                      lambda: T.build_paged_decode_step(CFG, 2, PS, PPS,
                                                        "pallas")):
            with pytest.raises(ValueError, match="attn_impl"):
                build()


class TestPagedPrefill:

    @pytest.mark.parametrize("impl,jax_impl", ENGINES)
    @pytest.mark.parametrize("plen", [1, 3, 8, 13])
    def test_cold_prefill_matches_jax(self, params, impl, jax_impl, plen):
        jp, p = params
        rng = np.random.default_rng(plen)
        prompt = rng.integers(1, KW["vocab"], size=plen).astype(np.int32)
        pad = _pad(prompt, _bucket(plen))
        table = np.array([3, 1, 4, 2], np.int32)     # non-contiguous
        n_pages = 1 + PPS
        jpre = JT.build_paged_prefill(JCFG, PS, PPS, donate=False,
                                      attn_impl=jax_impl)
        jc, jn, jl = jpre(jp, JT.init_paged_kv_cache(JCFG, n_pages, PS),
                          jnp.asarray(pad), jnp.asarray(table),
                          np.int32(plen))
        pre = T.build_paged_prefill(CFG, PS, PPS, attn_impl=impl)
        cache = T.init_paged_kv_cache(CFG, n_pages, PS, "cpu")
        c, n, logits = pre(p, cache, _i32(pad), _i32(table), plen)
        assert c is cache                           # updated in place
        assert int(n) == int(jn)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   **LOGIT_TOL)
        _assert_cache(cache, jc)

    # the JAX TestFlashPrefill offset cases; (7, 4, 17) overshoots the
    # lane: its overflow chunk must ride the scratch page
    @pytest.mark.parametrize("impl,jax_impl", ENGINES)
    @pytest.mark.parametrize("pps,hit_pages,suffix", [
        (4, 1, 11), (4, 2, 5), (7, 4, 17)])
    def test_prefix_prefill_matches_jax(self, params, impl, jax_impl, pps,
                                        hit_pages, suffix):
        jp, p = params
        rng = np.random.default_rng(pps * 100 + suffix)
        hit = hit_pages * PS
        length = hit + suffix
        prompt = rng.integers(1, KW["vocab"], size=length).astype(np.int32)
        table = np.arange(1, 1 + pps, dtype=np.int32)
        # the shared pages: the JAX offset prefill at hit 0 of the whole
        # prompt (a previous cold prefill's output)
        cold = JT.build_paged_prefix_prefill(JCFG, PS, pps, donate=False)
        warm, cold_n, cold_l = cold(
            jp, JT.init_paged_kv_cache(JCFG, 1 + pps, PS),
            jnp.asarray(_pad(prompt, _bucket(length))), jnp.asarray(table),
            np.int32(length), np.int32(0))
        pad = _pad(prompt[hit:], _bucket(suffix))
        jf = JT.build_paged_prefix_prefill(JCFG, PS, pps, donate=False,
                                           attn_impl=jax_impl)
        jc, jn, jl = jf(jp, warm, jnp.asarray(pad), jnp.asarray(table),
                        np.int32(length), np.int32(hit))
        f = T.build_paged_prefix_prefill(CFG, PS, pps, attn_impl=impl)
        cache = _cache_to_port(warm)
        _, n, logits = f(p, cache, _i32(pad), _i32(table), length, hit)
        assert int(n) == int(jn) == int(cold_n)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(cold_l),
                                   **LOGIT_TOL)
        _assert_cache(cache, jc)
        # the shared prefix pages were read, never rewritten
        np.testing.assert_array_equal(
            cache["k"].numpy()[:, 1:1 + hit_pages],
            np.asarray(warm["k"])[:, 1:1 + hit_pages])


class TestPagedDecodeStep:

    @pytest.mark.parametrize("impl,jax_impl", ENGINES)
    @pytest.mark.parametrize("plens", [(1, 3, 7), (8, 13, 16)])
    def test_greedy_steps_match_jax(self, params, impl, jax_impl, plens):
        """Three live slots on scrambled tables plus one free slot
        riding at token 0 / pos 0 with an all-scratch table: prefill,
        then 7 greedy steps — tokens exactly equal, logits and cache
        rows within tolerance at every step."""
        jp, p = params
        slots = 4
        n_pages = 1 + slots * PPS
        rng = np.random.default_rng(sum(plens))
        tables = np.zeros((slots, PPS), np.int32)
        tables[:3] = rng.permutation(np.arange(1, n_pages))[:3 * PPS] \
            .reshape(3, PPS)
        prompts = [rng.integers(1, KW["vocab"], size=n).astype(np.int32)
                   for n in plens]
        jpre = JT.build_paged_prefill(JCFG, PS, PPS, donate=False,
                                      attn_impl=jax_impl)
        jstep = JT.build_paged_decode_step(JCFG, slots, PS, PPS,
                                           donate=False, attn_impl=jax_impl)
        pre = T.build_paged_prefill(CFG, PS, PPS, attn_impl=impl)
        step = T.build_paged_decode_step(CFG, slots, PS, PPS,
                                         attn_impl=impl)
        jc = JT.init_paged_kv_cache(JCFG, n_pages, PS)
        cache = T.init_paged_kv_cache(CFG, n_pages, PS, "cpu")
        ptr = cache["k"].data_ptr()
        cur = np.zeros(slots, np.int32)
        pos = np.zeros(slots, np.int32)
        for s, pr in enumerate(prompts):
            pad = _pad(pr, _bucket(len(pr)))
            jc, jn, _ = jpre(jp, jc, jnp.asarray(pad),
                             jnp.asarray(tables[s]), np.int32(len(pr)))
            _, n, _ = pre(p, cache, _i32(pad), _i32(tables[s]), len(pr))
            assert int(n) == int(jn)
            cur[s], pos[s] = int(n), len(pr)
        jtoks, toks = [], []
        for _ in range(7):
            jc, jn, jl = jstep(jp, jc, jnp.asarray(cur), jnp.asarray(pos),
                               jnp.asarray(tables))
            _, n, logits = step(p, cache, _i32(cur), _i32(pos),
                                _i32(tables))
            np.testing.assert_allclose(logits.numpy()[:3],
                                       np.asarray(jl)[:3], **LOGIT_TOL)
            _assert_cache(cache, jc)
            jtoks.append(np.asarray(jn)[:3])
            toks.append(n.numpy()[:3])
            cur[:3] = np.asarray(jn)[:3]
            pos[:3] += 1
        np.testing.assert_array_equal(np.stack(toks), np.stack(jtoks))
        assert cache["k"].data_ptr() == ptr

    def test_greedy_decode_matches_reference_logits(self, params):
        """The port's own full-context oracle: the paged prefill + steps
        give the argmax of ``reference_logits`` re-run over the growing
        context, token for token."""
        _, p = params
        prompt = np.random.default_rng(5).integers(
            1, KW["vocab"], size=6).astype(np.int32)
        table = np.array([[2, 4, 1, 3]], np.int32)
        pre = T.build_paged_prefill(CFG, PS, PPS, attn_impl="cuda")
        step = T.build_paged_decode_step(CFG, 1, PS, PPS, attn_impl="cuda")
        cache = T.init_paged_kv_cache(CFG, 1 + PPS, PS, "cpu")
        _, n, _ = pre(p, cache, _i32(_pad(prompt, 8)), _i32(table[0]), 6)
        toks = [int(n)]
        for i in range(8):
            _, n, _ = step(p, cache, _i32([toks[-1]]), _i32([6 + i]),
                           _i32(table))
            toks.append(int(n[0]))
        ctx, ref = [int(t) for t in prompt], []
        for _ in range(len(toks)):
            lg = T.reference_logits(p, torch.tensor([ctx]), CFG)
            ref.append(int(torch.argmax(lg[0, -1])))
            ctx.append(ref[-1])
        assert toks == ref
