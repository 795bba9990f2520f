"""The port's speculative decoding against the JAX package's.

Builders (``mmlspark_tpu_torch.models.transformer``): the draft's dense
slot-lane pool, its prefill and step, the chained propose, and the
width-k paged verify with its proposal scores, each fed the same numpy
weights and inputs as its JAX counterpart. Tolerances: logits and
scores within 1e-4 (the JAX engine-parity bound), written cache rows
within 1e-5, greedy tokens and proposals exactly equal. Page 0 is the
scratch page and is left out of cache comparisons.

Scheduler (``mmlspark_tpu_torch.serving.decode``): greedy speculative
tokens equal the JAX ``reference_logits`` greedy continuation, a
per-request opt-out never speculates, and a seeded sampled opt-in gives
the JAX scheduler's tokens on the same tree and seed.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu.serving.policy import SpeculationPolicy as JPolicy
from mmlspark_tpu.testing.decode_load import (
    make_spec_model_pair as jax_spec_pair,
)
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.serving import decode as D
from mmlspark_tpu_torch.serving.policy import SpeculationPolicy
from mmlspark_tpu_torch.testing.decode_load import make_spec_model_pair

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32, n_stages=1,
          layers_per_stage=4)
JCFG = JT.TransformerConfig(**KW)
CFG = T.TransformerConfig(**KW)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
# (port prefill engine, JAX engine): the plain attention against the JAX
# dense engine, and the K2 wrapper (its plain version on CPU tensors)
# against the JAX Pallas kernel interpreted
ENGINES = [("dense", "dense"), ("cuda", "pallas_interpret")]
# (port verify score engine, JAX engine)
CE_ENGINES = [("dense", "xla"), ("cuda", "fused_interpret")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# the JAX spec pair (resid-scaled, 1-layer truncated draft) and the same
# weights as the port's params
JP, JDP, JDCFG = jax_spec_pair(JCFG, draft_layers=1)
NP_TREE = _np(JP)
P = T.params_from_jax(NP_TREE, "cpu")
DCFG = dataclasses.replace(CFG, layers_per_stage=1)
DP, _ = T.layer_truncated_draft(P, CFG, 1)


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _pad(prompt, bucket):
    out = np.zeros(bucket, np.int32)
    out[:len(prompt)] = prompt
    return out


def _bucket(n):
    b = 1
    while b < n:
        b *= 2
    return b


def _to_port(jcache):
    return {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}


def _assert_cache(port, jcache, skip_scratch=False):
    lo = 1 if skip_scratch else 0
    for k in ("k", "v"):
        np.testing.assert_allclose(port[k].numpy()[:, lo:],
                                   np.asarray(jcache[k])[:, lo:],
                                   **CACHE_TOL)


_REF_LEN = 32
_ref_logits = jax.jit(lambda toks: JT.reference_logits(JP, toks, JCFG))


def _greedy_reference(prompt, n_new):
    """The JAX full-context oracle, re-run per token. The context is
    zero-padded to one length (one compile): causal attention keeps the
    padding out of the logits at the context's last position."""
    ctx, out = [int(t) for t in prompt], []
    for _ in range(n_new):
        lg = _ref_logits(jnp.asarray([_pad(ctx, _REF_LEN)]))
        out.append(int(jnp.argmax(lg[0, len(ctx) - 1])))
        ctx.append(out[-1])
    return out


class TestModelPair:

    def test_spec_pair_matches_jax_and_aliases(self):
        tree, dtree, dcfg = make_spec_model_pair(
            CFG, draft_layers=1, params=_np(JT.init_params(JCFG, seed=0)))
        assert dcfg == DCFG
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(NP_TREE)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(dtree), jax.tree.leaves(_np(JDP))):
            np.testing.assert_array_equal(a, b)
        assert dtree["embed"] is tree["embed"]
        assert dtree["blocks"][0] is tree["blocks"][0]

    def test_numpy_pair_scales_output_projections(self):
        base = T.init_params_np(CFG, seed=4)
        tree, _, _ = make_spec_model_pair(CFG, draft_layers=2, seed=4)
        b0, t0 = base["blocks"][0], tree["blocks"][0]
        np.testing.assert_array_equal(t0["wo"], b0["wo"] * 0.05)
        np.testing.assert_array_equal(t0["w2"], b0["w2"] * 0.05)
        np.testing.assert_array_equal(t0["wq"], b0["wq"])

    def test_truncated_draft_aliases_port_tensors(self):
        assert DP["embed"] is P["embed"] and DP["head"] is P["head"]
        assert DP["blocks"][0] is P["blocks"][0]
        with pytest.raises(ValueError, match="draft layers"):
            T.layer_truncated_draft(P, CFG, 5)
        with pytest.raises(ValueError, match="n_stages"):
            T.layer_truncated_draft(
                P, dataclasses.replace(CFG, n_stages=2), 1)

    def test_decoder_draft_shares_the_target_tensors(self):
        tree, dtree, dcfg = make_spec_model_pair(CFG, draft_layers=2)
        dec = D.TransformerDecoder(tree, CFG, n_slots=2, max_len=32,
                                   page_size=8, draft_params=dtree,
                                   draft_cfg=dcfg, device="cpu")
        assert dec.draft_params["embed"] is dec.params["embed"]
        for db, tb in zip(dec.draft_params["blocks"], dec.params["blocks"]):
            assert all(db[k] is tb[k] for k in tb)
        # tensors already on the device are kept as they are
        again = T.params_from_jax(dec.params, "cpu")
        assert again["head"] is dec.params["head"]


class TestDraftDenseCache:
    SLOTS, MAX_LEN = 3, 32

    def test_init_kv_cache_layout(self):
        c = T.init_kv_cache(CFG, self.SLOTS, self.MAX_LEN, "cpu")
        assert c["k"].shape == (4, 3, 32, 2, 8)
        assert c["v"].dtype == torch.float32 and not c["v"].any()

    def _prefilled(self, impl, jax_impl):
        """Slots 0 and 1 prefilled by each side; slot 2 free."""
        rng = np.random.default_rng(9)
        prompts = [rng.integers(1, 64, size=n).astype(np.int32)
                   for n in (5, 13)]
        jpre = JT.build_prefill(JDCFG, donate=False, attn_impl=jax_impl)
        pre = T.build_prefill(DCFG, attn_impl=impl)
        jc = JT.init_kv_cache(JDCFG, self.SLOTS, self.MAX_LEN)
        cache = T.init_kv_cache(DCFG, self.SLOTS, self.MAX_LEN, "cpu")
        firsts = []
        for s, pr in enumerate(prompts):
            pad = _pad(pr, _bucket(len(pr)))
            jc, jn, jl = jpre(JDP, jc, jnp.asarray(pad), np.int32(s),
                              np.int32(len(pr)))
            c, n, logits = pre(DP, cache, _i32(pad), s, len(pr))
            assert c is cache and int(n) == int(jn)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            firsts.append(int(n))
        _assert_cache(cache, jc)
        return prompts, firsts, jc, cache

    @pytest.mark.parametrize("impl,jax_impl", ENGINES)
    def test_prefill_matches_jax(self, impl, jax_impl):
        self._prefilled(impl, jax_impl)

    def test_steps_match_jax(self):
        """Four greedy steps of every slot; slot 2 rides past the lane
        end (pos 33 > max_len), where JAX drops the write — the port's
        pool must come out the same."""
        prompts, firsts, jc, cache = self._prefilled("dense", "dense")
        jstep = JT.build_decode_step(JDCFG, self.SLOTS, self.MAX_LEN,
                                     donate=False)
        step = T.build_decode_step(DCFG, self.SLOTS, self.MAX_LEN)
        cur = np.array(firsts + [7], np.int32)
        pos = np.array([len(p) for p in prompts] + [33], np.int32)
        for _ in range(4):
            jc, jn, jl = jstep(JDP, jc, jnp.asarray(cur), jnp.asarray(pos))
            _, n, logits = step(DP, cache, _i32(cur), _i32(pos))
            np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            _assert_cache(cache, jc)
            cur, pos = np.asarray(jn).copy(), pos + 1

    def test_propose_matches_jax(self):
        prompts, firsts, jc, cache = self._prefilled("dense", "dense")
        width = 4
        jprop = JT.build_draft_propose(JDCFG, self.SLOTS, self.MAX_LEN,
                                       width, donate=False)
        prop = T.build_draft_propose(DCFG, self.SLOTS, self.MAX_LEN, width)
        cur = np.array(firsts + [0], np.int32)
        pos = np.array([len(p) for p in prompts] + [30], np.int32)
        jc, jprops = jprop(JDP, jc, jnp.asarray(cur), jnp.asarray(pos))
        c, props = prop(DP, cache, _i32(cur), _i32(pos))
        assert c is cache and props.dtype == torch.int32
        np.testing.assert_array_equal(props.numpy(), np.asarray(jprops))
        _assert_cache(cache, jc)

    def test_lane_mismatch_refused(self):
        step = T.build_decode_step(DCFG, 2, 16)
        with pytest.raises(ValueError, match="cache lanes"):
            step(DP, T.init_kv_cache(DCFG, 3, 16, "cpu"), _i32([0] * 3),
                 _i32([0] * 3))


class TestVerifyStep:
    W, SLOTS, PS, PPS = 4, 3, 8, 4

    @pytest.mark.parametrize("impl,jax_impl", CE_ENGINES)
    def test_verify_matches_jax(self, impl, jax_impl):
        """Slot 0 mid-lane, slot 1 at the lane end (its window spills
        past row 31 and must ride the scratch page), slot 2 free on an
        all-scratch table: greedy, logits, scores and the pool rows."""
        n_pages = 1 + self.SLOTS * self.PPS
        rng = np.random.default_rng(17)
        tables = np.zeros((self.SLOTS, self.PPS), np.int32)
        tables[:2] = rng.permutation(np.arange(1, n_pages))[:2 * self.PPS] \
            .reshape(2, self.PPS)
        jpre = JT.build_paged_prefill(JCFG, self.PS, self.PPS, donate=False)
        jc = JT.init_paged_kv_cache(JCFG, n_pages, self.PS)
        pos = np.array([6, 30, 0], np.int32)
        first = np.zeros(self.SLOTS, np.int32)
        for s in range(2):
            pr = rng.integers(1, 64, size=int(pos[s])).astype(np.int32)
            jc, jn, _ = jpre(JP, jc, jnp.asarray(_pad(pr, 32)),
                             jnp.asarray(tables[s]), np.int32(len(pr)))
            first[s] = int(jn)
        toks = np.concatenate(
            [first[:, None], rng.integers(1, 64, size=(self.SLOTS,
                                                       self.W - 1))],
            axis=1).astype(np.int32)
        cache = _to_port(jc)
        jver = JT.build_paged_verify_step(JCFG, self.SLOTS, self.W, self.PS,
                                          self.PPS, donate=False,
                                          with_scores=True, ce_impl=jax_impl)
        ver = T.build_paged_verify_step(CFG, self.SLOTS, self.W, self.PS,
                                        self.PPS, with_scores=True,
                                        ce_impl=impl)
        jc, jg, jl, js = jver(JP, jc, jnp.asarray(toks), jnp.asarray(pos),
                              jnp.asarray(tables))
        c, g, logits, scores = ver(P, cache, _i32(toks), _i32(pos),
                                   _i32(tables))
        assert c is cache and g.dtype == torch.int32
        assert scores.shape == (self.SLOTS, self.W - 1)
        np.testing.assert_array_equal(g.numpy()[:2], np.asarray(jg)[:2])
        np.testing.assert_allclose(logits.numpy()[:2], np.asarray(jl)[:2],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(scores.numpy()[:2], np.asarray(js)[:2],
                                   **LOGIT_TOL)
        _assert_cache(cache, jc, skip_scratch=True)
        # the scores are the log-probs of the proposed tokens
        lp = torch.log_softmax(logits[:, :-1].double(), dim=-1)
        want = torch.gather(lp, -1, _i32(toks[:, 1:, None]).long())[..., 0]
        np.testing.assert_allclose(scores.numpy(), want.numpy(), atol=1e-5)

    def test_without_scores_and_unknown_engine(self):
        ver = T.build_paged_verify_step(CFG, 1, 2, 8, 2)
        cache = T.init_paged_kv_cache(CFG, 3, 8, "cpu")
        out = ver(P, cache, _i32([[1, 2]]), _i32([0]), _i32([[1, 2]]))
        assert len(out) == 3 and out[2].shape == (1, 2, 64)
        with pytest.raises(ValueError, match="ce_impl"):
            T.build_paged_verify_step(CFG, 2, 4, 8, 4, with_scores=True,
                                      ce_impl="fused")


class TestSelfDraft:

    def test_self_draft_full_acceptance_matches_reference(self):
        """The target as its own draft: every proposal verifies
        (acceptance exactly 1.0) and the emitted stream is the reference
        greedy continuation — rejected-row repair by construction."""
        W, slots, ps, pps = 4, 2, 8, 4
        cache = T.init_paged_kv_cache(CFG, 1 + slots * pps, ps, "cpu")
        prefill = T.build_paged_prefill(CFG, ps, pps)
        verify = T.build_paged_verify_step(CFG, slots, W, ps, pps)
        dcache = T.init_kv_cache(CFG, slots, pps * ps, "cpu")
        dprefill = T.build_prefill(CFG)
        propose = T.build_draft_propose(CFG, slots, pps * ps, W)
        prompt = np.random.default_rng(11).integers(0, 64, size=4) \
            .astype(np.int32)
        tables = np.zeros((slots, pps), np.int32)
        tables[0] = [3, 6, 1, 2]
        _, first, _ = prefill(P, cache, _i32(prompt), _i32(tables[0]), 4)
        dprefill(P, dcache, _i32(prompt), 0, 4)
        emitted = [int(first)]
        pos = np.zeros(slots, np.int32)
        cur = np.zeros(slots, np.int32)
        pos[0], cur[0] = 4, int(first)
        for _ in range(4):
            _, props = propose(P, dcache, _i32(cur), _i32(pos))
            ver_in = np.concatenate([cur[:, None], props.numpy()[:, :W - 1]],
                                    axis=1)
            _, vtok, _ = verify(P, cache, _i32(ver_in), _i32(pos),
                                _i32(tables))
            assert props.numpy()[0].tolist() == vtok.numpy()[0].tolist()
            emitted += vtok.numpy()[0].tolist()
            pos[0] += W
            cur[0] = emitted[-1]
        assert emitted == _greedy_reference(prompt, 17)


class TestEngineResolution:

    def test_verify_ce_engine(self):
        assert T.verify_ce_engine(CFG, 8, 4, device="cpu") == "dense"
        for impl in T.CE_IMPLS:
            cfg = dataclasses.replace(CFG, ce_impl=impl)
            assert T.verify_ce_engine(cfg, 8, 4, device="cpu") == impl
        assert T.verify_ce_engine(CFG, 8, 4, sharded=True,
                                  device="cpu") == "dense"
        with pytest.raises(ValueError, match="ce_impl"):
            T.verify_ce_engine(dataclasses.replace(CFG, ce_impl="fused"),
                               8, 4, device="cpu")

    def _dec(self, **kw):
        return D.TransformerDecoder(NP_TREE, CFG, n_slots=2, max_len=32,
                                    page_size=8, device="cpu", **kw)

    def test_decoder_resolution_and_refusals(self):
        dec = self._dec(draft_params=_np(JDP), draft_cfg=DCFG)
        assert dec.has_draft and dec.verify_ce_impl == "dense"
        assert dec.attn_impl == "dense" and dec.spec_k == 4
        assert not self._dec().has_draft
        with pytest.raises(ValueError, match="needs a CUDA device"):
            self._dec(draft_params=_np(JDP), draft_cfg=DCFG,
                      verify_ce_impl="cuda")
        with pytest.raises(ValueError, match="verify_ce_impl"):
            self._dec(draft_params=_np(JDP), draft_cfg=DCFG,
                      verify_ce_impl="xla")
        with pytest.raises(ValueError, match="share a vocab"):
            self._dec(draft_params=_np(JDP),
                      draft_cfg=dataclasses.replace(DCFG, vocab=32))
        with pytest.raises(ValueError, match="spec_k"):
            self._dec(draft_params=_np(JDP), draft_cfg=DCFG, spec_k=1)


class TestSpeculationPolicy:

    def test_speculation_policy_gates_rounds(self):
        pol = SpeculationPolicy(min_rate=0.5, warmup_rounds=2,
                                reprobe_every=4)
        assert pol.should_speculate()          # warmup always on
        pol.note(8, 8)
        pol.note(8, 8)
        assert pol.should_speculate()          # healthy acceptance
        for _ in range(30):
            pol.note(8, 0)                     # acceptance collapses
        decisions = [pol.should_speculate() for _ in range(8)]
        assert decisions.count(True) == 2      # probes only (every 4)
        assert pol.status()["speculating"] is False

    def test_same_decisions_as_jax_policy(self):
        rng = np.random.default_rng(3)
        ours, theirs = SpeculationPolicy(), JPolicy()
        for _ in range(200):
            assert ours.should_speculate() == theirs.should_speculate()
            acc = int(rng.integers(0, 5)) if rng.random() < 0.7 else 0
            ours.note(4, acc)
            theirs.note(4, acc)
        assert ours.status() == theirs.status()

    def test_scheduler_installs_or_takes_the_policy(self):
        dec = D.TransformerDecoder(NP_TREE, CFG, n_slots=2, max_len=32,
                                   page_size=8, draft_params=_np(JDP),
                                   draft_cfg=DCFG, device="cpu")
        assert isinstance(D.DecodeScheduler(dec).spec_policy,
                          SpeculationPolicy)
        pol = SpeculationPolicy()
        assert D.DecodeScheduler(dec, spec_policy=pol).spec_policy is pol
        assert D.DecodeScheduler(dec, spec_policy=None).spec_policy is None
        plain = D.TransformerDecoder(NP_TREE, CFG, n_slots=2, max_len=32,
                                     page_size=8, device="cpu")
        sched = D.DecodeScheduler(plain)
        assert sched.spec_policy is None
        assert sched.stats()["speculative"] is None


class _Pending:

    def __init__(self, payload, rid):
        self.payload = payload
        self.rid = rid
        self.deadline = None
        self.event = threading.Event()
        self.callbacks = []
        self.reply = None
        self.status = None
        self.span = None


def _serve(sched, payloads):
    pend = [_Pending(p, f"r{i}") for i, p in enumerate(payloads)]
    sched.start()
    try:
        for p in pend:
            sched.submit(p)
        for p in pend:
            assert p.event.wait(120), p.rid
    finally:
        sched.stop()
    return [json.loads(p.reply) for p in pend], [p.status for p in pend]


def _idle(sched) -> bool:
    return (sched.pool.n_free == sched.decoder.n_slots
            and sched.pages.n_free + sched.prefix.n_cached
            == sched.pages.n_pages - 1 and sched.prefix.ledger_clean())


def _port_decoder(**kw):
    return D.TransformerDecoder(NP_TREE, CFG, n_slots=3, max_len=64,
                                page_size=8, draft_params=_np(JDP),
                                draft_cfg=DCFG, device="cpu", **kw)


PROMPTS = [np.random.default_rng(41).integers(0, 64, size=n).tolist()
           for n in (3, 5, 7)]


class TestSpeculativeScheduler:

    def test_greedy_tokens_equal_reference(self):
        dec = _port_decoder()
        sched = D.DecodeScheduler(dec)
        ptrs = (dec.cache["k"].data_ptr(), dec.draft_cache["k"].data_ptr())
        replies, status = _serve(sched, [{"prompt": p, "max_new_tokens": 10}
                                         for p in PROMPTS])
        assert status == [200] * 3
        for pr, r in zip(PROMPTS, replies):
            assert r["tokens"] == _greedy_reference(pr, 10)
        st = sched.stats()["speculative"]
        assert st["rounds"] == sched.n_spec_rounds > 0
        assert st["proposed"] > 0 and st["acceptance_rate"] is not None
        assert st["proposal_logp_ewma"] <= 0.0
        assert st["verify_ce_impl"] == "dense" and st["draft_layers"] == 1
        assert sched.n_step_faults == 0 and _idle(sched)
        assert (dec.cache["k"].data_ptr(),
                dec.draft_cache["k"].data_ptr()) == ptrs

    def test_per_slot_opt_out(self):
        sched = D.DecodeScheduler(_port_decoder())
        replies, _ = _serve(sched, [{"prompt": PROMPTS[1],
                                     "max_new_tokens": 6,
                                     "speculative": False}])
        assert replies[0]["tokens"] == _greedy_reference(PROMPTS[1], 6)
        assert sched.stats()["speculative"]["rounds"] == 0

    def test_same_tokens_as_jax_scheduler_with_a_sampled_opt_in(self):
        """Two greedy requests and one seeded, sampled, speculative
        request through the port's and the JAX scheduler (same tree, one
        engine on each side's CPU): equal tokens, equal spec ledgers."""
        payloads = [{"prompt": PROMPTS[0], "max_new_tokens": 9},
                    {"prompt": PROMPTS[1], "max_new_tokens": 8,
                     "temperature": 0.9, "seed": 77, "speculative": True},
                    {"prompt": PROMPTS[2], "max_new_tokens": 7}]
        port = D.DecodeScheduler(_port_decoder())
        jax_ = JD.DecodeScheduler(JD.TransformerDecoder(
            JP, JCFG, n_slots=3, max_len=64, page_size=8,
            draft_params=JDP, draft_cfg=JDCFG, attn_impl="dense"))
        got, st_port = _serve(port, payloads)
        want, st_jax = _serve(jax_, payloads)
        assert st_port == st_jax == [200] * 3
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
        assert len(got[1]["tokens"]) == 8
        for key in ("rounds", "proposed", "accepted"):
            assert port.stats()["speculative"][key] == \
                jax_.stats()["speculative"][key]
        assert port.stats()["speculative"]["rounds"] > 0

    def test_lane_end_riders_and_suppressed_rounds_match_jax(self):
        """A 32-row lane: slots near its end leave the cohort and ride
        the verify (their overflow writes on the scratch page); a policy
        that vetoes after 2 rounds forces plain steps with the draft
        catch-up, then probe rounds. Same tokens, reasons and ledgers as
        the JAX scheduler."""
        rng = np.random.default_rng(8)
        payloads = [{"prompt": rng.integers(1, 64, size=n).tolist(),
                     "max_new_tokens": 40} for n in (25, 9, 17)]

        def policy(cls):
            return cls(min_rate=1.1, warmup_rounds=2, reprobe_every=3)

        port = D.DecodeScheduler(
            D.TransformerDecoder(NP_TREE, CFG, n_slots=3, max_len=32,
                                 page_size=8, draft_params=_np(JDP),
                                 draft_cfg=DCFG, device="cpu"),
            spec_policy=policy(SpeculationPolicy))
        jax_ = JD.DecodeScheduler(
            JD.TransformerDecoder(JP, JCFG, n_slots=3, max_len=32,
                                  page_size=8, draft_params=JDP,
                                  draft_cfg=JDCFG, attn_impl="dense"),
            spec_policy=policy(JPolicy))
        got, st_port = _serve(port, payloads)
        want, st_jax = _serve(jax_, payloads)
        assert st_port == st_jax == [200] * 3
        assert [(r["tokens"], r["finish_reason"]) for r in got] == \
            [(r["tokens"], r["finish_reason"]) for r in want]
        a, b = port.stats(), jax_.stats()
        assert a["n_steps"] == b["n_steps"] > 0
        assert a["speculative"]["rounds"] == b["speculative"]["rounds"] > 2
        assert a["speculative"]["policy"] == b["speculative"]["policy"]
        assert _idle(port)
