"""The port's dense slot-lane decode pool (``TransformerDecoder(
paged=False)``) against its paged pool and against the JAX package's
dense scheduler.

The dense pool keeps one ``max_len`` lane per slot and runs plain
PyTorch attention: a request claims and frees a slot only. Held here:
greedy tokens equal to the paged scheduler's and to the JAX full-context
oracle (the port's counterpart of JAX's
``test_paged_tokens_match_dense_scheduler``); tokens, finish reasons
and every metric family equal to the JAX dense scheduler's on the same
run; JAX's refusals (speculation, the prefix cache and a kernel engine
need the paged pool); ``stats()`` reporting the dense mode; and the
pool's ``data_ptr`` stable across the run.
"""

import json

import numpy as np
import pytest
import torch

from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu_torch.serving import decode as D
from test_torch_decode import CFG, JCFG, JPARAMS, NPARAMS, _Pending, _payloads
from test_torch_decode_metrics import assert_same_metrics, drive
from test_torch_serving_decode import _greedy_reference
from test_torch_speculative import CFG as SCFG, DCFG, JDP, NP_TREE, _np

torch.set_num_threads(1)


def _serve(sched, payloads, tag="r"):
    pend = [_Pending(p, f"{tag}{i}") for i, p in enumerate(payloads)]
    for p in pend:
        sched.submit(p)
    for p in pend:
        assert p.event.wait(60), p.rid
    return [json.loads(p.reply) for p in pend], [p.status for p in pend]


def _prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(1, 64, size=n).tolist() for n in (1, 3, 6, 9)]


@pytest.mark.parametrize("n_slots", [2, 4])
def test_dense_tokens_match_paged_scheduler(n_slots):
    """The same prompts through a dense and a paged port scheduler give
    equal greedy tokens, equal to the JAX full-context oracle."""
    payloads = [{"prompt": p, "max_new_tokens": 5} for p in _prompts()]
    outs = {}
    for name, kw in (("dense", dict(paged=False)),
                     ("paged", dict(paged=True, page_size=8, n_pages=9))):
        dec = D.TransformerDecoder(NPARAMS, CFG, n_slots=n_slots,
                                   max_len=64, device="cpu", **kw)
        sched = D.DecodeScheduler(dec).start()
        try:
            replies, status = _serve(sched, payloads)
        finally:
            sched.stop()
        assert status == [200] * len(payloads)
        assert sched.pool.n_free == n_slots
        outs[name] = [r["tokens"] for r in replies]
    assert outs["dense"] == outs["paged"]
    for p, toks in zip(payloads, outs["dense"]):
        assert toks == _greedy_reference(p["prompt"], 5)


@pytest.fixture(scope="module")
def dense_runs():
    """JAX's and the port's dense schedulers over the same payloads
    (greedy and one seeded sample; one request cancelled mid-decode),
    the loop body driven by hand on manual clocks."""
    payloads = _payloads()
    payloads.append({"prompt": [5, 6, 7, 8], "max_new_tokens": 40})
    return {
        "port": drive("port", lambda: D.TransformerDecoder(
            NPARAMS, CFG, n_slots=4, max_len=64, paged=False,
            device="cpu"), payloads, cancel_after=(4, 5)),
        "jax": drive("jax", lambda: JD.TransformerDecoder(
            JPARAMS, JCFG, n_slots=4, max_len=64, paged=False),
            payloads, cancel_after=(4, 5))}


def test_dense_tokens_and_reasons_match_jax(dense_runs):
    port, jax_ = dense_runs["port"], dense_runs["jax"]
    assert [r["tokens"] for r in port["replies"]] == \
        [r["tokens"] for r in jax_["replies"]]
    reasons = [r["finish_reason"] for r in port["replies"]]
    assert reasons == [r["finish_reason"] for r in jax_["replies"]]
    assert reasons.count("cancelled") == 1


def test_dense_metrics_match_jax(dense_runs):
    """The dense scheduler registers JAX's dense families (no page
    gauges, no pool-bytes gauge) with equal values."""
    assert_same_metrics(dense_runs["jax"]["registry"],
                        dense_runs["port"]["registry"])
    names = {f.name for f in dense_runs["port"]["registry"].families()}
    assert "serving_decode_pages_free" not in names
    assert "serving_decode_kv_pool_bytes" not in names


def test_dense_stats_match_jax(dense_runs):
    port = dense_runs["port"]["sched"].stats()
    jax_ = dense_runs["jax"]["sched"].stats()
    assert port["paged"] is False and jax_["paged"] is False
    assert port["pages"] is None and jax_["pages"] is None
    assert port["prefix_cache"] is None and jax_["prefix_cache"] is None
    assert port["attn_impl"] == jax_["attn_impl"] == "dense"
    for key in ("n_slots", "slots_in_use", "slots_free", "max_len",
                "n_requests", "n_steps", "n_tokens", "n_prefills",
                "releases"):
        assert port[key] == jax_[key], key
    sched = dense_runs["port"]["sched"]
    assert sched.pages is None and sched._tables is None
    assert sched.pool.n_free == sched.decoder.n_slots


def test_dense_pool_stays_in_place():
    """The preallocated lanes keep their ``data_ptr`` across prefills
    and steps; the decoder reports no pages."""
    dec = D.TransformerDecoder(NPARAMS, CFG, n_slots=3, max_len=32,
                               paged=False, device="cpu")
    assert (dec.page_size, dec.pages_per_slot, dec.n_pages) == (0, 0, 0)
    assert dec.attn_impl == "dense" and not dec.has_prefix_prefill
    assert tuple(dec.cache["k"].shape) == (
        CFG.n_layers, 3, 32, CFG.n_heads, CFG.d_head)
    ptrs = (dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr())
    dec.warmup()
    sched = D.DecodeScheduler(dec).start()
    try:
        _, status = _serve(sched, [{"prompt": p, "max_new_tokens": 4}
                                   for p in _prompts()])
    finally:
        sched.stop()
    assert status == [200] * 4
    assert (dec.cache["k"].data_ptr(), dec.cache["v"].data_ptr()) == ptrs
    assert sched.stats()["slots_free"] == 3


class TestRefusals:

    def test_spec_requires_paged(self):
        """JAX's ``test_spec_requires_paged_and_matching_vocab``."""
        with pytest.raises(ValueError, match="paged"):
            D.TransformerDecoder(NP_TREE, SCFG, n_slots=2, max_len=32,
                                 paged=False, draft_params=_np(JDP),
                                 draft_cfg=DCFG, device="cpu")

    def test_prefix_cache_requires_paged(self):
        dec = D.TransformerDecoder(NPARAMS, CFG, n_slots=2, max_len=32,
                                   paged=False, device="cpu")
        with pytest.raises(ValueError, match="paged pool"):
            D.DecodeScheduler(dec, prefix_cache=True)
        # "auto" (the default) and False build no prefix cache
        assert D.DecodeScheduler(dec).prefix is None
        assert D.DecodeScheduler(dec, prefix_cache=False).prefix is None

    @pytest.mark.parametrize("impl", ["cuda", "pallas"])
    def test_kernel_engine_needs_the_paged_cache(self, impl):
        with pytest.raises(ValueError, match="needs the paged cache"):
            D.TransformerDecoder(NPARAMS, CFG, n_slots=2, max_len=32,
                                 paged=False, attn_impl=impl, device="cpu")
        with pytest.raises(ValueError, match="needs the paged cache"):
            JD.TransformerDecoder(JPARAMS, JCFG, n_slots=2, max_len=32,
                                  paged=False, attn_impl="pallas")

    def test_dense_engine_is_accepted(self):
        dec = D.TransformerDecoder(NPARAMS, CFG, n_slots=2, max_len=32,
                                   paged=False, attn_impl="dense",
                                   device="cpu")
        assert dec.attn_impl == "dense"
