"""The port's decode plane (``mmlspark_tpu_torch.serving.decode``)
against the JAX package's scheduler, and its ledgers on their own.

The same payloads through the port's and the JAX ``DecodeScheduler``
(same weights, carried across as numpy) must give the same tokens and
finish reasons — greedy and seeded-sampled alike, cold and through the
prefix cache. Slot and page ledgers must be clean after every release
reason, and the KV pool must never move. The release-reason cases
drive the scheduler's loop body by hand, so each reason is
deterministic.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu_torch.core.resilience import Deadline, ManualClock
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.serving import decode as D

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32, n_stages=1,
          layers_per_stage=2)
JCFG = JT.TransformerConfig(**KW)
CFG = T.TransformerConfig(**KW)
JPARAMS = JT.init_params(JCFG, seed=0)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)


class _Pending:
    """The slice of a pending request the standalone scheduler
    touches."""

    def __init__(self, payload, rid, deadline=None):
        self.payload = payload
        self.rid = rid
        self.deadline = deadline
        self.event = threading.Event()
        self.callbacks = []
        self.reply = None
        self.status = None
        self.span = None


def _decoder(**kw):
    kw = dict(dict(n_slots=4, max_len=64, page_size=8), **kw)
    return D.TransformerDecoder(NPARAMS, CFG, device="cpu", **kw)


def _idle(sched) -> bool:
    """Slots all free and the refcounted page ledger clean: every
    claimable page free or held exactly once by the prefix index."""
    claimable = sched.pages.n_pages - 1
    if sched.pool.n_free != sched.decoder.n_slots:
        return False
    if sched.prefix is None:
        return sched.pages.n_free == claimable
    return (sched.pages.n_free + sched.prefix.n_cached == claimable
            and sched.prefix.ledger_clean())


def _serve(sched, payloads, tag):
    pend = [_Pending(p, f"{tag}{i}") for i, p in enumerate(payloads)]
    for p in pend:
        sched.submit(p)
    for p in pend:
        assert p.event.wait(120), p.rid
    return [json.loads(p.reply) for p in pend], [p.status for p in pend]


def _payloads(seed=7):
    rng = np.random.default_rng(seed)
    pre = [rng.integers(1, 64, size=16).tolist() for _ in range(2)]
    out = []
    for i in range(5):
        prompt = pre[i % 2] + rng.integers(1, 64, size=3 + 2 * i).tolist()
        p = {"prompt": prompt, "max_new_tokens": 6 + i}
        if i == 3:
            p.update(temperature=0.9, top_k=20, seed=11)
        out.append(p)
    return out


@pytest.fixture(scope="module")
def both_runs():
    """Two passes of the same payloads through each scheduler: pass 1
    cold, pass 2 through the prefix cache."""
    runs = {}
    for name, sched in (
            ("port", D.DecodeScheduler(_decoder())),
            ("jax", JD.DecodeScheduler(JD.TransformerDecoder(
                JPARAMS, JCFG, n_slots=4, max_len=64, page_size=8)))):
        ptr = (sched.decoder.cache["k"].data_ptr()
               if name == "port" else None)
        sched.start()
        try:
            p1 = _serve(sched, _payloads(), "a")
            p2 = _serve(sched, _payloads(), "b")
        finally:
            sched.stop()
        runs[name] = dict(pass1=p1, pass2=p2, sched=sched, ptr=ptr,
                          stats=sched.stats())
    return runs


class TestAgainstJaxScheduler:

    @pytest.mark.parametrize("pass_", ["pass1", "pass2"])
    def test_same_tokens_and_reasons(self, both_runs, pass_):
        port, jax_ = both_runs["port"][pass_], both_runs["jax"][pass_]
        assert port[1] == jax_[1] == [200] * 5
        assert [r["tokens"] for r in port[0]] == \
            [r["tokens"] for r in jax_[0]]
        assert [r["finish_reason"] for r in port[0]] == \
            [r["finish_reason"] for r in jax_[0]]

    def test_second_pass_hits_prefix_cache_with_same_tokens(self,
                                                            both_runs):
        run = both_runs["port"]
        stats = run["stats"]["prefix_cache"]
        assert stats["hits"] >= 5 and stats["hit_tokens"] > 0
        assert stats["hits"] == \
            both_runs["jax"]["stats"]["prefix_cache"]["hits"]
        assert [r["tokens"] for r in run["pass1"][0]] == \
            [r["tokens"] for r in run["pass2"][0]]

    def test_ledger_clean_and_pool_in_place(self, both_runs):
        run = both_runs["port"]
        sched = run["sched"]
        assert _idle(sched)
        assert sched.decoder.cache["k"].data_ptr() == run["ptr"]
        assert run["stats"]["n_step_faults"] == 0
        assert run["stats"]["pages"]["high_water"] == \
            both_runs["jax"]["stats"]["pages"]["high_water"]


class TestReleaseReasons:
    """Each finish reason returns its slot and pages; the scheduler's
    loop body runs by hand (no thread)."""

    def _sched(self, **kw):
        clock = ManualClock()
        dec_kw = {k: kw.pop(k) for k in ("eos_id",) if k in kw}
        return D.DecodeScheduler(_decoder(**dec_kw), clock=clock,
                                 **kw), clock

    def _reply(self, p):
        assert p.event.is_set()
        return json.loads(p.reply)

    def test_eos(self):
        prompt = list(range(1, 12))
        first = _decoder().prefill(0, np.asarray(prompt, np.int32))
        sched, _ = self._sched(eos_id=first)
        p = _Pending({"prompt": prompt, "max_new_tokens": 8}, "eos")
        sched.submit(p)
        sched._admit_waiting()
        assert self._reply(p)["finish_reason"] == "eos"
        assert _idle(sched)

    def test_length(self):
        sched, _ = self._sched()
        p = _Pending({"prompt": list(range(3, 20)), "max_new_tokens": 3},
                     "len")
        sched.submit(p)
        sched._admit_waiting()
        for _ in range(2):
            sched._run_step()
        r = self._reply(p)
        assert (r["finish_reason"], r["n_tokens"]) == ("length", 3)
        assert _idle(sched)

    def test_cancel_in_slot(self):
        sched, _ = self._sched()
        p = _Pending({"prompt": list(range(5, 30)), "max_new_tokens": 30},
                     "c")
        sched.submit(p)
        sched._admit_waiting()
        sched._run_step()
        assert sched.cancel("c")
        sched._run_step()
        r = self._reply(p)
        assert (r["finish_reason"], r["n_tokens"]) == ("cancelled", 2)
        assert _idle(sched)

    def test_deadline_mid_decode(self):
        sched, clock = self._sched()
        p = _Pending({"prompt": list(range(2, 9)), "max_new_tokens": 30},
                     "d", deadline=Deadline(1.0, clock=clock))
        sched.submit(p)
        sched._admit_waiting()
        sched._run_step()
        clock.advance(2.0)
        sched._run_step()
        assert p.status == 504
        assert self._reply(p)["finish_reason"] == "deadline"
        assert _idle(sched)

    def test_step_fault_releases_everything(self):
        class FailOnce:
            def __init__(self):
                self.armed = True

            def raise_at(self, site, clock=None):
                if site == "decode_step" and self.armed:
                    self.armed = False
                    raise RuntimeError("injected")

        sched, _ = self._sched(fault_plan=FailOnce())
        p = _Pending({"prompt": list(range(1, 9)), "max_new_tokens": 5},
                     "f")
        sched.submit(p)
        sched._admit_waiting()
        sched._run_step()
        assert p.status == 500 and sched.n_step_faults == 1
        assert self._reply(p)["finish_reason"] == "error"
        # a faulted request publishes nothing into the prefix index
        assert sched.prefix.n_cached == 0
        assert _idle(sched)

    def test_page_exhaustion_sheds_at_submit(self):
        dec = _decoder(n_slots=2, max_len=16, page_size=4, n_pages=5)
        sched = D.DecodeScheduler(dec)
        hog = _Pending({"prompt": list(range(1, 14)), "max_new_tokens": 2},
                       "hog")
        sched.submit(hog)
        sched._admit_waiting()
        with pytest.raises(D.DecodeOverloaded, match="page pool"):
            sched.submit(_Pending({"prompt": [1, 2, 3, 4],
                                   "max_new_tokens": 2}, "victim"))
        sched._run_step()
        assert self._reply(hog)["finish_reason"] == "length"


class TestSurface:

    def test_draft_params_refused(self):
        """Speculation is served (tests/test_torch_speculative.py); a
        draft tree without its config is still refused."""
        with pytest.raises(ValueError, match="draft_params needs draft_cfg"):
            _decoder(draft_params=NPARAMS)
        assert _decoder(draft_params=NPARAMS, draft_cfg=CFG).has_draft

    def test_registry_refused(self):
        with pytest.raises(NotImplementedError, match="registry"):
            D.DecodeScheduler(_decoder(), registry=object())

    def test_device_resolution(self):
        dec = _decoder()
        assert dec.device == torch.device("cpu")
        assert dec.attn_impl == "dense"
        assert dec.params["embed"].device == torch.device("cpu")
        with pytest.raises(ValueError, match="CUDA device"):
            _decoder(attn_impl="cuda")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                D.TransformerDecoder(NPARAMS, CFG, n_slots=2, max_len=16,
                                     page_size=8)

    @pytest.mark.parametrize("payload,match", [
        ({"prompt": []}, "prompt"),
        ({"prompt": [True, 1]}, "prompt"),
        ({"prompt": [64]}, "out of range"),
        ({"prompt": list(range(1, 64)) + [1]}, "max_len"),
        ({"prompt": [1], "max_new_tokens": 0}, "max_new_tokens"),
        ({"prompt": [1], "temperature": -1}, "temperature"),
        ({"prompt": [1], "top_p": 0}, "top_p"),
        ({"prompt": [1], "seed": "x"}, "seed"),
    ])
    def test_bad_payloads_refused(self, payload, match):
        sched = D.DecodeScheduler(_decoder())
        with pytest.raises(ValueError, match=match):
            sched.parse(payload)

    def test_sampler_matches_jax_sampler(self):
        logits = np.random.default_rng(0).normal(size=64).astype(
            np.float32)
        a = D.Sampler(0.7, top_k=10, top_p=0.9, seed=5)
        b = JD.Sampler(0.7, top_k=10, top_p=0.9, seed=5)
        assert [a.sample(logits) for _ in range(20)] == \
            [b.sample(logits) for _ in range(20)]

    def test_prefix_cache_ops_match_jax(self):
        """One scripted sequence of lookup / claim / evict / publish on
        the port's and the JAX page pool + radix index gives the same
        results and the same ledger at every step."""
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 3, size=4 * (1 + i % 3) + 1)
                   for i in range(12)]
        out = {}
        for mod in (D, JD):
            pool = mod.PagePool(13)
            pc = mod.PrefixCache(pool, 4, max_pages=6)
            log = []
            for prompt in prompts:
                hit, shared = pc.lookup(prompt)
                need = len(prompt) // 4 + 1 - len(shared)
                own = pool.claim(need)
                if own is None:
                    pc.evict_for(need)
                    own = pool.claim(need)
                absorbed = pc.publish(prompt, shared + own)
                pool.release([p for p in shared + own
                              if p not in absorbed])
                log.append((hit, len(shared), sorted(absorbed),
                            pool.n_free, pc.n_cached, pc.ledger_clean()))
            out[mod.__name__] = log
        assert out[D.__name__] == out[JD.__name__]
