"""The port's MoE and int8 decode against the JAX package, on the CPU.

A token-choice MoE target (``tests/test_transformer.py``'s
``test_moe_decode_matches_reference`` shape: 2 layers, 4 experts, top-1
and top-2) and a dense-MLP target served with ``quantized_ffn=True`` go
through the port's ``DecodeScheduler`` on the paged pool cold and then
through the prefix cache, on the dense slot-lane pool, and speculatively
with a 1-layer truncated draft, and through JAX's on its paged pool, on
the same weights (carried across as numpy) and the same greedy payloads.
The greedy tokens must equal JAX's. ``quantize_decode_ffn`` must be
bit-equal to JAX's (the int8 weights and the f32 scales), and
``_q_matmul`` within 1e-6 of JAX's relative to the output's largest magnitude (f32 sums of
exact products, in another order).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.serving import decode as D

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=16, n_heads=4, d_head=8, d_ff=32, n_stages=1,
          layers_per_stage=2)
DEC = dict(n_slots=4, max_len=64, page_size=8)
Q_TOL = 1e-6


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


def _serve(sched, payloads, tag):
    pend = [_Pending(p, f"{tag}{i}") for i, p in enumerate(payloads)]
    for p in pend:
        sched.submit(p)
    for p in pend:
        assert p.event.wait(120), p.rid
    assert [p.status for p in pend] == [200] * len(pend)
    return [json.loads(p.reply)["tokens"] for p in pend]


def _payloads():
    """Greedy requests on two shared preambles (pass 2 hits the prefix
    cache)."""
    rng = np.random.default_rng(5)
    pre = [rng.integers(1, 64, size=16).tolist() for _ in range(2)]
    return [{"prompt": pre[i % 2] + rng.integers(1, 64, size=3 + 2 * i)
             .tolist(), "max_new_tokens": 6 + i} for i in range(4)]


def _runs(jparams, jcfg, cfg, **kw):
    """Each mode's tokens through the port's scheduler, JAX's paged
    scheduler's (cold, then with prefix hits), and both schedulers'
    ``stats()`` after the paged passes. Greedy tokens are the target's
    argmax whatever the pool or the speculation, so every port mode is
    held against JAX's paged tokens (JAX's own dense pool and speculative
    decoder give those tokens too)."""
    nparams = jax.tree.map(np.asarray, jparams)
    nd, dcfg = T.layer_truncated_draft(nparams, cfg, 1)
    modes = {"paged": dict(), "dense_pool": dict(paged=False),
             "speculative": dict(draft_params=nd, draft_cfg=dcfg)}
    out = {"port": {}, "jax": {}}
    runs = [("port", mode, pkw) for mode, pkw in modes.items()]
    for name, mode, pkw in runs + [("jax", "paged", {})]:
        if name == "port":
            sched = D.DecodeScheduler(D.TransformerDecoder(
                nparams, cfg, device="cpu", **DEC, **kw, **pkw))
        else:
            sched = JD.DecodeScheduler(JD.TransformerDecoder(
                jparams, jcfg, **DEC, **kw))
        sched.start()
        try:
            out[name][mode] = _serve(sched, _payloads(), "a")
            if mode != "dense_pool":
                out[name][mode + "_hit"] = _serve(sched, _payloads(), "b")
            out[name][mode + "_stats"] = sched.stats()
        finally:
            sched.stop()
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["top1", "top2"])
def moe_runs(request):
    kw = dict(KW, n_experts=4, moe_top_k=request.param)
    jcfg, cfg = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
    return _runs(JT.init_params(jcfg, seed=1), jcfg, cfg)


@pytest.fixture(scope="module")
def int8_runs():
    jcfg, cfg = JT.TransformerConfig(**KW), T.TransformerConfig(**KW)
    return _runs(JT.init_params(jcfg, seed=2), jcfg, cfg,
                 quantized_ffn=True)


#: each port mode and the JAX paged pass it is held against
MODES = {"paged": "paged", "paged_hit": "paged_hit", "dense_pool": "paged",
         "speculative": "paged", "speculative_hit": "paged_hit"}


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_greedy_decode_matches_jax(moe_runs, mode):
    assert moe_runs["port"][mode] == moe_runs["jax"][MODES[mode]]


def test_moe_runs_hit_the_prefix_cache_and_speculate(moe_runs):
    for name in ("port", "jax"):
        assert moe_runs[name]["paged_stats"]["prefix_cache"]["hits"] > 0
    assert moe_runs["port"]["speculative_stats"]["speculative"][
        "rounds"] > 0
    assert moe_runs["port"]["paged_stats"]["quantized_ffn"] is False


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_greedy_decode_matches_jax(int8_runs, mode):
    assert int8_runs["port"][mode] == int8_runs["jax"][MODES[mode]]


def test_int8_stats_report_quantized_ffn(int8_runs):
    for name in ("port", "jax"):
        assert int8_runs[name]["paged_stats"]["quantized_ffn"] is True


def test_int8_decoder_keeps_int8_weights_and_an_f32_draft():
    cfg = T.TransformerConfig(**KW)
    tree = T.init_params_np(cfg, seed=0)
    dtree, dcfg = T.layer_truncated_draft(tree, cfg, 1)
    dec = D.TransformerDecoder(tree, cfg, device="cpu", quantized_ffn=True,
                               draft_params=dtree, draft_cfg=dcfg, **DEC)
    bp = dec.params["blocks"][0]
    assert bp["w1_q"].dtype == bp["w2_q"].dtype == torch.int8
    assert "w1" not in bp and dec.draft_params["blocks"][0]["w1"].dtype \
        == torch.float32
    # the attention leaves are shared with the draft
    assert dec.draft_params["blocks"][0]["wq"] is bp["wq"]


# ---------------------------------------------------------------------------
# the building blocks and the refusals


@pytest.mark.parametrize("mult", [1.0, 3.0])
def test_quantize_decode_ffn_is_bit_equal_to_jax(mult):
    jcfg, cfg = JT.TransformerConfig(**KW), T.TransformerConfig(**KW)
    tree = jax.tree.map(np.array, JT.init_params(jcfg, seed=4))
    # a zero channel takes the scale 1.0
    tree["blocks"][0]["w1"][0, :, 3] = 0.0
    want = JT.quantize_decode_ffn(tree, jcfg, scale_multiplier=mult)
    got = T.quantize_decode_ffn(tree, cfg, scale_multiplier=mult)
    for bp, wp, src in zip(got["blocks"], want["blocks"], tree["blocks"],
                           strict=True):
        assert set(bp) == set(wp)
        for k in ("w1_q", "w2_q", "w1_s", "w2_s"):
            assert bp[k].numpy().dtype == np.asarray(wp[k]).dtype
            np.testing.assert_array_equal(bp[k].numpy(), np.asarray(wp[k]))
        for k in ("ln1", "wq", "b1", "b2"):
            assert bp[k] is src[k]
    assert float(got["blocks"][0]["w1_s"][0, 3]) == mult


def test_quantize_refuses_moe_and_expert_choice():
    moe = T.TransformerConfig(**dict(KW, n_experts=2))
    with pytest.raises(NotImplementedError, match="dense-MLP configs only"):
        T.quantize_decode_ffn(T.init_params_np(moe), moe)
    ec = T.TransformerConfig(**dict(KW, n_experts=2, moe_capacity_factor=1.0,
                                    moe_router="expert_choice"))
    with pytest.raises(NotImplementedError, match="expert-choice"):
        T.quantize_decode_ffn(T.init_params_np(ec), ec)


def test_expert_choice_decode_refused():
    cfg = T.TransformerConfig(**dict(KW, n_experts=2,
                                     moe_capacity_factor=1.0,
                                     moe_router="expert_choice"))
    with pytest.raises(NotImplementedError, match="expert-choice"):
        D.TransformerDecoder(T.init_params_np(cfg), cfg, device="cpu", **DEC)
    for make in (lambda: T.init_paged_kv_cache(cfg, 5, 8, "cpu"),
                 lambda: T.init_kv_cache(cfg, 2, 16, "cpu")):
        with pytest.raises(NotImplementedError, match="expert-choice"):
            make()


def test_q_matmul_matches_jax():
    """The CPU form (the activation rounded to bf16, the int8 weight
    widened, f32 sums and output) against JAX's bf16 dot with an f32
    result; a product rounded to bf16 before the scale reads far off."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 32)).astype(np.float32)
    w_q = rng.integers(-127, 128, size=(32, 24)).astype(np.int8)
    w_s = rng.uniform(1e-3, 2e-2, size=24).astype(np.float32)
    want = np.asarray(JT._q_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                   jnp.asarray(w_s)))
    args = (torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(w_s))
    got = T._q_matmul(*args).numpy()
    scale = np.abs(want).max()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= Q_TOL * scale
    rounded = (args[0].bfloat16() @ args[1].bfloat16()).float() * args[2]
    assert np.abs(rounded.numpy() - want).max() > 100 * Q_TOL * scale
