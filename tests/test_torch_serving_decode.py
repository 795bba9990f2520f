"""``POST /generate`` through the port's ``ServingServer`` on both socket
edges, against the JAX package's server on the same requests.

The port's counterparts of ``TestDecodeOverHttp`` and ``TestStreaming``
(``tests/test_serving_decode.py``): greedy tokens over HTTP equal the
JAX full-context reference, replay and join, a 400 then a retryable
request id, a 429 on shedding, ``/decode/stats`` without a decoder,
``/predict`` beside ``/generate``, SSE streaming through the query and
the payload flag, a rejected stream as a plain 400, a mid-stream
disconnect that frees the slot and the pages, the stream counters, and
a streamed ``/generate`` over TLS.

The side-by-side test feeds one script of requests to a JAX server (the
JAX scheduler) and to the port's, per frontend, and holds them equal in
statuses, reply bodies, response header names, ``/decode/stats``
values, ``/stats`` keys and ``/metrics`` family names. The one allowed
difference is ``serving_build_info``'s labels (``torch``/``cuda`` for
``jax``/``jaxlib``), which the family-name comparison does not see.
"""

import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import requests
import torch

from mmlspark_tpu.core.stage import Transformer as JTransformer
from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu.serving.server import ServingServer as JServingServer
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.serving import (
    DecodeScheduler, ServingServer, TransformerDecoder,
)
from mmlspark_tpu_torch.testing.tls import (
    client_context, generate_self_signed_cert, tls_supported,
)

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32, n_stages=1,
          layers_per_stage=2)
JCFG = JT.TransformerConfig(**KW)
CFG = T.TransformerConfig(**KW)
JPARAMS = JT.init_params(JCFG, seed=0)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)
FRONTENDS = ["eventloop", "threaded"]

_REF_LEN = 32
_ref_logits = jax.jit(lambda toks: JT.reference_logits(JPARAMS, toks, JCFG))


def _greedy_reference(prompt, n_new):
    """The JAX full-context oracle, re-run per token on one zero-padded
    length (one compile): causal attention keeps the padding out of the
    logits at the context's last position."""
    ctx, out = [int(t) for t in prompt], []
    for _ in range(n_new):
        toks = np.zeros((1, _REF_LEN), np.int32)
        toks[0, :len(ctx)] = ctx
        lg = np.asarray(_ref_logits(toks))
        t = int(np.argmax(lg[0, len(ctx) - 1]))
        out.append(t)
        ctx.append(t)
    return out


class Identity(Transformer):
    def transform(self, df):
        return df


class JIdentity(JTransformer):
    def transform(self, df):
        return df


def _decoder(n_slots=4, max_len=32, **kw):
    return TransformerDecoder(NPARAMS, CFG, n_slots=n_slots,
                              max_len=max_len, device="cpu", **kw)


def _serve(**kw) -> ServingServer:
    sched = DecodeScheduler(_decoder(**kw.pop("decoder_kw", {})),
                            max_new_tokens_default=8)
    return ServingServer(Identity(), port=0, decoder=sched,
                         max_latency_ms=1.0, verify_checkpoints=False,
                         **kw)


def _prompt(rng, n):
    return [int(t) for t in rng.integers(0, CFG.vocab, size=n)]


def _pages_idle(sched) -> bool:
    """Every claimable page free or held once by the prefix index."""
    claimable = sched.pages.n_pages - 1
    if sched.prefix is None:
        return sched.pages.n_free == claimable
    return (sched.pages.n_free + sched.prefix.n_cached == claimable
            and sched.prefix.ledger_clean())


def _read_chunked_sse(sock):
    """One chunked HTTP response off ``sock``: ``(head, [SSE events])``."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(65536)
    head, _, data = buf.partition(b"\r\n\r\n")
    while b"0\r\n\r\n" not in data:
        chunk = sock.recv(65536)
        if not chunk:
            break
        data += chunk
    body = b""
    while data:
        line, _, data = data.partition(b"\r\n")
        if not line:
            continue
        n = int(line, 16)
        if n == 0:
            break
        body += data[:n]
        data = data[n + 2:]
    events = [json.loads(e.split(b"data: ", 1)[1])
              for e in body.split(b"\n\n") if e.strip()]
    return head, events


def _post_raw(host, port, path, payload, wrap=None):
    s = socket.create_connection((host, port), timeout=30)
    if wrap is not None:
        s = wrap(s)
    body = json.dumps(payload).encode()
    s.sendall(b"POST %s HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              b"Content-Length: %d\r\n\r\n%s"
              % (path.encode(), len(body), body))
    return s


# ---------------------------------------------------------------------------
# the port's TestDecodeOverHttp


class TestDecodeOverHttp:

    @pytest.mark.parametrize("frontend", FRONTENDS)
    def test_generate_end_to_end(self, frontend):
        with _serve(frontend=frontend) as srv:
            rng = np.random.default_rng(8)
            url = f"http://{srv.host}:{srv.port}/generate"
            prompts = [_prompt(rng, 2 + i) for i in range(6)]
            results = {}

            def hit(i):
                results[i] = requests.post(
                    url, json={"prompt": prompts[i],
                               "max_new_tokens": 4}, timeout=60)

            threads = [threading.Thread(target=hit, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for i, pr in enumerate(prompts):
                r = results[i]
                assert r.status_code == 200, r.text
                assert r.json()["tokens"] == _greedy_reference(pr, 4)
            st = requests.get(
                f"http://{srv.host}:{srv.port}/decode/stats",
                timeout=10).json()
            assert st["slots_in_use"] == 0
            assert st["n_requests"] == 6
            assert st["releases"].get("length") == 6
            body = requests.get(
                f"http://{srv.host}:{srv.port}/metrics?scope=server",
                timeout=10).text
            assert "serving_decode_steps_total" in body
            assert "serving_decode_slots_in_use 0" in body
            assert "serving_prefill_latency_ms" in body

    def test_replay_and_join_semantics(self):
        with _serve() as srv:
            url = f"http://{srv.host}:{srv.port}/generate"
            prompt = _prompt(np.random.default_rng(9), 4)
            r1 = requests.post(url, json={"prompt": prompt,
                                          "max_new_tokens": 3},
                               headers={"X-Request-Id": "gen-1"},
                               timeout=30)
            r2 = requests.post(url, json={"prompt": prompt,
                                          "max_new_tokens": 3},
                               headers={"X-Request-Id": "gen-1"},
                               timeout=30)
            assert r1.json() == r2.json()
            assert r2.headers.get("X-Replayed") == "1"
            assert srv.n_replayed == 1
            # exactly one inference ran for the logical request
            assert srv.decoder.stats()["releases"]["length"] == 1

    def test_bad_payload_400_and_retryable_rid(self):
        with _serve() as srv:
            url = f"http://{srv.host}:{srv.port}/generate"
            r = requests.post(url, json={"prompt": []},
                              headers={"X-Request-Id": "bad-1"},
                              timeout=10)
            assert r.status_code == 400
            # the reject removed the in-flight entry: the same rid with
            # a fixed payload re-admits instead of joining a dead one
            r = requests.post(url, json={"prompt": [1, 2],
                                         "max_new_tokens": 2},
                              headers={"X-Request-Id": "bad-1"},
                              timeout=30)
            assert r.status_code == 200

    def test_decode_shed_429(self):
        with _serve(decoder_kw=dict(n_slots=2)) as srv:
            srv.decoder.max_waiting = 0    # everything sheds
            url = f"http://{srv.host}:{srv.port}/generate"
            r = requests.post(url, json={"prompt": [1]}, timeout=10)
            assert r.status_code == 429
            assert "Retry-After" in r.headers
            assert srv.n_shed >= 1

    def test_decode_stats_404_without_decoder(self):
        with ServingServer(Identity(), port=0,
                           verify_checkpoints=False) as srv:
            r = requests.get(
                f"http://{srv.host}:{srv.port}/decode/stats", timeout=10)
            assert r.status_code == 404
            r = requests.post(
                f"http://{srv.host}:{srv.port}/generate",
                json={"prompt": [1]}, timeout=10)
            assert r.status_code == 404

    def test_frame_plane_unaffected_by_decoder(self):
        """``/predict`` still serves frames while ``/generate``
        decodes."""
        with _serve() as srv:
            r = requests.post(srv.address, json={"x": 1.5}, timeout=10)
            assert r.status_code == 200
            g = requests.post(
                f"http://{srv.host}:{srv.port}/generate",
                json={"prompt": [5, 6], "max_new_tokens": 2}, timeout=30)
            assert g.status_code == 200
            assert g.json()["tokens"] == _greedy_reference([5, 6], 2)


# ---------------------------------------------------------------------------
# the port's TestStreaming


class TestStreaming:

    @pytest.mark.parametrize("frontend", FRONTENDS)
    def test_streamed_generate(self, frontend):
        with _serve(frontend=frontend) as srv:
            prompt = _prompt(np.random.default_rng(31), 3)
            s = _post_raw(srv.host, srv.port, "/generate?stream=1",
                          {"prompt": prompt, "max_new_tokens": 5})
            head, events = _read_chunked_sse(s)
            assert b" 200 " in head.split(b"\r\n")[0]
            assert b"text/event-stream" in head
            assert b"chunked" in head.lower()
            toks = [e["token"] for e in events if "done" not in e]
            final = [e for e in events if e.get("done")][0]
            assert final["tokens"] == _greedy_reference(prompt, 5)
            assert toks == final["tokens"]
            assert [e["i"] for e in events
                    if "done" not in e] == list(range(5))
            assert final["finish_reason"] == "length"
            # keep-alive: a plain decode on the same socket
            body = json.dumps({"prompt": prompt,
                               "max_new_tokens": 2}).encode()
            s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            buf = b""
            t_end = time.monotonic() + 20
            while b"\r\n\r\n" not in buf or b"tokens" not in buf:
                c = s.recv(65536)
                if not c or time.monotonic() > t_end:
                    break
                buf += c
            assert b" 200 " in buf.split(b"\r\n")[0]
            s.close()
            assert srv.decoder.pool.n_free == srv.decoder.decoder.n_slots

    def test_stream_flag_in_payload(self):
        """``"stream": true`` in the body streams too (no query)."""
        with _serve() as srv:
            prompt = _prompt(np.random.default_rng(32), 4)
            s = _post_raw(srv.host, srv.port, "/generate",
                          {"prompt": prompt, "max_new_tokens": 3,
                           "stream": True})
            head, events = _read_chunked_sse(s)
            s.close()
            final = [e for e in events if e.get("done")]
            assert final and final[0]["tokens"] == \
                _greedy_reference(prompt, 3)

    def test_stream_bad_payload_is_plain_400(self):
        """A synchronous reject never sends the chunked 200 head."""
        with _serve() as srv:
            s = _post_raw(srv.host, srv.port, "/generate?stream=1",
                          {"prompt": []})
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += s.recv(65536)
            assert b" 400 " in buf.split(b"\r\n")[0]
            assert b"text/event-stream" not in buf
            s.close()

    @pytest.mark.parametrize("frontend", FRONTENDS)
    def test_mid_stream_disconnect_frees_slot_and_pages(self, frontend):
        with _serve(frontend=frontend,
                    decoder_kw=dict(max_len=1024)) as srv:
            sched = srv.decoder
            s = _post_raw(srv.host, srv.port, "/generate?stream=1",
                          {"prompt": _prompt(np.random.default_rng(33), 3),
                           "max_new_tokens": 100_000})
            # see the 200 head (the stream is live), then slam the socket
            assert b" 200 " in s.recv(4096)[:20]
            s.close()
            t_end = time.monotonic() + 30
            while time.monotonic() < t_end and \
                    not sched.stats()["releases"].get("disconnected", 0):
                time.sleep(0.02)
            assert sched.stats()["releases"].get("disconnected", 0) >= 1
            assert sched.pool.n_free == sched.decoder.n_slots
            assert _pages_idle(sched)

    def test_stream_stats_surface(self):
        with _serve() as srv:
            s = _post_raw(srv.host, srv.port, "/generate?stream=1",
                          {"prompt": _prompt(np.random.default_rng(34), 3),
                           "max_new_tokens": 3})
            _read_chunked_sse(s)
            s.close()
            base = f"http://{srv.host}:{srv.port}"
            fr = requests.get(base + "/stats", timeout=10).json()["frontend"]
            assert fr["streams_total"] >= 1
            assert fr["stream_events_total"] >= 4   # 3 tokens + done
            body = requests.get(base + "/metrics?scope=server",
                                timeout=10).text
            assert "serving_streams_total" in body
            assert "serving_decode_pages_free" in body

    @pytest.mark.skipif(not tls_supported()[0],
                        reason="needs the ssl module and the openssl CLI")
    def test_tls_streamed_generate(self, tmp_path):
        cert, key = generate_self_signed_cert(str(tmp_path))
        ctx = client_context(cert)
        with _serve(tls_cert=cert, tls_key=key) as srv:
            prompt = _prompt(np.random.default_rng(35), 3)
            s = _post_raw(srv.host, srv.port, "/generate?stream=1",
                          {"prompt": prompt, "max_new_tokens": 4},
                          wrap=ctx.wrap_socket)
            head, events = _read_chunked_sse(s)
            s.close()
            assert b" 200 " in head.split(b"\r\n")[0]
            final = [e for e in events if e.get("done")][0]
            assert final["tokens"] == _greedy_reference(prompt, 4)
            assert [e["token"] for e in events
                    if "done" not in e] == final["tokens"]


# ---------------------------------------------------------------------------
# the JAX server and the port's, side by side

_JDECODER = None


def _jax_decoder():
    global _JDECODER
    if _JDECODER is None:
        _JDECODER = JD.TransformerDecoder(JPARAMS, JCFG, n_slots=4,
                                          max_len=32)
    return _JDECODER


# /decode/stats keys read off the wall clock
_VOLATILE_STATS = ("latency", "_ms", "_s", "ewma", "rate", "age",
                   "uptime", "ttft", "tpot", "retry_after")


_DECODER_ONLY_KEYS = {"device", "attn_impl_prefill"}


def _stats_values(st):
    """``/decode/stats`` without the wall-clock readings."""
    out = {}
    for k, v in st.items():
        if any(t in k for t in _VOLATILE_STATS):
            continue
        out[k] = _stats_values(v) if isinstance(v, dict) else v
    return out


def _families(text):
    return sorted({ln.split()[2] for ln in text.splitlines()
                   if ln.startswith("# TYPE ")})


def _run_script(srv):
    """One script of requests against a server: a list of
    ``(label, status, body, header names)`` plus its surfaces."""
    base = f"http://{srv.host}:{srv.port}"
    rng = np.random.default_rng(40)
    pa, pb = _prompt(rng, 5), _prompt(rng, 9)
    sampled = {"prompt": pb, "max_new_tokens": 5, "temperature": 0.9,
               "top_k": 20, "seed": 11}
    steps = [
        ("greedy", "/generate", {"prompt": pa, "max_new_tokens": 4},
         {"X-Request-Id": "s-1"}),
        ("replay", "/generate", {"prompt": pa, "max_new_tokens": 4},
         {"X-Request-Id": "s-1"}),
        ("sampled", "/generate", sampled, {}),
        ("prefix", "/generate", {"prompt": pa + [3], "max_new_tokens": 3},
         {}),
        ("eos-free long", "/generate", {"prompt": pb,
                                        "max_new_tokens": 20}, {}),
        ("empty prompt", "/generate", {"prompt": []},
         {"X-Request-Id": "s-bad"}),
        ("retry rid", "/generate", {"prompt": [1, 2],
                                    "max_new_tokens": 2},
         {"X-Request-Id": "s-bad"}),
        ("bad sampling", "/generate", {"prompt": [1], "top_p": 3.0}, {}),
        ("predict", "/predict", {"x": 1.5}, {}),
    ]
    out = []
    for label, path, payload, headers in steps:
        r = requests.post(base + path, json=payload, headers=headers,
                          timeout=60)
        out.append((label, r.status_code, r.json(),
                    sorted(h.lower() for h in r.headers)))
    r = requests.post(base + "/generate", data=b'{"prompt": ',
                      timeout=10)
    out.append(("bad json", r.status_code, None,
                sorted(h.lower() for h in r.headers)))
    srv.decoder.max_waiting = 0
    r = requests.post(base + "/generate", json={"prompt": [1]}, timeout=10)
    out.append(("shed", r.status_code, sorted(r.json()),
                sorted(h.lower() for h in r.headers)))
    srv.decoder.max_waiting = 256
    st = requests.get(base + "/decode/stats", timeout=10).json()
    stats = requests.get(base + "/stats", timeout=10).json()
    metrics = requests.get(base + "/metrics?scope=server", timeout=10).text
    return out, st, stats, metrics


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_port_server_matches_jax_server(frontend):
    jsched = JD.DecodeScheduler(_jax_decoder(), max_new_tokens_default=8)
    with JServingServer(JIdentity(), port=0, decoder=jsched,
                        max_latency_ms=1.0, verify_checkpoints=False,
                        frontend=frontend) as jsrv:
        jout, jst, jstats, jmetrics = _run_script(jsrv)
    with _serve(frontend=frontend) as psrv:
        pout, pst, pstats, pmetrics = _run_script(psrv)
    for j, p in zip(jout, pout):
        assert p == j, (j[0], j, p)
    assert "retry-after" in dict((r[0], r[3]) for r in pout)["shed"]
    assert "x-replayed" in dict((r[0], r[3]) for r in pout)["replay"]
    assert all("x-trace-id" in r[3] for r in pout)
    # the decoder's own keys: the port names its device, JAX its
    # prefill engine (not ported); the int8 FFN flag is compared
    assert set(pst) ^ set(jst) == _DECODER_ONLY_KEYS
    # the port compiles nothing (no CUDA graphs yet), and its
    # placement names the device as well
    assert pst.pop("n_compiles") == 0 and jst.pop("n_compiles") > 0
    assert pst["placement"].pop("device") == "cpu"
    assert _stats_values({k: pst[k] for k in jst if k in pst}) == \
        _stats_values({k: jst[k] for k in pst if k in jst})
    assert pst["slots_in_use"] == 0
    assert set(pstats) == set(jstats)
    assert set(pstats["frontend"]) == set(jstats["frontend"])
    assert _families(pmetrics) == _families(jmetrics)
    # the documented difference: build_info's labels name the framework
    (jb,) = [ln for ln in jmetrics.splitlines()
             if ln.startswith("serving_build_info{")]
    (pb,) = [ln for ln in pmetrics.splitlines()
             if ln.startswith("serving_build_info{")]
    assert 'jax="' in jb and 'torch="' in pb and 'cuda="' in pb
