"""The port's HTTP column stages (``mmlspark_tpu_torch/io/http.py``)
against the JAX package's, on the CPU.

One localhost server, as ``tests/test_http.py``'s fixture, records every
request it receives and answers from the request alone (no counter, a
fixed ``Date`` and ``Server``), so both packages' stages can run against
it in turn: the requests it received must be equal, and so must the
output and error columns, exactly. The server refuses a path with 404, a
``"fail"`` body field with 500, and throttles the first ``throttle``
requests with 429; with ``canned`` set it answers every POST with that
body. ``tests/test_torch_services.py`` runs the services against it too.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.io import http as JH
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.io import http as PH

torch.set_num_threads(1)

PACKAGES = (("jax", JH, JDF), ("port", PH, DataFrame))


class _Recorder(BaseHTTPRequestHandler):
    """Replies ``{"echo": payload, "path": ..., **payload}`` to POSTs and
    ``{"path": ..., "value": [...]}`` to GETs; records each request."""

    protocol_version = "HTTP/1.1"
    received: list = []
    throttle = 0
    canned = None
    lock = threading.Lock()

    def date_time_string(self, timestamp=None):
        return "Thu, 01 Jan 2026 00:00:00 GMT"

    def version_string(self):
        return "recorder"

    def _record(self, body: bytes):
        cls = type(self)
        with cls.lock:
            cls.received.append({
                "method": self.command, "path": self.path, "body": body,
                "content_type": self.headers.get("Content-Type"),
                "key": self.headers.get("Ocp-Apim-Subscription-Key"),
                "api_key": self.headers.get("api-key")})
            throttled = cls.throttle > 0
            if throttled:
                cls.throttle -= 1
        return throttled

    def _send(self, status: int, payload=None, headers=()):
        data = b"" if payload is None else json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if self._record(raw):
            self._send(429, headers=(("Retry-After", "0.01"),))
            return
        if self.path.startswith("/missing"):
            self._send(404, {"error": "no such path"})
            return
        if type(self).canned is not None:
            self._send(200, type(self).canned)
            return
        try:
            payload = json.loads(raw or b"null")
        except ValueError:
            payload = {"raw_len": len(raw),
                       "content_type": self.headers.get("Content-Type")}
        if _fails(payload):
            self._send(500, {"error": "refused"})
            return
        reply = {"echo": payload, "path": self.path}
        if isinstance(payload, dict):
            reply.update(payload)
        self._send(200, reply)

    def do_GET(self):
        self._record(b"")
        self._send(200, {"path": self.path, "value": [{"name": "hit"}]})

    def log_message(self, *args):
        pass


def _fails(payload) -> bool:
    """A body the server refuses: a dict, or a list or ``{"value": [...]}``
    of dicts (the writers' batches), with a true ``"fail"`` field."""
    if isinstance(payload, dict) and isinstance(payload.get("value"), list):
        payload = payload["value"]
    rows = payload if isinstance(payload, list) else [payload]
    return any(isinstance(r, dict) and r.get("fail") for r in rows)


@pytest.fixture
def server():
    class Handler(_Recorder):
        received = []
        throttle = 0
        canned = None
        lock = threading.Lock()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", Handler
    srv.shutdown()
    srv.server_close()


def _run_both(handler, fn):
    """``fn(module, frame_class)`` for JAX then the port; returns both
    outputs and the requests each run sent, in a stable order."""
    outs, sent = {}, {}
    for name, mod, frame in PACKAGES:
        handler.received.clear()
        outs[name] = fn(mod, frame)
        sent[name] = sorted(handler.received,
                            key=lambda r: (r["path"], r["body"]))
    return outs, sent


def _cells(df):
    return {c: list(df[c]) for c in df.columns}


def _requests(url, n=6):
    return [JH.HTTPRequestData.post_json(url + "/score", {"x": i}).to_dict()
            for i in range(n)]


@pytest.mark.parametrize("handler_name", ["basic", "advanced", "policy"])
@pytest.mark.parametrize("concurrency", [1, 4])
def test_http_transformer_round_trip(server, handler_name, concurrency):
    url, handler = server
    reqs = _requests(url) + [None]

    def run(mod, frame):
        return mod.HTTPTransformer(concurrency=concurrency,
                                   handler=handler_name).transform(
            frame({"request": list(reqs)}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"] and len(sent["port"]) == 6
    assert _cells(outs["port"]) == _cells(outs["jax"])
    resp = outs["port"]["response"]
    assert resp[-1] is None
    assert [PH.HTTPResponseData(**r).json()["x"] for r in resp[:-1]] == \
        list(range(6))


def test_http_transformer_takes_request_records(server):
    url, handler = server

    def run(mod, frame):
        rec = mod.HTTPRequestData.post_json(url + "/r", [1, 2])
        return mod.HTTPTransformer().transform(frame({"request": [rec]}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"]
    assert list(outs["port"]["response"]) == list(outs["jax"]["response"])
    assert outs["port"]["request"][0].to_dict() == \
        outs["jax"]["request"][0].to_dict()


@pytest.mark.parametrize("handler_name,want", [("basic", 429),
                                               ("advanced", 200),
                                               ("policy", 200)])
def test_throttling_per_handler(server, handler_name, want):
    """advanced and policy retry a 429 after its Retry-After; basic
    returns it as it is."""
    url, handler = server

    def run(mod, frame):
        handler.throttle = 2
        return mod.HTTPTransformer(handler=handler_name,
                                   concurrency=1).transform(
            frame({"request": _requests(url, 1)}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"]
    assert len(sent["port"]) == (1 if want == 429 else 3)
    assert _cells(outs["port"]) == _cells(outs["jax"])
    assert outs["port"]["response"][0]["status_code"] == want


@pytest.mark.parametrize("handler_name", ["basic", "advanced", "policy"])
def test_a_spent_budget_sends_nothing(server, handler_name):
    """A whole-transform budget already spent: no row is sent, and every
    row ends as status 0, ``deadline exceeded``, in both packages."""
    url, handler = server

    def run(mod, frame):
        return mod.HTTPTransformer(handler=handler_name, budget=1e-9,
                                   concurrency=2).transform(
            frame({"request": _requests(url, 3) + [None]}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"] == []
    assert _cells(outs["port"]) == _cells(outs["jax"])
    assert [r["status_code"] for r in outs["port"]["response"][:3]] == \
        [0, 0, 0]
    assert outs["port"]["response"][0]["reason"] == "deadline exceeded"
    assert outs["port"]["response"][3] is None


def test_a_budget_with_room_retries_to_success(server):
    url, handler = server

    def run(mod, frame):
        handler.throttle = 1
        return mod.HTTPTransformer(handler="policy", budget=60.0,
                                   concurrency=1).transform(
            frame({"request": _requests(url, 2)}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"] and len(sent["port"]) == 3
    assert _cells(outs["port"]) == _cells(outs["jax"])
    assert [r["status_code"] for r in outs["port"]["response"]] == [200, 200]


def test_transport_error_gives_status_zero():
    reqs = [JH.HTTPRequestData.post_json("http://127.0.0.1:9/none", 1)
            .to_dict(), None]
    for _, mod, frame in PACKAGES:
        out = mod.HTTPTransformer(handler="basic", timeout=0.5,
                                  concurrency=1).transform(
            frame({"request": list(reqs)}))
        assert out["response"][0]["status_code"] == 0
        assert out["response"][0]["reason"]
        assert out["response"][1] is None


@pytest.mark.parametrize("value", [
    {"q": "a"}, [1, 2, 3], "text", 7, None,
    np.arange(4, dtype=np.int64), np.array([[0.5, 1.5]])])
def test_json_input_parser(value):
    def run(mod, frame):
        return mod.JSONInputParser(url="http://h/p",
                                   headers={"X-Key": "k"}).transform(
            frame({"value": [value, {"k": 1}]}))
    j, p = run(JH, JDF), run(PH, DataFrame)
    assert _cells(p) == _cells(j)
    req = p["request"][0]
    assert req["method"] == "POST" and req["headers"]["X-Key"] == "k"
    assert req["headers"]["Content-Type"] == "application/json"


def test_custom_input_parser():
    def make(mod):
        return lambda v: (None if v is None else
                          mod.HTTPRequestData(url=f"http://h/{v}",
                                              method="GET"))

    def run(mod, frame):
        return mod.CustomInputParser(udf=make(mod)).transform(
            frame({"value": ["a", None, "b"]}))
    assert _cells(run(PH, DataFrame)) == _cells(run(JH, JDF))
    out = PH.CustomInputParser(udf=lambda v: {"url": v}).transform(
        DataFrame({"value": ["u"]}))
    assert out["request"][0] == {"url": "u"}


def _responses():
    return [
        {"status_code": 200, "reason": "OK", "headers": {},
         "body": b'{"scores": [1, 2], "n": 3}'},
        {"status_code": 200, "reason": "OK", "headers": {},
         "body": b"not json"},
        None,
        {"status_code": 200, "reason": "OK", "headers": {},
         "body": b"[4, 5]"},
        {"status_code": 500, "reason": "err", "headers": {}, "body": None},
    ]


@pytest.mark.parametrize("data_field", [None, "scores", "absent"])
def test_json_output_parser(data_field):
    def run(mod, frame):
        return mod.JSONOutputParser(data_field=data_field).transform(
            frame({"response": _responses()}))
    p = run(PH, DataFrame)
    assert _cells(p) == _cells(run(JH, JDF))
    want = {None: {"scores": [1, 2], "n": 3}, "scores": [1, 2],
            "absent": None}[data_field]
    assert p["parsed"][0] == want
    assert p["parsed"][1] is None and p["parsed"][2] is None
    assert p["parsed"][3] == [4, 5]


def test_string_and_custom_output_parsers():
    for make in (lambda mod: mod.StringOutputParser(),
                 lambda mod: mod.CustomOutputParser(
                     udf=lambda r: (r.status_code, len(r.text)))):
        j = make(JH).transform(JDF({"response": _responses()}))
        p = make(PH).transform(DataFrame({"response": _responses()}))
        assert _cells(p) == _cells(j)
        assert p[p.columns[-1]][2] is None
    # a response record passes as it is
    rec = PH.HTTPResponseData(status_code=200, body=b"hi")
    out = PH.StringOutputParser().transform(DataFrame({"response": [rec]}))
    assert out["text"][0] == "hi"


def _simple(mod, url, **kw):
    return mod.SimpleHTTPTransformer(
        input_parser=mod.JSONInputParser(url=url),
        output_parser=mod.JSONOutputParser(data_field="echo"), **kw)


@pytest.mark.parametrize("concurrency", [1, 8])
def test_simple_http_transformer(server, concurrency):
    url, handler = server
    rows = [{"q": "a"}, {"q": "b", "fail": 1}, None, {"q": "c"}]

    def run(mod, frame):
        return _simple(mod, url + "/s", concurrency=concurrency,
                       handler="basic").transform(
            frame({"value": list(rows), "id": np.arange(4)}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"] and len(sent["port"]) == 4
    p = outs["port"]
    assert _cells(p) == _cells(outs["jax"])
    assert p.columns == ["value", "id", "parsed", "error"]
    assert p["parsed"][0] == {"q": "a"} and p["parsed"][3] == {"q": "c"}
    # the refused row: its status and reason in the error column, None out
    assert p["parsed"][1] is None
    assert p["error"][1] == {"status_code": 500,
                             "reason": "Internal Server Error"}
    # a JSON null is still a request: the echo of null is null
    assert p["parsed"][2] is None and p["error"][2] is None
    assert p["error"][0] is None and p["error"][3] is None


def test_simple_http_transformer_error_column_on_404(server):
    url, handler = server

    def run(mod, frame):
        return mod.SimpleHTTPTransformer(
            input_parser=mod.JSONInputParser(url=url + "/missing"),
            handler="basic", error_col="err").transform(
            frame({"value": [1, 2]}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"]
    assert _cells(outs["port"]) == _cells(outs["jax"])
    assert outs["port"]["err"][0] == {"status_code": 404,
                                      "reason": "Not Found"}
    assert outs["port"]["parsed"][0] is None


def test_simple_http_transformer_default_parsers(server):
    url, handler = server

    def run(mod, frame):
        return mod.SimpleHTTPTransformer(
            input_parser=mod.JSONInputParser(url=url + "/d"),
            output_parser=mod.StringOutputParser(),
            output_col="text").transform(frame({"value": [{"k": 1}]}))
    outs, sent = _run_both(handler, run)
    assert sent["jax"] == sent["port"]
    assert _cells(outs["port"]) == _cells(outs["jax"])
    assert json.loads(outs["port"]["text"][0])["k"] == 1


def test_simple_http_transformer_transport_failure():
    for _, mod, frame in PACKAGES:
        out = mod.SimpleHTTPTransformer(
            input_parser=mod.JSONInputParser(url="http://127.0.0.1:9/x"),
            handler="basic", timeout=0.5).transform(frame({"value": [1]}))
        assert out["error"][0]["status_code"] == 0
        assert out["parsed"][0] is None


def test_simple_http_transformer_persistence(server, tmp_path):
    """Saved with its parsers as sub-stages, loaded, the stage sends the
    same requests and gives the same columns; its params are JAX's."""
    url, handler = server
    stage = PH.SimpleHTTPTransformer(
        input_parser=PH.JSONInputParser(url=url + "/p",
                                        headers={"X-A": "1"}),
        output_parser=PH.JSONOutputParser(data_field="echo"),
        error_col="err", concurrency=3, handler="basic", budget=30.0)
    stage.save(str(tmp_path / "s"))
    loaded = PipelineStage.load(str(tmp_path / "s"))
    assert type(loaded) is PH.SimpleHTTPTransformer
    assert type(loaded.input_parser) is PH.JSONInputParser
    assert loaded.input_parser.url == url + "/p"
    assert loaded.input_parser.headers == {"X-A": "1"}
    assert loaded.output_parser.data_field == "echo"
    df = DataFrame({"value": [{"a": 1}, {"a": 2, "fail": 1}]})
    handler.received.clear()
    a = stage.transform(df)
    first = sorted(handler.received, key=lambda r: r["body"])
    handler.received.clear()
    b = loaded.transform(df)
    assert sorted(handler.received, key=lambda r: r["body"]) == first
    assert _cells(a) == _cells(b)
    # the same params as JAX's stage, sub-stages apart
    jax_stage = JH.SimpleHTTPTransformer(
        input_parser=JH.JSONInputParser(url=url + "/p"),
        error_col="err", concurrency=3, handler="basic", budget=30.0)

    def plain(s):
        return {k: v for k, v in s._json_params().items()
                if k not in ("input_parser", "output_parser")}
    assert plain(loaded) == plain(jax_stage)
    assert sorted(type(loaded).params()) == sorted(
        type(jax_stage).params())


@pytest.mark.parametrize("name", ["HTTPTransformer", "JSONInputParser",
                                  "CustomInputParser", "JSONOutputParser",
                                  "StringOutputParser", "CustomOutputParser",
                                  "SimpleHTTPTransformer"])
def test_stages_keep_jaxs_params(name):
    j, p = getattr(JH, name), getattr(PH, name)
    assert sorted(p.params()) == sorted(j.params())
    for k, param in j.params().items():
        assert p.params()[k].default == param.default, k
        assert p.params()[k].complex == param.complex, k


def test_handlers_are_exported():
    from mmlspark_tpu_torch import io
    for name in ("HTTPTransformer", "SimpleHTTPTransformer",
                 "JSONInputParser", "JSONOutputParser", "StringOutputParser",
                 "CustomInputParser", "CustomOutputParser", "basic_handler",
                 "advanced_handler", "read_images", "decode_image",
                 "encode_image"):
        assert name in io.__all__ and getattr(io, name) is not None
    assert io.basic_handler is PH.basic_handler
