"""HTTP on columns (the port's copy of ``mmlspark_tpu/io/http.py``):
request and response records, the ``basic``, ``advanced`` and
``policy`` send handlers, and :class:`HTTPClient`, which sends a list
of requests in order with bounded concurrency, retries and per-host
circuit breakers.

The column stages follow: :class:`HTTPTransformer` sends a request
column row by row, the input parsers make requests of row values, the
output parsers turn responses into values, and
:class:`SimpleHTTPTransformer` composes the three with an error column.

Host-side by design: HTTP IO never touches the device. ``requests`` is
imported only when a client is built without a session.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import urlsplit

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.params import (
    HasInputCol, HasOutputCol, Param, in_range,
)
from mmlspark_tpu_torch.core.resilience import (
    BreakerBoard, Deadline, RetryPolicy,
)
from mmlspark_tpu_torch.core.stage import Transformer


# ---------------------------------------------------------------------------
# Request / response records (parity: HTTPSchema.scala SparkBindings)
# ---------------------------------------------------------------------------

@dataclass
class HTTPRequestData:
    """One HTTP request as plain data (parity: HTTPRequestData binding)."""

    url: str
    method: str = "GET"
    headers: Dict[str, str] = field(default_factory=dict)
    body: Optional[bytes] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"url": self.url, "method": self.method,
                "headers": dict(self.headers), "body": self.body}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "HTTPRequestData":
        body = d.get("body")
        if isinstance(body, str):
            body = body.encode()
        return HTTPRequestData(url=d["url"], method=d.get("method", "GET"),
                               headers=dict(d.get("headers") or {}),
                               body=body)

    @staticmethod
    def post_json(url: str, payload: Any,
                  headers: Optional[Dict[str, str]] = None
                  ) -> "HTTPRequestData":
        from mmlspark_tpu_torch.core.serialize import _json_default
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        return HTTPRequestData(url=url, method="POST", headers=h,
                               body=json.dumps(payload,
                                               default=_json_default).encode())


@dataclass
class HTTPResponseData:
    """One HTTP response as plain data (parity: HTTPResponseData binding)."""

    status_code: int
    reason: str = ""
    body: Optional[bytes] = None
    headers: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"status_code": self.status_code, "reason": self.reason,
                "body": self.body, "headers": dict(self.headers)}

    @property
    def text(self) -> str:
        return (self.body or b"").decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.text)


# ---------------------------------------------------------------------------
# Handlers: send one request with a retry policy
# (parity: HandlingUtils.basic/advanced, HTTPClients.scala:55,107-133)
# ---------------------------------------------------------------------------

def _metrics():
    """Lazily-bound global telemetry families (module-cached so the
    per-send cost is one dict lookup + a labels() cache hit)."""
    global _HTTP_METRICS
    if _HTTP_METRICS is None:
        from mmlspark_tpu_torch.core.telemetry import BoundedLabelSet, REGISTRY
        _HTTP_METRICS = {
            "requests": REGISTRY.counter(
                "http_client_requests_total",
                "Egress HTTP sends by host and status class (transport "
                "failures land in class \"0xx\"; hosts beyond the "
                "tracked-label cap fold into host=\"other\").",
                labels=("host", "class")),
            "retries": REGISTRY.counter(
                "http_client_retries_total",
                "Egress sends re-attempted under a retry policy.",
                labels=("host",)),
            # a URL column with thousands of distinct domains must not
            # grow a long-lived worker's registry without limit
            "hosts": BoundedLabelSet(256),
        }
    return _HTTP_METRICS


_HTTP_METRICS = None


def _host_label(host: str) -> str:
    return _metrics()["hosts"].key(host)[0]


def _send_once(session, req: HTTPRequestData,
               timeout: float) -> HTTPResponseData:
    # one egress span per attempt, nested under the ambient span (a
    # served request whose model fans out HTTP shows each send in its
    # captured timeline, carrying the same injected trace id); a
    # transport failure finishes it with status=error before the
    # exception reaches the policy layer. A bound trace id WITHOUT an
    # ambient span (ServingClient's one-trace-per-failover-schedule
    # pattern) means this span is mid-trace, not a root: suppress the
    # capture decision, or a retry storm would churn the trace store
    # with one-span "http_egress" captures
    from mmlspark_tpu_torch.core.telemetry import current_trace_id
    from mmlspark_tpu_torch.core.tracing import (
        ambient_tracer, current_span, inject_span_context,
    )
    tracer = ambient_tracer()
    tid = current_trace_id()
    mid_trace = tid is not None and current_span() is None
    span = tracer.start("http_egress", host=_host_of(req.url),
                        method=req.method)
    headers = req.headers
    if tid:
        # distributed-trace context on the wire: the trace id PLUS this
        # attempt span's id as X-Parent-Span-Id, so an mmlspark_tpu_torch
        # worker on the other end parents its root "request" span under
        # this exact attempt and the trees merge into one distributed
        # trace. Caller-supplied headers win (names are
        # case-insensitive on the wire — two conflicting trace headers
        # would fork downstream correlation).
        headers = inject_span_context(headers, span)
    try:
        resp = session.request(req.method, req.url, headers=headers,
                               data=req.body, timeout=timeout)
    except BaseException:
        tracer.finish(span, status="error", capture=not mid_trace)
        raise
    tracer.finish(span,
                  status="ok" if resp.status_code < 500 else "error",
                  capture=not mid_trace,
                  status_code=resp.status_code)
    return HTTPResponseData(status_code=resp.status_code,
                            reason=resp.reason, body=resp.content,
                            headers=dict(resp.headers))


def policy_handler(session, req: HTTPRequestData, timeout: float = 60.0,
                   policy: Optional[RetryPolicy] = None,
                   breaker=None, deadline: Optional[Deadline] = None
                   ) -> HTTPResponseData:
    """Send one request under a :class:`RetryPolicy`.

    The general handler the legacy fixed-list handlers now delegate to:
    transport failures (returned as status 0, same contract as before)
    and policy-retryable statuses back off per the policy (decorrelated
    jitter or explicit list, attempt + time budgets), honoring
    ``Retry-After``. An optional per-host :class:`CircuitBreaker` is
    consulted before every send — an open circuit returns immediately
    (status 0, reason ``"circuit open: ..."``) instead of burning the
    retry schedule against a dead host. An optional :class:`Deadline`
    bounds the whole exchange: it caps the per-attempt socket timeout
    and no retry is attempted that could not finish in time.
    """
    policy = policy or RetryPolicy()
    sched = policy.schedule(deadline)
    resp: Optional[HTTPResponseData] = None
    host = _host_label(_host_of(req.url))   # invariant across attempts
    while True:
        if deadline is not None and deadline.expired:
            return resp or HTTPResponseData(
                status_code=0, reason="deadline exceeded", body=None)
        if breaker is not None and not breaker.allow():
            return resp or HTTPResponseData(
                status_code=0,
                reason=f"circuit open: {breaker.name or req.url}",
                body=None)
        attempt_timeout = timeout
        if deadline is not None:
            attempt_timeout = min(timeout, max(deadline.remaining(), 1e-3))
        try:
            resp = _send_once(session, req, attempt_timeout)
        except Exception as e:  # transport-level failure
            resp = HTTPResponseData(status_code=0, reason=str(e), body=None)
        _metrics()["requests"].labels(
            host, f"{resp.status_code // 100}xx").inc()
        # breaker health tracks the HOST: transport failures and server
        # errors count against it even when the policy itself would not
        # retry that status (e.g. the basic policy returns 5xx as-is)
        if breaker is not None:
            if resp.status_code == 0 or resp.status_code >= 500:
                breaker.record_failure()
            else:
                breaker.record_success()
        if not policy.retryable_status(resp.status_code):
            return resp
        retry_after = resp.headers.get("Retry-After")
        if sched.give_up(retry_after):
            return resp
        _metrics()["retries"].labels(host).inc()


def basic_handler(session, req: HTTPRequestData, timeout: float = 60.0,
                  backoffs: List[float] = (0.1, 0.5, 1.0),
                  deadline: Optional[Deadline] = None) -> HTTPResponseData:
    """Retry only on transport errors; any status code is returned as-is."""
    return policy_handler(
        session, req, timeout,
        policy=RetryPolicy(backoffs=tuple(backoffs), retry_statuses=()),
        deadline=deadline)


def advanced_handler(session, req: HTTPRequestData, timeout: float = 60.0,
                     backoffs: List[float] = (0.1, 0.5, 1.0, 2.0),
                     retry_statuses: tuple = (429, 500, 502, 503, 504),
                     deadline: Optional[Deadline] = None
                     ) -> HTTPResponseData:
    """Also retry on throttling/server statuses with backoff.

    Parity: HandlingUtils.advanced (`HTTPClients.scala:107-133`) — 429s
    honor a Retry-After header when present.
    """
    return policy_handler(
        session, req, timeout,
        policy=RetryPolicy(backoffs=tuple(backoffs),
                           retry_statuses=tuple(retry_statuses)),
        deadline=deadline)


# ---------------------------------------------------------------------------
# Clients (parity: Clients.scala SingleThreadedClient / AsyncClient)
# ---------------------------------------------------------------------------

# per-host breakers shared by every policy-driven client in the process:
# a host that died during one stage's transform is already open when the
# next stage (or the next micro-batch) targets it
SHARED_BREAKERS = BreakerBoard(failure_threshold=5, reset_timeout=30.0)


def _host_of(url: str) -> str:
    return urlsplit(url).netloc or url


class HTTPClient:
    """Sends a list of requests, preserving order.

    ``concurrency > 1`` uses a bounded thread pool — the analogue of the
    reference's per-partition AsyncClient with bounded futures
    (`Clients.scala:102`, `AsyncUtils`).

    With ``policy`` set (or ``breakers``), sends go through
    :func:`policy_handler`: jittered/bounded retries, per-host circuit
    breaking (``breakers=True`` uses the process-wide
    :data:`SHARED_BREAKERS` board; pass a :class:`BreakerBoard` to
    isolate), and an optional per-send :class:`Deadline`. ``session``
    is injectable so tests wrap it in a session that injects faults.
    """

    def __init__(self, concurrency: int = 1, timeout: float = 60.0,
                 handler: Callable = advanced_handler,
                 policy: Optional[RetryPolicy] = None,
                 breakers=None, session=None):
        self.concurrency = max(int(concurrency), 1)
        self.timeout = timeout
        self.handler = handler
        self.policy = policy
        if breakers is True:
            breakers = SHARED_BREAKERS
        self.breakers: Optional[BreakerBoard] = breakers or None
        import inspect
        try:
            self._handler_takes_deadline = "deadline" in \
                inspect.signature(handler).parameters
        except (TypeError, ValueError):
            self._handler_takes_deadline = False
        if session is None:
            import requests
            session = requests.Session()
        self._session = session

    def send(self, reqs: List[Optional[HTTPRequestData]],
             deadline: Optional[Deadline] = None
             ) -> List[Optional[HTTPResponseData]]:
        policy_driven = (self.policy is not None
                         or self.breakers is not None)

        def one(req):
            if req is None:
                return None
            if policy_driven:
                breaker = (self.breakers.get(_host_of(req.url))
                           if self.breakers is not None else None)
                return policy_handler(self._session, req, self.timeout,
                                      policy=self.policy, breaker=breaker,
                                      deadline=deadline)
            if deadline is not None and self._handler_takes_deadline:
                # a deadline must never silently swap the configured
                # handler's retry semantics for the default policy's
                # (basic must keep returning 5xx as-is): the stock
                # handlers thread the deadline through; a custom
                # handler that cannot take one keeps its exact contract
                return self.handler(self._session, req, self.timeout,
                                    deadline=deadline)
            return self.handler(self._session, req, self.timeout)

        if self.concurrency == 1:
            return [one(r) for r in reqs]
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            return list(pool.map(one, reqs))

    def close(self):
        self._session.close()


# ---------------------------------------------------------------------------
# Transformer stages
# ---------------------------------------------------------------------------

class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Send one HTTP request per row (parity: HTTPTransformer.scala:78).

    The input column holds request dicts (or :class:`HTTPRequestData`);
    the output column holds response dicts. Nulls pass through as nulls —
    same contract as the reference (`HTTPTransformer.scala:105`).
    """

    input_col = Param("request", "request column")
    output_col = Param("response", "response column")
    concurrency = Param(8, "max in-flight requests", in_range(lo=1))
    timeout = Param(60.0, "per-request timeout, seconds", in_range(lo=0.0))
    handler = Param("advanced", "retry policy: basic|advanced|policy "
                    "(policy = jittered/budgeted retries + per-host "
                    "circuit breakers)")
    budget = Param(None, "optional whole-transform deadline, seconds: "
                   "bounds retries AND per-attempt socket timeouts for "
                   "every row in this frame", ptype=float)

    def _client(self) -> HTTPClient:
        if self.handler == "policy":
            return HTTPClient(concurrency=self.concurrency,
                              timeout=self.timeout,
                              policy=RetryPolicy(), breakers=True)
        handler = advanced_handler if self.handler == "advanced" \
            else basic_handler
        return HTTPClient(concurrency=self.concurrency,
                          timeout=self.timeout, handler=handler)

    def transform(self, df: DataFrame) -> DataFrame:
        reqs = []
        for v in df[self.input_col]:
            if v is None:
                reqs.append(None)
            elif isinstance(v, HTTPRequestData):
                reqs.append(v)
            else:
                reqs.append(HTTPRequestData.from_dict(v))
        client = self._client()
        deadline = Deadline(self.budget) if self.budget else None
        try:
            resps = client.send(reqs, deadline=deadline)
        finally:
            client.close()
        out = [None if r is None else r.to_dict() for r in resps]
        return df.with_column(self.output_col, obj_col(out))


class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Row value -> POST request with JSON body (parity: Parsers.scala:30)."""

    input_col = Param("value", "column holding the JSON-able payload")
    output_col = Param("request", "request column out")
    url = Param(None, "target url", ptype=str)
    headers = Param(None, "extra headers dict")

    def transform(self, df: DataFrame) -> DataFrame:
        out = [HTTPRequestData.post_json(
                   self.url, v if not isinstance(v, np.ndarray) else v.tolist(),
                   self.headers).to_dict()
               for v in df[self.input_col]]
        return df.with_column(self.output_col, obj_col(out))


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    """Row value -> request via a user function (parity: Parsers.scala:83)."""

    input_col = Param("value", "input column")
    output_col = Param("request", "request column out")
    udf = Param(None, "value -> HTTPRequestData (or dict)", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        out = []
        for v in df[self.input_col]:
            r = self.udf(v)
            out.append(r.to_dict() if isinstance(r, HTTPRequestData) else r)
        return df.with_column(self.output_col, obj_col(out))


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Response -> parsed JSON body (parity: Parsers.scala:143).

    ``data_field`` optionally pulls one field out of the parsed object.
    """

    input_col = Param("response", "response column")
    output_col = Param("parsed", "parsed output column")
    data_field = Param(None, "field to extract from the JSON object")

    def transform(self, df: DataFrame) -> DataFrame:
        out = []
        for v in df[self.input_col]:
            if v is None:
                out.append(None)
                continue
            resp = v if isinstance(v, HTTPResponseData) else \
                HTTPResponseData(**v)
            try:
                parsed = resp.json()
            except (ValueError, AttributeError):
                out.append(None)
                continue
            if self.data_field is not None and isinstance(parsed, dict):
                parsed = parsed.get(self.data_field)
            out.append(parsed)
        return df.with_column(self.output_col, obj_col(out))


class StringOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Response -> body text (parity: Parsers.scala:194)."""

    input_col = Param("response", "response column")
    output_col = Param("text", "text output column")

    def transform(self, df: DataFrame) -> DataFrame:
        out = []
        for v in df[self.input_col]:
            if v is None:
                out.append(None)
            else:
                resp = v if isinstance(v, HTTPResponseData) else \
                    HTTPResponseData(**v)
                out.append(resp.text)
        return df.with_column(self.output_col, obj_col(out))


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Response -> value via a user function (parity: Parsers.scala:212)."""

    input_col = Param("response", "response column")
    output_col = Param("parsed", "output column")
    udf = Param(None, "HTTPResponseData -> value", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        out = []
        for v in df[self.input_col]:
            if v is None:
                out.append(None)
            else:
                resp = v if isinstance(v, HTTPResponseData) else \
                    HTTPResponseData(**v)
                out.append(self.udf(resp))
        return df.with_column(self.output_col, obj_col(out))


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """input parser -> HTTP -> output parser, with an error column.

    Parity: `SimpleHTTPTransformer.scala:61` — composes the full
    request/response pipeline; non-2xx responses put
    ``{status_code, reason}`` into ``error_col`` and null into the output.
    """

    input_col = Param("value", "column fed to the input parser")
    output_col = Param("parsed", "final parsed output")
    input_parser = Param(None, "Transformer making requests", complex=True)
    output_parser = Param(None, "Transformer parsing responses", complex=True)
    error_col = Param("error", "column for failed-request info")
    concurrency = Param(8, "max in-flight requests", in_range(lo=1))
    timeout = Param(60.0, "per-request timeout, s", in_range(lo=0.0))
    handler = Param("advanced", "retry policy: basic|advanced|policy")
    budget = Param(None, "optional whole-transform deadline, seconds",
                   ptype=float)

    def transform(self, df: DataFrame) -> DataFrame:
        req_col = "__http_request"
        resp_col = "__http_response"
        in_parser = self.input_parser or JSONInputParser()
        in_parser = in_parser.copy(input_col=self.input_col,
                                   output_col=req_col)
        out_parser = (self.output_parser or JSONOutputParser()).copy(
            input_col=resp_col, output_col=self.output_col)

        work = in_parser.transform(df)
        work = HTTPTransformer(
            input_col=req_col, output_col=resp_col,
            concurrency=self.concurrency, timeout=self.timeout,
            handler=self.handler, budget=self.budget).transform(work)

        errors = []
        resps = []
        for v in work[resp_col]:
            if v is not None and 200 <= v["status_code"] < 300:
                errors.append(None)
                resps.append(v)
            else:
                errors.append(None if v is None else
                              {"status_code": v["status_code"],
                               "reason": v["reason"]})
                resps.append(None)
        work = work.with_column(resp_col, obj_col(resps))
        out = out_parser.transform(work)
        out = out.with_column(self.error_col, obj_col(errors))
        return out.drop(req_col, resp_col)

    def _save_extra(self, path, arrays):
        self._save_substage(path, "input_parser")
        self._save_substage(path, "output_parser")

    def _load_extra(self, path, arrays):
        self._load_substage(path, "input_parser")
        self._load_substage(path, "output_parser")
