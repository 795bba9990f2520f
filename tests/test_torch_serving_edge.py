"""The port's serving edge: tenancy over ``/generate``, the event loop's
framing behaviours beside the JAX package's, and the coordinator.

* tenancy: the port's counterparts of ``TestWireAdmission``,
  ``TestDecodeFairPop``, ``TestPrefixCacheQuotas`` and
  ``TestTenantObservability`` (``tests/test_serving_tenancy.py``), with
  the wire tests sent to ``/generate`` as well as ``/predict``;
* framing: keep-alive, pipelined requests in order, chunked bodies, a
  malformed request line, the per-IP connection cap and the idle reap,
  each run against both packages' servers with the same assertions;
* the coordinator: two port workers registered in-process,
  ``/fleet/metrics`` merging their decode counters, and
  ``ServingClient.predict`` reaching ``/predict``.
"""

import json
import socket
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import requests

from mmlspark_tpu.core.stage import Transformer as JTransformer
from mmlspark_tpu.serving.server import ServingServer as JServingServer
from mmlspark_tpu_torch.core.resilience import ManualClock
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.serving import decode as D
from mmlspark_tpu_torch.serving.server import (
    ServingClient, ServingCoordinator, ServingServer,
)
from mmlspark_tpu_torch.serving.tenancy import (
    ANONYMOUS_ID, FairCycle, Tenant, TenantRegistry,
)
from test_torch_serving_decode import _decoder, _greedy_reference


class Doubler(Transformer):
    def transform(self, df):
        return df.with_column("y", np.asarray(df["x"], np.float64) * 2)


class JDoubler(JTransformer):
    def transform(self, df):
        return df.with_column("y", np.asarray(df["x"], np.float64) * 2)


def _post(base, payload=b'{"x": 1.0}', key=None, bearer=None, rid=None,
          path="/predict"):
    headers = {}
    if key:
        headers["X-Api-Key"] = key
    if bearer:
        headers["Authorization"] = "Bearer " + bearer
    if rid:
        headers["X-Request-Id"] = rid
    return requests.post(base + path, data=payload, headers=headers,
                         timeout=30)


def _tenant_rows(base):
    stats = requests.get(base + "/stats", timeout=10).json()
    return {r["id"]: r for r in stats["tenancy"]["tenants"]}


def _registry_cfg(**over):
    cfg = {"tenants": [
        {"id": "alice", "priority": "interactive", "api_keys": ["ka"],
         "max_inflight": 8},
        {"id": "bob", "priority": "background", "api_keys": ["kb"],
         "rate_per_s": 0.5, "burst": 1},
    ]}
    cfg.update(over)
    return cfg


def _tenant_server(frontend, **kw):
    sched = D.DecodeScheduler(_decoder(), max_new_tokens_default=4)
    return ServingServer(Doubler(), port=0, max_latency_ms=1,
                         decoder=sched, frontend=frontend,
                         verify_checkpoints=False, **kw)


_ROUTES = {"/predict": b'{"x": 1.0}',
           "/generate": b'{"prompt": [3, 4, 5], "max_new_tokens": 2}'}


# ---------------------------------------------------------------------------
# tenancy on the wire


@pytest.mark.parametrize("path", list(_ROUTES))
@pytest.mark.parametrize("frontend", ["threaded", "eventloop"])
class TestWireAdmission:

    def test_quota_shed_and_replay_no_recharge(self, frontend, path):
        body = _ROUTES[path]
        # the buckets run on a manual clock: no refill between r1 and r2,
        # however long r1 takes on a loaded host
        registry = TenantRegistry.from_value(_registry_cfg(),
                                             clock=ManualClock())
        with _tenant_server(frontend, tenancy=registry) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            r1 = _post(base, body, key="kb", rid="r1", path=path)
            assert r1.status_code == 200
            if path == "/generate":
                assert r1.json()["tokens"] == _greedy_reference([3, 4, 5],
                                                                2)
            # burst=1 drained: the next unique rid sheds with an honest
            # Retry-After from the bucket's refill (0.5/s -> 2 s for the
            # one token the drained bucket lacks)
            r2 = _post(base, body, key="kb", rid="r2", path=path)
            assert r2.status_code == 429
            assert r2.json()["reason"] == "rate"
            assert 1.0 < float(r2.headers["Retry-After"]) <= 2.0
            assert float(r2.headers["Retry-After"]) == 2.0
            # replaying the committed rid never touches the bucket
            r3 = _post(base, body, key="kb", rid="r1", path=path)
            assert r3.status_code == 200 and r3.content == r1.content
            rows = _tenant_rows(base)
            assert rows["bob"]["n_requests"] == 1
            assert rows["bob"]["n_replayed"] == 1
            assert rows["bob"]["n_shed_rate"] == 1
            assert rows["bob"]["inflight"] == 0

    def test_reject_policy_401(self, frontend, path):
        body = _ROUTES[path]
        with _tenant_server(frontend, tenancy=_registry_cfg(
                unknown_key_policy="reject")) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            assert _post(base, body, path=path).status_code == 401
            assert _post(base, body, key="wrong",
                         path=path).status_code == 401
            assert _post(base, body, key="ka", path=path).status_code == 200
            assert _post(base, body, bearer="ka",
                         path=path).status_code == 200

    def test_anonymous_policy_admits_and_bills_anonymous(self, frontend,
                                                         path):
        body = _ROUTES[path]
        with _tenant_server(frontend, tenancy=_registry_cfg()) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            assert _post(base, body, path=path).status_code == 200
            assert _post(base, body, key="wrong",
                         path=path).status_code == 200
            assert _tenant_rows(base)[ANONYMOUS_ID]["n_requests"] == 2

    def test_tenant_inflight_released_on_parse_error(self, frontend, path):
        """A 400 (bad JSON inside a valid frame) must not leak the
        tenant's concurrency slot."""
        with _tenant_server(frontend, tenancy=_registry_cfg()) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            for _ in range(5):
                r = _post(base, b'{"x": ', key="ka", path=path)
                assert r.status_code == 400
            assert _tenant_rows(base)["alice"]["inflight"] == 0


def test_generate_tokens_billed_to_the_tenant():
    with _tenant_server("eventloop", tenancy=_registry_cfg()) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        r = _post(base, json.dumps({"prompt": [1, 2],
                                    "max_new_tokens": 3}).encode(),
                  key="ka", path="/generate")
        assert r.status_code == 200
        row = _tenant_rows(base)["alice"]
        assert row["n_tokens"] == 3 and row["inflight"] == 0


# ---------------------------------------------------------------------------
# per-tenant prefix-cache quotas


class TestPrefixCacheQuotas:

    def _cache(self, n_pages=64, ps=4):
        pool = D.PagePool(n_pages)
        return pool, D.PrefixCache(pool, ps)

    def _publish(self, pool, cache, tokens, tenant):
        pages = pool.claim(len(tokens) // cache.page_size)
        assert pages is not None
        absorbed = cache.publish(tokens, pages, tenant=tenant)
        rest = [p for p in pages if p not in absorbed]
        if rest:
            pool.release(rest)
        return absorbed

    def test_publication_charged_to_owner(self):
        pool, cache = self._cache()
        self._publish(pool, cache, list(range(8)), "a")
        self._publish(pool, cache, list(range(100, 112)), "b")
        assert cache.stats()["tenant_pages"] == {"a": 2, "b": 3}

    def test_over_quota_tenant_evicts_itself_first(self):
        pool, cache = self._cache()
        cache.set_quota("a", 2)
        self._publish(pool, cache, [1, 2, 3, 4, 5, 6, 7, 8], "a")
        assert cache.stats()["tenant_pages"]["a"] == 2
        assert len(self._publish(pool, cache, list(range(200, 208)),
                                 "b")) == 2
        # a publishes more distinct content: it evicts its own LRU
        # pages, never b's
        self._publish(pool, cache, list(range(300, 308)), "a")
        st = cache.stats()
        assert st["tenant_pages"]["a"] == 2
        assert st["tenant_pages"]["b"] == 2
        assert st["evicted_pages"] >= 2
        assert cache.ledger_clean()

    def test_pressure_eviction_prefers_over_quota_tenant(self):
        pool, cache = self._cache(n_pages=64)
        cache.set_quota("hog", 2)
        self._publish(pool, cache, list(range(8)), "hog")
        cache.set_quota("hog", 1)             # hog is now over quota
        self._publish(pool, cache, list(range(100, 108)), "small")
        assert cache.evict_for(pool.n_free + 1) == 1
        st = cache.stats()
        assert st["tenant_pages"]["hog"] == 1     # hog paid first
        assert st["tenant_pages"]["small"] == 2

    def test_scheduler_binds_quotas_from_registry(self):
        """``bind`` copies each tenant's ``max_cache_pages`` into the
        scheduler's prefix cache."""
        reg = _registry_cfg()
        reg["tenants"][0]["max_cache_pages"] = 3
        with _tenant_server("eventloop", tenancy=reg) as srv:
            assert srv.decoder.prefix.stats()["tenant_quotas"] == \
                {"alice": 3}


# ---------------------------------------------------------------------------
# the decode scheduler's fair pop


class TestDecodeFairPop:

    def _scheduler_stub(self, registry):
        sched = object.__new__(D.DecodeScheduler)
        sched._waiting = deque()
        sched._lock = threading.Lock()
        sched._fair = FairCycle()
        sched._server = (SimpleNamespace(tenancy=registry)
                         if registry is not None else None)
        return sched

    @staticmethod
    def _req(tenant, rid):
        return SimpleNamespace(pending=SimpleNamespace(tenant=tenant,
                                                       rid=rid))

    def test_fifo_without_tenancy(self):
        sched = self._scheduler_stub(None)
        for i in range(4):
            sched._waiting.append(self._req(None, f"r{i}"))
        assert [sched._pop_waiting().pending.rid for _ in range(4)] == \
            ["r0", "r1", "r2", "r3"]

    def test_drr_interleaves_flood_and_victim(self):
        reg = TenantRegistry([Tenant("flood", api_keys=("kf",)),
                              Tenant("victim", api_keys=("kv",))])
        sched = self._scheduler_stub(reg)
        for i in range(10):
            sched._waiting.append(self._req("flood", f"f{i}"))
        for i in range(2):
            sched._waiting.append(self._req("victim", f"v{i}"))
        order = [sched._pop_waiting().pending.rid for _ in range(12)]
        assert set(order[:4]) >= {"v0", "v1"}
        assert [r for r in order if r.startswith("f")] == \
            [f"f{i}" for i in range(10)]

    def test_fair_share_off_is_fifo(self):
        reg = TenantRegistry([Tenant("a", api_keys=("k1",)),
                              Tenant("b", api_keys=("k2",))],
                             fair_share=False)
        sched = self._scheduler_stub(reg)
        for t, rid in (("a", "a0"), ("a", "a1"), ("b", "b0")):
            sched._waiting.append(self._req(t, rid))
        assert [sched._pop_waiting().pending.rid for _ in range(3)] == \
            ["a0", "a1", "b0"]


# ---------------------------------------------------------------------------
# tenant observability


class TestTenantObservability:

    def test_metrics_rows_and_bounded_cardinality(self):
        cfg = {"label_cap": 2, "tenants": [
            {"id": "a", "api_keys": ["k1"]},
            {"id": "b", "api_keys": ["k2"]},
            {"id": "c", "api_keys": ["k3"]},
        ]}
        with _tenant_server("eventloop", tenancy=cfg) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            for k in ("k1", "k2", "k3", "k3"):
                assert _post(base, key=k).status_code == 200
            text = requests.get(base + "/metrics", timeout=10).text
            by_label = {}
            for ln in text.splitlines():
                if ln.startswith("serving_tenant_requests_total"):
                    label = ln.split('tenant="')[1].split('"')[0]
                    by_label[label] = float(ln.rsplit(" ", 1)[1])
            # cap 2: a and b get their own rows; c folds into "other",
            # whose value sums its members
            assert by_label["a"] == by_label["b"] == 1.0
            assert "c" not in by_label and by_label["other"] == 2.0
            st = requests.get(base + "/stats", timeout=10).json()
            assert st["tenancy"]["label_overflow"] >= 1

    def test_fleet_stats_merges_tenant_rows(self):
        with ServingCoordinator(port=0) as coord:
            workers = []
            try:
                for _ in range(2):
                    srv = _tenant_server("eventloop",
                                         tenancy=_registry_cfg()).start()
                    workers.append(srv)
                    ServingCoordinator.register_worker(
                        f"http://127.0.0.1:{coord.port}", srv.host,
                        srv.port)
                for srv in workers:
                    assert _post(f"http://127.0.0.1:{srv.port}",
                                 key="ka").status_code == 200
                fleet = requests.get(
                    f"http://127.0.0.1:{coord.port}/fleet",
                    timeout=10).json()
                rows = {r["id"]: r for r in fleet["tenants"]}
                assert rows["alice"]["n_requests"] == 2   # summed
                assert rows["alice"]["max_inflight"] == 8
            finally:
                for srv in workers:
                    srv.stop()


# ---------------------------------------------------------------------------
# the event loop's framing, on both packages' servers

_SERVERS = {"jax": (JServingServer, JDoubler),
            "port": (ServingServer, Doubler)}


def _frame_server(which, **kw):
    cls, model = _SERVERS[which]
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("max_latency_ms", 2)
    return cls(model(), port=0, **kw).start()


def _connect(srv, timeout=10.0):
    s = socket.create_connection((srv.host, srv.port), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _request_bytes(path="/predict", body=b'{"x": 1.0}', headers=()):
    head = [f"POST {path} HTTP/1.1", "Host: t",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}"]
    head += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _read_response(sock):
    """One full response off the socket: (status, headers, body, rest)."""
    buf = bytearray()
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError(f"EOF mid-head: {bytes(buf)!r}")
        buf += chunk
    he = buf.index(b"\r\n\r\n")
    head = bytes(buf[:he]).decode("latin-1").split("\r\n")
    status = int(head[0].split()[1])
    hdrs = {}
    for line in head[1:]:
        k, _, v = line.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    clen = int(hdrs.get("content-length", 0))
    body = buf[he + 4:]
    while len(body) < clen:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("EOF mid-body")
        body += chunk
    return status, hdrs, bytes(body[:clen]), bytes(body[clen:])


def _wait_until(cond, timeout=8.0, what="condition"):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.parametrize("which", ["jax", "port"])
class TestFraming:

    def test_keepalive_reuse(self, which):
        with _frame_server(which) as srv:
            fe = srv._frontend
            sock = _connect(srv)
            try:
                for i in range(20):
                    sock.sendall(_request_bytes(
                        body=json.dumps({"x": float(i)}).encode()))
                    status, _, body, _ = _read_response(sock)
                    assert status == 200
                    assert json.loads(body) == {"y": 2.0 * i}
            finally:
                sock.close()
            assert fe.n_keepalive_reuses >= 19
            assert fe.stats()["keepalive_reuse_rate"] > 0.9
            assert fe.stats()["kind"] == "eventloop"

    def test_pipelined_requests_served_in_order(self, which):
        with _frame_server(which) as srv:
            sock = _connect(srv)
            try:
                sock.sendall(_request_bytes(body=b'{"x": 1.0}')
                             + _request_bytes(body=b'{"x": 2.0}'))
                status1, _, body1, rest = _read_response(sock)
                if rest:
                    # both replies in one recv: parse the second from
                    # what is left over
                    sock2 = SimpleNamespace(recv=lambda n, b=[rest]:
                                            b.pop() if b else sock.recv(n))
                    status2, _, body2, _ = _read_response(sock2)
                else:
                    status2, _, body2, _ = _read_response(sock)
                assert (status1, status2) == (200, 200)
                assert json.loads(body1) == {"y": 2.0}
                assert json.loads(body2) == {"y": 4.0}
            finally:
                sock.close()

    def test_chunked_transfer_encoding_501(self, which):
        with _frame_server(which) as srv:
            sock = _connect(srv)
            try:
                sock.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                             b"Transfer-Encoding: chunked\r\n\r\n"
                             b"0\r\n\r\n")
                assert _read_response(sock)[0] == 501
            finally:
                sock.close()

    def test_malformed_request_line_400(self, which):
        with _frame_server(which) as srv:
            sock = _connect(srv)
            try:
                sock.sendall(b"garbage\r\n\r\n")
                assert _read_response(sock)[0] == 400
            finally:
                sock.close()

    def test_per_ip_cap_429(self, which):
        with _frame_server(which, max_conns_per_ip=2) as srv:
            fe = srv._frontend
            s1, s2 = _connect(srv), _connect(srv)
            try:
                for s in (s1, s2):
                    s.sendall(_request_bytes())
                    assert _read_response(s)[0] == 200
                s3 = _connect(srv)
                try:
                    status, hdrs, body, _ = _read_response(s3)
                    assert status == 429
                    assert hdrs.get("retry-after") == "1"
                    assert b"too many connections" in body
                    assert s3.recv(65536) == b""
                finally:
                    s3.close()
                assert fe.n_per_ip_rejected == 1
                assert fe.per_ip_high_water == 2
            finally:
                s1.close()
                s2.close()

    def test_idle_connection_reaped(self, which):
        with _frame_server(which, idle_timeout=0.3) as srv:
            fe = srv._frontend
            sock = _connect(srv)
            try:
                sock.sendall(_request_bytes())
                assert _read_response(sock)[0] == 200
                sock.settimeout(5)
                assert sock.recv(65536) == b""
            finally:
                sock.close()
            _wait_until(lambda: fe.n_idle_reaped >= 1, what="idle reap")


# ---------------------------------------------------------------------------
# the coordinator over two port workers


def test_coordinator_merges_two_port_workers():
    with ServingCoordinator(port=0) as coord:
        curl = f"http://127.0.0.1:{coord.port}"
        workers = []
        try:
            for n_new in (2, 3):
                sched = D.DecodeScheduler(_decoder(),
                                          max_new_tokens_default=4)
                srv = ServingServer(Doubler(), port=0, decoder=sched,
                                    max_latency_ms=1,
                                    verify_checkpoints=False).start()
                workers.append(srv)
                ServingCoordinator.register_worker(curl, srv.host,
                                                   srv.port)
                r = requests.post(
                    f"http://{srv.host}:{srv.port}/generate",
                    json={"prompt": [7, 8], "max_new_tokens": n_new},
                    timeout=30)
                assert r.json()["tokens"] == _greedy_reference([7, 8],
                                                               n_new)
            text = requests.get(curl + "/fleet/metrics", timeout=10).text
            (line,) = [ln for ln in text.splitlines()
                       if ln.startswith("serving_decode_tokens_total")]
            assert float(line.rsplit(" ", 1)[1]) == 5.0
            assert "serving_build_info" in text
            client = ServingClient(curl)
            assert client.predict({"x": 4.0}) == {"y": 8.0}
            assert len(client.refresh()) == 2
        finally:
            for srv in workers:
                srv.stop()
