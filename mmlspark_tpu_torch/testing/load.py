"""Many-connection keep-alive HTTP load driver.

The port's copy of ``mmlspark_tpu/testing/load.py`` (pure stdlib, no
JAX in it): the CLIENT side of a serving benchmark against
:mod:`mmlspark_tpu_torch.serving.frontend`. One selectors event loop
drives N concurrent HTTP/1.1 keep-alive connections, each running serial
(pipelining-free) request/response cycles against a serving worker.
``threading`` + ``http.client`` top out around a few hundred concurrent
sockets before scheduler overhead dominates; this loop holds 1k+
connections at a few MB of state, so a client does not hit its own
concurrency ceiling before the server's. TLS rides an ``ssl_context``
(the port's :mod:`mmlspark_tpu_torch.testing.tls` makes a throwaway
one for localhost).
"""

from __future__ import annotations

import selectors
import socket
import time
from typing import Dict, Iterable, Optional, Tuple

try:
    import ssl as _ssl
except ImportError:  # pragma: no cover
    _ssl = None  # type: ignore[assignment]

_WANT = ((_ssl.SSLWantReadError, _ssl.SSLWantWriteError)
         if _ssl is not None else ())

__all__ = ["drive_keepalive", "build_request"]

_CRLF2 = b"\r\n\r\n"


def build_request(host: str, path: str, payload: bytes,
                  extra_headers: Iterable[Tuple[str, str]] = ()) -> bytes:
    """One POST request, prebuilt: every cycle on a connection sends
    these exact bytes, so the driver's per-request cost is a send and
    a parse — no formatting on the hot path."""
    lines = [f"POST {path} HTTP/1.1",
             f"Host: {host}",
             "Content-Type: application/json",
             f"Content-Length: {len(payload)}"]
    for k, v in extra_headers:
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + payload


class _ClientConn:
    __slots__ = ("sock", "out", "buf", "t_send", "n_done", "awaiting",
                 "connected", "hs")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.out = b""          # unsent request bytes
        self.buf = bytearray()  # response accumulation
        self.t_send = 0.0
        self.n_done = 0
        self.awaiting = False   # a response is outstanding
        self.connected = False
        self.hs = False         # TLS handshake in progress


def drive_keepalive(host: str, port: int, path: str = "/predict",
                    payload: bytes = b'{"x": 0.0}', *,
                    n_connections: int = 100,
                    duration_s: Optional[float] = None,
                    requests_per_conn: Optional[int] = None,
                    extra_headers: Iterable[Tuple[str, str]] = (),
                    settle_timeout: float = 30.0,
                    connect_burst: int = 256,
                    ssl_context=None,
                    tls_server_hostname: Optional[str] = None
                    ) -> Dict[str, object]:
    """Drive ``n_connections`` concurrent keep-alive connections, each
    cycling serial request/response (a new request leaves only after
    the previous response arrived — pipelining-free, like real
    clients). Stop after ``duration_s`` seconds OR after every
    connection completed ``requests_per_conn`` cycles (at least one
    must be given; with both, whichever comes first), then give
    in-flight responses ``settle_timeout`` to land.

    Returns req/s, latency percentiles, the connection-reuse rate
    (requests served on an already-used connection / all requests —
    1 - 1/cycles when keep-alive holds), and the connection-level
    error count (resets, refusals, unexpected server closes — the
    number the concurrency acceptance gate requires to be zero).
    """
    if duration_s is None and requests_per_conn is None:
        raise ValueError("need duration_s and/or requests_per_conn")
    req = build_request(host, path, payload, extra_headers)
    sel = selectors.DefaultSelector()
    conns: list[_ClientConn] = []
    latencies: list[float] = []
    conn_errors = 0
    http_errors = 0
    t_start = time.perf_counter()
    stop_at = (t_start + duration_s) if duration_s else float("inf")

    def fail(c: _ClientConn) -> None:
        nonlocal conn_errors
        conn_errors += 1
        close(c)

    def close(c: _ClientConn) -> None:
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError):
            pass
        try:
            c.sock.close()
        except OSError:
            pass
        live.discard(c)

    def done(c: _ClientConn) -> bool:
        return (requests_per_conn is not None
                and c.n_done >= requests_per_conn)

    def send_next(c: _ClientConn, now: float) -> None:
        c.t_send = now
        c.awaiting = True
        c.out = req
        pump_out(c)

    def pump_out(c: _ClientConn) -> None:
        if c.out:
            try:
                n = c.sock.send(c.out)
                c.out = c.out[n:]
            except (BlockingIOError, InterruptedError):
                pass
            except _WANT:
                pass
            except OSError:
                fail(c)
                return
        want = selectors.EVENT_READ | (selectors.EVENT_WRITE
                                       if c.out else 0)
        try:
            sel.modify(c.sock, want, c)
        except (KeyError, ValueError, OSError):
            pass

    def start_tls(c: _ClientConn) -> None:
        """Upgrade a just-connected socket: re-register the wrapped
        SSLSocket (wrap detaches the plain one) and drive the
        handshake from loop events."""
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError):
            pass
        try:
            kw = {}
            if tls_server_hostname is not None:
                kw["server_hostname"] = tls_server_hostname
            c.sock = ssl_context.wrap_socket(
                c.sock, do_handshake_on_connect=False, **kw)
        except (OSError, ValueError):
            fail(c)
            return
        c.hs = True
        sel.register(c.sock,
                     selectors.EVENT_READ | selectors.EVENT_WRITE, c)
        try_handshake(c)

    def try_handshake(c: _ClientConn) -> None:
        try:
            c.sock.do_handshake()
        except _ssl.SSLWantReadError:
            try:
                sel.modify(c.sock, selectors.EVENT_READ, c)
            except (KeyError, ValueError, OSError):
                pass
            return
        except _ssl.SSLWantWriteError:
            try:
                sel.modify(c.sock, selectors.EVENT_WRITE, c)
            except (KeyError, ValueError, OSError):
                pass
            return
        except OSError:
            fail(c)
            return
        c.hs = False
        send_next(c, time.perf_counter())

    # -- connect phase: bounded bursts so n_connections SYNs never
    # overflow the listen backlog at once
    live: set = set()
    to_open = n_connections
    while to_open > 0:
        burst = min(to_open, connect_burst)
        opened = []
        for _ in range(burst):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setblocking(False)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            rc = s.connect_ex((host, port))
            if rc not in (0, 115, 36, 10035):  # EINPROGRESS variants
                s.close()
                conn_errors += 1
                continue
            c = _ClientConn(s)
            conns.append(c)
            opened.append(c)
            live.add(c)
            sel.register(s, selectors.EVENT_WRITE, c)
        # wait for this burst to finish its handshakes before the next
        t_burst = time.perf_counter() + 10.0
        pending = {c for c in opened}
        while pending and time.perf_counter() < t_burst:
            for key, _mask in sel.select(timeout=0.25):
                c = key.data
                if c.hs and c not in pending:
                    try_handshake(c)     # earlier bursts' TLS upgrades
                    continue
                if c in pending:
                    err = c.sock.getsockopt(socket.SOL_SOCKET,
                                            socket.SO_ERROR)
                    pending.discard(c)
                    if err:
                        fail(c)
                    elif ssl_context is not None:
                        c.connected = True
                        start_tls(c)     # handshake rides loop events
                    else:
                        c.connected = True
                        send_next(c, time.perf_counter())
        for c in pending:       # handshake never completed
            fail(c)
        to_open -= burst

    # -- steady state: serial request/response cycles per connection
    issuing = True
    while live:
        now = time.perf_counter()
        if issuing and now >= stop_at:
            issuing = False
            settle_at = now + settle_timeout
        if not issuing:
            if not any(c.awaiting for c in live):
                break
            if now >= settle_at:
                for c in list(live):
                    if c.awaiting:
                        fail(c)
                break
        for key, mask in sel.select(timeout=0.25):
            c = key.data
            if c not in live:
                continue
            if c.hs:
                try_handshake(c)
                continue
            if mask & selectors.EVENT_WRITE:
                if not c.connected:
                    c.connected = True
                pump_out(c)
                if c not in live:
                    continue
            if not (mask & selectors.EVENT_READ):
                continue
            try:
                data = c.sock.recv(65536)
                if ssl_context is not None and data:
                    # decrypted bytes can sit in the SSL layer with
                    # nothing left on the raw fd — drain them now
                    while c.sock.pending():
                        more = c.sock.recv(65536)
                        if not more:
                            break
                        data += more
            except (BlockingIOError, InterruptedError):
                continue
            except _WANT:
                continue
            except OSError:
                fail(c)
                continue
            if not data:
                # server closed: mid-response it's an error; after a
                # completed cycle it still breaks the keep-alive
                # contract this driver exists to measure
                fail(c)
                continue
            c.buf += data
            # one response per cycle: parse head, wait for the body
            while c.awaiting:
                he = c.buf.find(_CRLF2)
                if he < 0:
                    break
                head = bytes(c.buf[:he])
                clen = 0
                for line in head.split(b"\r\n")[1:]:
                    if line[:15].lower() == b"content-length:":
                        try:
                            clen = int(line[15:])
                        except ValueError:
                            pass
                        break
                total = he + 4 + clen
                if len(c.buf) < total:
                    break
                t_now = time.perf_counter()
                latencies.append(t_now - c.t_send)
                status = head.split(b" ", 2)[1:2]
                if status != [b"200"]:
                    http_errors += 1
                del c.buf[:total]
                c.n_done += 1
                c.awaiting = False
                if done(c) or not issuing:
                    if done(c):
                        close(c)
                else:
                    send_next(c, t_now)
        if requests_per_conn is not None and not live:
            break

    elapsed = time.perf_counter() - t_start
    for c in list(live):
        close(c)
    sel.close()
    n_reqs = len(latencies)
    n_conns_used = sum(1 for c in conns if c.n_done > 0)
    reuses = sum(max(c.n_done - 1, 0) for c in conns)
    lat_sorted = sorted(latencies)

    def pct(p: float) -> float:
        if not lat_sorted:
            return 0.0
        i = min(int(p / 100.0 * len(lat_sorted)), len(lat_sorted) - 1)
        return lat_sorted[i] * 1000.0

    return {
        "n_connections": n_connections,
        "n_connected": n_conns_used,
        "requests": n_reqs,
        "elapsed_s": round(elapsed, 3),
        "rps": round(n_reqs / elapsed, 1) if elapsed > 0 else 0.0,
        "p50_ms": round(pct(50), 3),
        "p99_ms": round(pct(99), 3),
        "conn_errors": conn_errors,
        "http_errors": http_errors,
        "reuse_rate": round(reuses / n_reqs, 4) if n_reqs else 0.0,
    }
