"""Event-loop serving frontend: the socket edge of the data plane (the
port's copy of ``mmlspark_tpu/serving/frontend.py``).

Replaces the ``ThreadingHTTPServer``/``BaseHTTPRequestHandler`` ingress
(one thread per connection, line-at-a-time header parsing, three writes
per reply) with a :mod:`selectors`-based non-blocking frontend built for
the rates the staged pipeline can already sustain:

* **keep-alive connection reuse** — HTTP/1.1 persistent connections are
  the steady state, not an option: a connection parks in the loop
  between requests at the cost of one registered fd, never a thread;
* **incremental zero-copy framing** — requests are parsed straight out
  of a per-connection receive buffer: one ``\\r\\n\\r\\n`` scan finds the
  header block, one pre-compiled regex pass over it extracts the
  headers (no per-line split, no per-line decode — header values are
  decoded lazily, only when someone reads them), and the body is sliced
  out once via ``memoryview``;
* **vectored single-syscall replies** — the response head is assembled
  from cached blocks (per-status line, a once-a-second Date header,
  common Content-Type lines) and handed to ``socket.sendmsg([head,
  body])``: one syscall per reply, no head+body concatenation copy;
* **multi-acceptor ``SO_REUSEPORT`` loops** — ``acceptors=N`` with
  ``reuse_port=True`` binds N listening sockets to the one port and
  runs N independent event loops; the kernel load-balances accepted
  connections across them, so the socket edge scales past one loop's
  ceiling while every loop feeds the same staged
  collect/assemble -> dispatch -> encode executor.

The frontend is transport only. It speaks to its application through a
three-method protocol (duck-typed — :class:`ServingServer` and
:class:`ServingCoordinator` both implement it):

``app.handle_request(method, path, headers, body, reply) -> bool``
    Handle one request. ``reply(status, body, ctype=..., extra=...)``
    must be called EXACTLY ONCE — synchronously, or later from any
    thread (the serving pipeline's encoder threads call it at commit
    time). Return ``False`` for an unknown route (the frontend sends
    the 404). The frontend guarantees a late/duplicate ``reply`` (e.g.
    racing the request-timeout sweep) is dropped, never misdelivered
    to a newer request on the same connection.

Timeouts (all enforced by a per-loop sweep, not per-socket timers):

* ``idle_timeout`` — a connection parked *between* requests longer than
  this is closed, and a connection stuck *mid-request* (the slow-loris
  shape: headers or body dribbling in forever) is reaped on the same
  clock. ``<= 0`` disables reaping, matching the threaded frontend.
* ``request_timeout`` — a dispatched request whose ``reply`` has not
  arrived within this budget is answered 504 by the sweep (the
  stuck-batch contract the threaded frontend implements with
  ``Event.wait``); the eventual real reply is dropped by generation.

Fairness and shedding at the socket edge:

* ``max_pipelined_per_iter`` — at most this many buffered pipelined
  requests are served per connection per loop pass; the remainder is
  deferred to the next iteration (``serving_pipelining_deferred_total``
  counts deferrals), so a single connection flooding pipelined requests
  cannot monopolize a loop while other connections wait.
* ``max_conns_per_ip`` — a per-peer-address concurrent-connection cap
  enforced at accept, IN FRONT of the application's ``max_queue``
  shedding: over-cap accepts get an immediate 429 + close
  (``serving_per_ip_rejected_total``), and the observed per-IP
  high-water mark is exported as a gauge.

Protocol guardrails (each satisfies one of the framing edge cases the
frontend must not inherit from ``http.server``): header blocks beyond
``max_header_bytes`` are rejected 431; POST bodies need a valid
``Content-Length`` (missing -> 411, unparseable -> 400, beyond
``max_body_bytes`` -> 413); ``Connection: close`` (and HTTP/1.0 without
``keep-alive``) is honored; ``Transfer-Encoding: chunked`` is refused
501 (the serving wire contract is Content-Length-framed JSON).

See ``docs/serving.md`` ("The socket edge") for operator-facing knobs
and ``docs/observability.md`` for the connection gauges.
"""

from __future__ import annotations

import errno
import re
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from contextlib import contextmanager

try:
    import ssl
except ImportError:  # pragma: no cover — stripped-down interpreters
    ssl = None  # type: ignore[assignment]

# except-clause tuples that stay valid (matching nothing) without ssl
_TLS_WANT_READ: tuple = (ssl.SSLWantReadError,) if ssl is not None else ()
_TLS_WANT_WRITE: tuple = (ssl.SSLWantWriteError,) if ssl is not None \
    else ()

from mmlspark_tpu_torch.core.logs import get_logger

logger = get_logger("serving.frontend")

__all__ = ["EventLoopFrontend", "Headers", "batched_replies"]


# ---------------------------------------------------------------------------
# Batched reply flushing
# ---------------------------------------------------------------------------

#: per-thread reply batch: while a :func:`batched_replies` scope is
#: active on a committing thread, ``_Loop.post_reply`` parks replies
#: here (keyed by loop) instead of queue-append + wake per reply; the
#: scope exit flushes each loop's batch with ONE deque extend and ONE
#: wake. Thread-local, so concurrent encoder threads batch
#: independently with no shared state.
_REPLY_BATCH = threading.local()


@contextmanager
def batched_replies():
    """Coalesce cross-thread reply posts made inside the scope.

    The serving pipeline commits replies per micro-batch
    (``_commit_many``): without batching, N replies destined for N
    distinct connections on the same loop cost N wake checks and up to
    N wake syscalls; inside this scope they land in one deque extend
    and one wake per *loop*, and the loop delivers them all in one
    pass. Safe to nest (the outermost scope flushes) and to use on any
    thread; in-loop synchronous replies never hit the batch (they
    deliver inline, as before)."""
    if getattr(_REPLY_BATCH, "active", None) is not None:
        yield                      # nested: the outer scope flushes
        return
    batch: Dict[Any, list] = {}
    _REPLY_BATCH.active = batch
    try:
        yield
    finally:
        _REPLY_BATCH.active = None
        for loop, items in batch.items():
            loop.flush_replies(items)


# ---------------------------------------------------------------------------
# Request framing
# ---------------------------------------------------------------------------

#: one pass over the header block: RFC 7230 token names, optional
#: whitespace, value to end-of-line. Compiled once; runs directly on
#: the connection's ``bytearray`` receive buffer (re accepts any buffer
#: object), so the scan itself copies nothing — only the matched
#: name/value groups materialize, and values stay bytes until someone
#: reads them.
_HDR_RE = re.compile(rb"([!#$%&'*+\-.^_`|~0-9A-Za-z]+):[ \t]*([^\r\n]*)")

_CRLF2 = b"\r\n\r\n"


class Headers:
    """Case-insensitive, decode-lazy view over parsed header bytes.

    ``get`` mirrors the stdlib message API the rest of the stack codes
    against (``headers.get("X-Trace-Id")`` in
    :func:`~mmlspark_tpu_torch.core.tracing.extract_span_context`,
    ``Deadline.from_headers``...), decoding a value (latin-1, the HTTP
    wire charset) only when it is actually read."""

    __slots__ = ("_raw",)

    def __init__(self, raw: Dict[bytes, bytes]):
        self._raw = raw

    def get(self, name: str, default: Optional[str] = None
            ) -> Optional[str]:
        v = self._raw.get(name.lower().encode("ascii"))
        return default if v is None else v.decode("latin-1")

    def get_bytes(self, lname: bytes, default: bytes = b"") -> bytes:
        return self._raw.get(lname, default)

    def __contains__(self, name: str) -> bool:
        return name.lower().encode("ascii") in self._raw

    def items(self):
        return [(k.decode("latin-1"), v.decode("latin-1"))
                for k, v in self._raw.items()]

    def __repr__(self) -> str:
        return f"Headers({self._raw!r})"


def parse_head(buf, head_end: int) -> Tuple[bytes, str, bytes, Headers]:
    """Parse ``buf[:head_end]`` (request line + header block, no final
    CRLFCRLF) into ``(method, path, version, headers)``.

    ``buf`` is the connection's receive buffer (bytes/bytearray —
    bytearray in production: ``find`` and the regex scan both run on it
    directly, so nothing is sliced or copied but the request line); the
    header scan is ONE pre-compiled regex pass bounded by pos/endpos —
    no line split, no per-line decode, no buffer slice. Raises
    ``ValueError`` on a malformed request line; malformed header lines
    (no colon) are skipped rather than fatal — lenient like the stdlib
    parser."""
    line_end = buf.find(b"\r\n", 0, head_end)
    if line_end < 0:
        line_end = head_end
    line = bytes(buf[:line_end])
    sp1 = line.find(b" ")
    sp2 = line.rfind(b" ")
    if sp1 <= 0 or sp2 <= sp1:
        raise ValueError(f"malformed request line: {line[:80]!r}")
    method = line[:sp1]
    path = line[sp1 + 1:sp2].decode("latin-1")
    version = line[sp2 + 1:]
    raw: Dict[bytes, bytes] = {}
    for m in _HDR_RE.finditer(buf, line_end + 2, head_end):
        raw[m.group(1).lower()] = m.group(2)
    return method, path, version, Headers(raw)


# ---------------------------------------------------------------------------
# Cached reply blocks
# ---------------------------------------------------------------------------

_PHRASES = {
    200: b"HTTP/1.1 200 OK\r\n",
    400: b"HTTP/1.1 400 Bad Request\r\n",
    404: b"HTTP/1.1 404 Not Found\r\n",
    408: b"HTTP/1.1 408 Request Timeout\r\n",
    411: b"HTTP/1.1 411 Length Required\r\n",
    413: b"HTTP/1.1 413 Payload Too Large\r\n",
    429: b"HTTP/1.1 429 Too Many Requests\r\n",
    431: b"HTTP/1.1 431 Request Header Fields Too Large\r\n",
    500: b"HTTP/1.1 500 Internal Server Error\r\n",
    501: b"HTTP/1.1 501 Not Implemented\r\n",
    503: b"HTTP/1.1 503 Service Unavailable\r\n",
    504: b"HTTP/1.1 504 Gateway Timeout\r\n",
}


def _status_line(status: int) -> bytes:
    line = _PHRASES.get(status)
    if line is None:
        line = b"HTTP/1.1 %d Status\r\n" % status
        _PHRASES[status] = line
    return line


# the Date header changes once a second; format it at most that often
# (shared across every loop and connection — wall clock is process-wide)
_DATE_CACHE: List[Any] = [0.0, b""]


def _date_line() -> bytes:
    now = time.time()
    if now - _DATE_CACHE[0] >= 1.0:
        from email.utils import formatdate
        # value BEFORE timestamp: a racing reader that sees the fresh
        # timestamp must never read the stale (or empty) bytes
        _DATE_CACHE[1] = ("Date: " + formatdate(now, usegmt=True)
                          + "\r\n").encode("ascii")
        _DATE_CACHE[0] = now
    return _DATE_CACHE[1]


_CTYPE_JSON = b"Content-Type: application/json\r\n"
_CONN_CLOSE = b"Connection: close\r\n"
_CL_PREFIX = b"Content-Length: "

#: Content-Length lines for small bodies, interned once: the common
#: replies (~10-200 byte JSON) skip the int->bytes format entirely
_CL_CACHE = [b"Content-Length: %d\r\n" % n for n in range(1024)]


def build_head(status: int, body_len: int,
               ctype: str = "application/json",
               extra: Tuple[Tuple[str, str], ...] = (),
               close: bool = False) -> bytes:
    """Assemble a response head from cached blocks. One ``join`` — the
    body is NOT concatenated here; ``sendmsg([head, body])`` carries
    both in one syscall without the copy."""
    parts = [_status_line(status), _date_line(),
             _CTYPE_JSON if ctype == "application/json"
             else b"Content-Type: " + ctype.encode("latin-1") + b"\r\n",
             _CL_CACHE[body_len] if body_len < 1024
             else _CL_PREFIX + str(body_len).encode("ascii") + b"\r\n"]
    for k, v in extra:
        parts.append(f"{k}: {v}\r\n".encode("latin-1"))
    if close:
        parts.append(_CONN_CLOSE)
    parts.append(b"\r\n")
    return b"".join(parts)


_SSE_CTYPE = b"Content-Type: text/event-stream\r\n"
_CHUNKED = b"Transfer-Encoding: chunked\r\nCache-Control: no-cache\r\n"


def build_stream_head(status: int = 200,
                      extra: Tuple[Tuple[str, str], ...] = (),
                      close: bool = False) -> bytes:
    """Response head for a chunked SSE stream: no Content-Length —
    ``Transfer-Encoding: chunked`` frames the incremental body, so the
    connection stays keep-alive after the terminal chunk."""
    parts = [_status_line(status), _date_line(), _SSE_CTYPE, _CHUNKED]
    for k, v in extra:
        parts.append(f"{k}: {v}\r\n".encode("latin-1"))
    if close:
        parts.append(_CONN_CLOSE)
    parts.append(b"\r\n")
    return b"".join(parts)


def _chunk(data: bytes) -> bytes:
    return b"%x\r\n" % len(data) + data + b"\r\n"


class _EventLoopStream:
    """A live incremental response on one event-loop connection.

    Producers (the decode scheduler's loop thread) call :meth:`emit`
    per event and :meth:`finish` once; both post to the owning loop,
    which frames each event as an HTTP chunk and rides the existing
    non-blocking write state machine (partial writes continue via
    ``conn.out`` + EVENT_WRITE). ``closed`` flips when the peer
    disconnects mid-stream or the bounded per-connection buffer
    overflows (slow consumer) — producers poll it and cancel their
    work; writes after ``closed`` are dropped."""

    __slots__ = ("_loop", "_conn", "_gen", "closed", "done", "t_first")

    def __init__(self, loop: "_Loop", conn: "_Conn", gen: int):
        self._loop = loop
        self._conn = conn
        self._gen = gen
        self.closed = False
        self.done = False
        # monotonic stamp of the FIRST chunk hitting the socket write
        # path — the client-observable TTFT edge (0.0 = none yet)
        self.t_first = 0.0

    def emit(self, data: bytes) -> None:
        if self.closed or self.done:
            return
        self._loop.post_stream(self._conn, self._gen, data, False)

    def finish(self, data: bytes = b"") -> None:
        if self.closed or self.done:
            return
        self.done = True
        self._loop.post_stream(self._conn, self._gen, data, True)


# ---------------------------------------------------------------------------
# Connection state machine
# ---------------------------------------------------------------------------

_HEAD, _BODY, _AWAIT, _CLOSING, _STREAM, _TLS_HS = 0, 1, 2, 3, 4, 5

#: sentinel tag marking a stream item on the shared reply deque
_STREAM_TAG = object()


class _Conn:
    __slots__ = ("sock", "fd", "buf", "scanned", "state", "gen", "out",
                 "t_last", "t_req_start", "t_await", "n_requests",
                 "keep_alive", "method", "path", "headers", "body_start",
                 "body_len", "want_write", "advancing", "peer_ip",
                 "stream", "tls")

    def __init__(self, sock: socket.socket, peer_ip: str = ""):
        self.sock = sock
        self.peer_ip = peer_ip
        # TLS connection: reads/writes go through the SSL record layer
        # (no sendmsg; SSLWantRead/WantWrite instead of EAGAIN), and
        # the connection starts life in the _TLS_HS handshake state
        self.tls = False
        self.fd = sock.fileno()
        self.buf = bytearray()
        self.scanned = 0            # CRLFCRLF search resume offset
        self.state = _HEAD
        # reply generation: bumped every time the in-flight request slot
        # is consumed (reply delivered OR timed out/aborted), so a stale
        # reply callback can never answer a LATER request on this socket
        self.gen = 0
        self.out = bytearray()      # unwritten reply bytes (rare path)
        self.t_last = 0.0           # last byte received (idle reaping)
        self.t_req_start = 0.0      # first byte of the current request
        self.t_await = 0.0          # when the current request dispatched
        self.n_requests = 0
        self.keep_alive = True
        self.method = b""
        self.path = ""
        self.headers: Optional[Headers] = None
        self.body_start = 0
        self.body_len = 0
        self.want_write = False
        self.advancing = False
        self.stream: Optional[_EventLoopStream] = None


class _Loop(threading.Thread):
    """One acceptor + event loop: a listening socket, a selector, the
    connections the kernel handed this loop, and a thread-safe reply
    queue fed by the pipeline's commit callbacks."""

    def __init__(self, frontend: "EventLoopFrontend", index: int,
                 listener: socket.socket):
        super().__init__(daemon=True,
                         name=f"{frontend.name}-frontend-{index}")
        self.frontend = frontend
        self.index = index
        self.listener = listener
        self.sel = selectors.DefaultSelector()
        self.conns: Dict[int, _Conn] = {}
        # pipelining-fairness continuations: connections whose buffered
        # requests were deferred mid-_advance (cap reached) resume here
        # on the NEXT loop iteration, after every other connection's
        # events were handled
        self._deferred: Dict[int, _Conn] = {}
        self._replies: deque = deque()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._wake_pending = False
        self._accepting = True
        self._stopping = False
        # busy-ratio window: time spent processing events vs wall time,
        # refreshed every ~2 s — the accept-loop saturation gauge
        self.busy_ratio = 0.0
        self._win_t0 = time.monotonic()
        self._win_busy = 0.0

    # -- cross-thread entry points ------------------------------------------

    def post_reply(self, conn: _Conn, gen: int, head: bytes,
                   body: bytes, close_after: bool) -> None:
        """Queue a reply for delivery by the loop thread; safe from any
        thread. In-loop callers deliver inline (no queue round-trip);
        inside a :func:`batched_replies` scope, cross-thread replies
        park in the thread-local batch and flush together."""
        if threading.get_ident() == self.ident:
            self._deliver(conn, gen, head, body, close_after)
            return
        batch = getattr(_REPLY_BATCH, "active", None)
        if batch is not None:
            batch.setdefault(self, []).append(
                (conn, gen, head, body, close_after))
            return
        self._replies.append((conn, gen, head, body, close_after))
        self.wake()

    def flush_replies(self, items: list) -> None:
        """Batched-commit flush: every reply in ``items`` joins the
        delivery deque in one extend, then ONE wake — the loop serves
        them all in a single pass (vs one wake check per reply)."""
        if not items:
            return
        self._replies.extend(items)
        fe = self.frontend
        fe.n_reply_flushes += 1
        fe.n_batched_replies += len(items)
        self.wake()

    def post_stream(self, conn: _Conn, gen: int, data: bytes,
                    end: bool) -> None:
        """Queue one stream event (or the terminal event) for
        delivery by the loop thread; safe from any thread."""
        if threading.get_ident() == self.ident:
            self._deliver_stream(conn, gen, data, end)
            return
        self._replies.append((_STREAM_TAG, conn, gen, data, end))
        self.wake()

    def open_stream(self, conn: _Conn, gen: int,
                    extra: Tuple[Tuple[str, str], ...] = ()
                    ) -> Optional[_EventLoopStream]:
        """Switch the in-flight request to incremental delivery: send
        the chunked-SSE head now, return the producer handle. LOOP
        THREAD ONLY (called synchronously from ``handle_request``);
        None when the request is no longer current."""
        if conn.fd not in self.conns or conn.gen != gen \
                or conn.state != _AWAIT:
            return None
        conn.state = _STREAM
        handle = _EventLoopStream(self, conn, gen)
        conn.stream = handle
        self.frontend.n_streams += 1
        self._write(conn, build_stream_head(
            200, extra, close=not conn.keep_alive), b"", False)
        return handle

    def _deliver_stream(self, conn: _Conn, gen: int, data: bytes,
                        end: bool) -> None:
        """Frame one SSE event as an HTTP chunk IF the stream is still
        current; the terminal event also writes the zero chunk and
        returns the connection to keep-alive (or closes it)."""
        if conn.fd not in self.conns or conn.gen != gen \
                or conn.state != _STREAM:
            return
        fe = self.frontend
        if len(conn.out) > fe.max_stream_buffer_bytes:
            # slow-consumer backpressure: the bounded per-conn buffer
            # is full — drop the connection rather than balloon memory
            # (the producer sees handle.closed and cancels its work)
            fe.n_stream_overflows += 1
            self._close(conn)
            return
        payload = _chunk(data) if data else b""
        if not end:
            fe.n_stream_events += 1
            # the stall clock: a stream is alive as long as events
            # flow — the sweep reaps streams whose LAST event is older
            # than request_timeout (the threaded frontend's
            # q.get(timeout) analogue)
            conn.t_await = time.monotonic()
            stream = conn.stream
            if stream is not None and stream.t_first == 0.0:
                # socket-edge TTFT: the decode scheduler reads this
                # at finish in preference to its own loop-side stamp
                stream.t_first = conn.t_await
            self._write(conn, payload, b"", False)
            return
        payload += b"0\r\n\r\n"                 # terminal chunk
        close_after = not conn.keep_alive
        conn.stream = None
        conn.gen += 1
        conn.state = _CLOSING if close_after else _HEAD
        conn.t_req_start = conn.t_last = time.monotonic()
        fe.n_stream_events += 1
        self._write(conn, payload, b"", close_after)
        if conn.fd in self.conns and conn.state == _HEAD \
                and not conn.out:
            self._advance(conn)       # serve pipelined follow-ups

    def wake(self) -> None:
        # one pending byte is enough to wake the selector; the flag
        # keeps a burst of commits from paying one syscall each (reads
        # and writes of a bool are atomic under the GIL; a lost race
        # costs one harmless extra byte)
        if not self._wake_pending:
            self._wake_pending = True
            try:
                self._wake_w.send(b"\x01")
            except OSError:
                pass

    def pause_accept(self) -> None:
        self._accepting = False
        self.wake()

    def request_stop(self) -> None:
        self._stopping = True
        self.wake()

    # -- the loop ------------------------------------------------------------

    def run(self) -> None:
        fe = self.frontend
        self.sel.register(self.listener, selectors.EVENT_READ, "accept")
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        last_sweep = time.monotonic()
        # sweep often enough that short idle timeouts (tests use 0.3 s)
        # reap within a fraction of their budget
        tick = 0.05 if 0 < fe.idle_timeout <= 1.0 else 0.25
        try:
            while True:
                t_sel = time.monotonic()
                # never park in select while deferred pipelined work is
                # waiting — it was deferred for fairness, not for later
                events = self.sel.select(
                    timeout=0 if self._deferred else tick)
                t0 = time.monotonic()
                if self._stopping:
                    break
                self._wake_pending = False
                for key, mask in events:
                    what = key.data
                    if what == "accept":
                        self._accept_burst()
                    elif what == "wake":
                        self._drain_wake()
                    else:
                        conn = what
                        if mask & selectors.EVENT_WRITE:
                            self._on_writable(conn)
                        if mask & selectors.EVENT_READ and \
                                conn.fd in self.conns:
                            self._on_readable(conn)
                self._drain_replies()
                if self._deferred:
                    # resume capped pipelined connections: one fresh
                    # _advance budget each, AFTER this iteration's
                    # events — a flooding connection progresses, but
                    # never monopolizes the loop
                    resumed = list(self._deferred.values())
                    self._deferred.clear()
                    for conn in resumed:
                        if conn.fd in self.conns:
                            self._advance(conn)
                if not self._accepting and self.listener is not None:
                    self._close_listener()
                now = time.monotonic()
                if now - last_sweep >= tick:
                    self._sweep(now)
                    last_sweep = now
                # busy-ratio bookkeeping (saturation telemetry): the
                # fraction of wall time NOT spent blocked in select()
                self._win_busy += now - t0
                if now - self._win_t0 >= 2.0:
                    span = max(now - self._win_t0, 1e-9)
                    self.busy_ratio = min(self._win_busy / span, 1.0)
                    self._win_t0, self._win_busy = now, 0.0
                _ = t_sel
        except Exception:  # noqa: BLE001 — a dead loop strands its fds
            logger.error("frontend loop %d crashed", self.index,
                         exc_info=True)
        finally:
            self._shutdown()

    # -- accept --------------------------------------------------------------

    def _accept_burst(self) -> None:
        fe = self.frontend
        if self.listener is None:
            return
        for _ in range(256):          # bounded: never starve live conns
            try:
                sock, _addr = self.listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if not self._accepting:
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass                  # AF_UNIX etc.
            peer_ip = _addr[0] if isinstance(_addr, tuple) and _addr \
                else ""
            if not fe._ip_acquire(peer_ip):
                # per-IP shedding layer: one peer flooding connections
                # is refused at accept — an immediate 429 + close —
                # BEFORE it can occupy queue slots other clients need.
                # Best-effort single send: the socket was just
                # accepted, so the tiny reply fits the send buffer.
                # (On a TLS port there is no handshake to speak the
                # reply over — the close alone is the signal.)
                fe.n_per_ip_rejected += 1
                if fe.ssl_context is None:
                    body = (b'{"error": "too many connections from '
                            b'this address"}')
                    try:
                        sock.send(build_head(
                            429, len(body),
                            extra=(("Retry-After", "1"),),
                            close=True) + body)
                    except OSError:
                        pass
                sock.close()
                continue
            if fe.ssl_context is not None:
                # TLS termination: wrap now, handshake incrementally on
                # the loop (the _TLS_HS state) — a slow (or silent, or
                # plaintext-speaking) peer never blocks this thread
                try:
                    sock = fe.ssl_context.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False)
                except (OSError, ValueError):
                    fe._ip_release(peer_ip)
                    sock.close()
                    continue
            conn = _Conn(sock, peer_ip)
            if fe.ssl_context is not None:
                conn.tls = True
                conn.state = _TLS_HS
            conn.t_last = conn.t_req_start = time.monotonic()
            self.conns[conn.fd] = conn
            fe.n_connections += 1
            self.sel.register(sock, selectors.EVENT_READ, conn)

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _close_listener(self) -> None:
        if self.listener is None:
            return
        try:
            self.sel.unregister(self.listener)
        except (KeyError, ValueError):
            pass
        try:
            self.listener.close()
        except OSError:
            pass
        self.listener = None

    # -- TLS handshake -------------------------------------------------------

    def _tls_handshake(self, conn: _Conn) -> None:
        """Drive one step of the non-blocking TLS handshake — a
        first-class connection state, not a blocking call: WantRead
        leaves the read registration in place, WantWrite re-registers
        for writability, success moves to ``_HEAD``, and anything else
        (a plaintext byte on the TLS port, a bad record, a mid-
        handshake disconnect) closes cleanly and counts a failure."""
        fe = self.frontend
        try:
            conn.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._want_write(conn, False)
            return
        except ssl.SSLWantWriteError:
            self._want_write(conn, True)
            return
        except (OSError, ValueError):
            # ssl.SSLError subclasses OSError: plaintext on a TLS
            # port, protocol mismatch, EOF mid-handshake — all end
            # here, closed without a stack trace or a stuck fd
            fe.n_tls_handshake_failures += 1
            self._close(conn)
            return
        fe.n_tls_handshakes += 1
        conn.state = _HEAD
        self._want_write(conn, False)
        conn.t_last = conn.t_req_start = time.monotonic()
        if conn.sock.pending():
            # the read that finished the handshake may have pulled the
            # first request's app-data record off the wire with it: the
            # decrypted bytes sit in the SSL layer, the raw fd is empty,
            # and the selector would never fire — serve them now
            self._on_readable(conn)

    # -- read + parse --------------------------------------------------------

    def _on_readable(self, conn: _Conn) -> None:
        if conn.state == _TLS_HS:
            self._tls_handshake(conn)
            return
        try:
            data = conn.sock.recv(65536)
            if conn.tls and data:
                # the SSL layer may hold MORE decrypted bytes than one
                # recv returned, with nothing left on the raw socket —
                # the selector would never fire again for them
                while conn.sock.pending():
                    more = conn.sock.recv(65536)
                    if not more:
                        break
                    data += more
        except (BlockingIOError, InterruptedError):
            return
        except _TLS_WANT_READ:
            return
        except _TLS_WANT_WRITE:
            # renegotiation wants the socket writable first
            self._want_write(conn, True)
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)         # peer closed (maybe mid-request)
            return
        now = time.monotonic()
        conn.t_last = now
        if conn.state == _HEAD and not conn.buf:
            conn.t_req_start = now
        conn.buf += data
        if len(conn.buf) > self.frontend.max_header_bytes + \
                self.frontend.max_body_bytes:
            # a client flooding bytes while a request is in flight (or
            # ignoring every reject) must not grow the buffer unbounded
            self._close(conn)
            return
        self._advance(conn)

    def _advance(self, conn: _Conn) -> None:
        """Drive the state machine as far as the buffered bytes allow.
        One while-iteration per complete request, so a pipelining
        client is served in order without waiting for read events: a
        synchronous reply flips the state back to ``_HEAD`` mid-loop
        and the next buffered request parses immediately. The
        ``advancing`` flag keeps that re-entry iterative — ``_deliver``
        never recurses into an ``_advance`` that is already on the
        stack (a deep pipeline burst must not grow the C stack)."""
        if conn.advancing:
            return
        conn.advancing = True
        try:
            self._advance_inner(conn)
        finally:
            conn.advancing = False

    def _advance_inner(self, conn: _Conn) -> None:
        fe = self.frontend
        served = 0
        cap = fe.max_pipelined_per_iter
        while conn.state in (_HEAD, _BODY) and not conn.out:
            if cap > 0 and served >= cap and conn.buf:
                # HTTP/1.1 pipelining fairness: one connection
                # flooding pipelined requests in a single buffer must
                # not monopolize this loop iteration — park the rest
                # of its buffer and resume next iteration, after every
                # OTHER connection's events were handled
                fe.n_pipelining_deferred += 1
                self._deferred[conn.fd] = conn
                return
            buf = conn.buf
            if conn.state == _HEAD:
                # tolerate stray CRLFs between requests (RFC 7230 3.5)
                while buf[:2] == b"\r\n":
                    del buf[:2]
                if not buf:
                    return
                # resume the terminator scan where the last one left
                # off (minus 3: the terminator may straddle the chunks)
                head_end = buf.find(_CRLF2, max(conn.scanned - 3, 0))
                if head_end < 0:
                    conn.scanned = len(buf)
                    if len(buf) > fe.max_header_bytes:
                        fe.n_parse_errors += 1
                        self._reject(conn, 431,
                                     b'{"error": "header block too '
                                     b'large"}')
                    return
                if head_end > fe.max_header_bytes:
                    # the whole oversized block landed in one recv:
                    # finding the terminator does not make it admissible
                    fe.n_parse_errors += 1
                    self._reject(conn, 431,
                                 b'{"error": "header block too '
                                 b'large"}')
                    return
                conn.scanned = 0
                try:
                    method, path, version, headers = parse_head(
                        buf, head_end)
                except ValueError:
                    fe.n_parse_errors += 1
                    self._reject(conn, 400,
                                 b'{"error": "malformed request"}')
                    return
                conn.method, conn.path, conn.headers = \
                    method, path, headers
                # keep-alive: HTTP/1.1 default-on, 1.0 default-off,
                # Connection header overrides either way
                tok = headers.get_bytes(b"connection").lower()
                if version == b"HTTP/1.0":
                    conn.keep_alive = tok == b"keep-alive"
                else:
                    conn.keep_alive = tok != b"close"
                if headers.get_bytes(b"transfer-encoding"):
                    fe.n_parse_errors += 1
                    self._reject(conn, 501,
                                 b'{"error": "chunked transfer encoding '
                                 b'not supported"}')
                    return
                raw_cl = headers.get_bytes(b"content-length", None)
                if raw_cl is None:
                    if method == b"POST" or method == b"PUT":
                        # a body-bearing method MUST declare its length:
                        # the serving wire contract is length-framed
                        fe.n_parse_errors += 1
                        self._reject(conn, 411,
                                     b'{"error": "Content-Length '
                                     b'required"}')
                        return
                    clen = 0
                else:
                    try:
                        clen = int(raw_cl)
                        if clen < 0:
                            raise ValueError
                    except ValueError:
                        fe.n_parse_errors += 1
                        self._reject(conn, 400,
                                     b'{"error": "invalid '
                                     b'Content-Length"}')
                        return
                if clen > fe.max_body_bytes:
                    fe.n_parse_errors += 1
                    self._reject(conn, 413,
                                 b'{"error": "body too large"}')
                    return
                conn.body_start = head_end + 4
                conn.body_len = clen
                conn.state = _BODY
            # _BODY: wait for the full declared length
            total = conn.body_start + conn.body_len
            if len(conn.buf) < total:
                return
            body = bytes(memoryview(conn.buf)[conn.body_start:total])
            del conn.buf[:total]
            conn.scanned = 0
            served += 1
            self._dispatch(conn, body)

    def _dispatch(self, conn: _Conn, body: bytes) -> None:
        fe = self.frontend
        conn.n_requests += 1
        fe.n_requests += 1
        if conn.n_requests > 1:
            fe.n_keepalive_reuses += 1
        conn.state = _AWAIT
        conn.t_await = time.monotonic()
        gen = conn.gen
        ka = conn.keep_alive
        loop = self

        def reply(status: int, rbody: bytes = b"",
                  ctype: str = "application/json",
                  extra: Tuple[Tuple[str, str], ...] = ()) -> None:
            head = build_head(status, len(rbody), ctype, extra,
                              close=not ka)
            loop.post_reply(conn, gen, head, rbody, not ka)

        def begin_stream(extra: Tuple[Tuple[str, str], ...] = ()):
            # upgrade this request to incremental chunked-SSE delivery
            # (token streaming). Synchronous, loop thread only — the
            # application calls it DURING handle_request, before any
            # reply; the returned handle then accepts emit()/finish()
            # from any thread. Mutually exclusive with reply().
            return loop.open_stream(conn, gen, extra)

        reply.begin_stream = begin_stream
        method = conn.method.decode("latin-1")
        try:
            handled = fe.app.handle_request(method, conn.path,
                                            conn.headers, body, reply)
        except Exception as e:  # noqa: BLE001 — app bug, not a conn bug
            logger.warning("handle_request failed for %s %s",
                           method, conn.path, exc_info=True)
            err = ('{"error": %s}'
                   % _json_str(str(e) or "internal error")).encode()
            self._deliver(conn, gen,
                          build_head(500, len(err), close=not ka),
                          err, not ka)
            return
        if not handled:
            nf = b'{"error": "not found"}'
            self._deliver(conn, gen,
                          build_head(404, len(nf), close=not ka),
                          nf, not ka)

    # -- reject / reply / write ---------------------------------------------

    def _reject(self, conn: _Conn, status: int, body: bytes) -> None:
        """Protocol-error reply: always ``Connection: close`` (the
        framing is broken; resynchronizing the stream is hopeless)."""
        conn.state = _CLOSING
        conn.gen += 1
        conn.buf.clear()
        head = build_head(status, len(body), close=True)
        self._write(conn, head, body, close_after=True)

    def _deliver(self, conn: _Conn, gen: int, head: bytes, body: bytes,
                 close_after: bool) -> None:
        """Deliver a reply IF its request is still current (generation
        match): a reply racing the timeout sweep or a closed socket is
        dropped here, never written to the wrong request."""
        if conn.fd not in self.conns or conn.gen != gen \
                or conn.state != _AWAIT:
            return
        conn.gen += 1
        conn.state = _CLOSING if close_after else _HEAD
        # the slow-loris reap clock restarts here: any bytes of the
        # NEXT request that arrived while this one was in flight must
        # be aged from this reply, not from the previous request's
        # first byte
        conn.t_req_start = time.monotonic()
        self._write(conn, head, body, close_after)
        if conn.fd in self.conns and conn.state == _HEAD \
                and not conn.out:
            conn.t_last = time.monotonic()
            self._advance(conn)       # serve pipelined follow-ups

    def _drain_replies(self) -> None:
        while True:
            try:
                item = self._replies.popleft()
            except IndexError:
                return
            if item[0] is _STREAM_TAG:
                _, conn, gen, data, end = item
                self._deliver_stream(conn, gen, data, end)
            else:
                self._deliver(*item)

    def _write(self, conn: _Conn, head: bytes, body: bytes,
               close_after: bool) -> None:
        if conn.out:
            conn.out += head
            conn.out += body
        else:
            try:
                if conn.tls:
                    # SSL sockets have no sendmsg (each write becomes
                    # one TLS record anyway): one concatenated send
                    rest = head + body if body else head
                    n = conn.sock.send(rest)
                else:
                    # the vectored single-syscall reply: status+headers
                    # and body leave in one sendmsg, no concat copy
                    n = conn.sock.sendmsg(
                        (head, body) if body else (head,))
            except (BlockingIOError, InterruptedError):
                n = 0
            except _TLS_WANT_READ + _TLS_WANT_WRITE:
                n = 0
            except OSError:
                self._close(conn)
                return
            total = len(head) + len(body)
            if n >= total:
                if close_after:
                    self._close(conn)
                return
            rest = head + body
            conn.out += rest[n:]      # rare: kernel buffer full
        self._want_write(conn, True)

    def _on_writable(self, conn: _Conn) -> None:
        if conn.state == _TLS_HS:
            self._tls_handshake(conn)
            return
        if conn.out:
            try:
                n = conn.sock.send(conn.out)
            except (BlockingIOError, InterruptedError):
                return
            except _TLS_WANT_READ + _TLS_WANT_WRITE:
                return
            except OSError:
                self._close(conn)
                return
            del conn.out[:n]
        if not conn.out:
            self._want_write(conn, False)
            if conn.state == _CLOSING:
                self._close(conn)
            elif conn.state == _HEAD:
                self._advance(conn)

    def _want_write(self, conn: _Conn, want: bool) -> None:
        if conn.want_write == want or conn.fd not in self.conns:
            return
        conn.want_write = want
        ev = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        try:
            self.sel.modify(conn.sock, ev, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _close(self, conn: _Conn) -> None:
        if self.conns.pop(conn.fd, None) is None:
            return
        self._deferred.pop(conn.fd, None)
        self.frontend._ip_release(conn.peer_ip)
        if conn.stream is not None:
            # mid-stream disconnect: flag the producer (the decode
            # scheduler polls this and cancels the request — no slot
            # or page may outlive its audience)
            conn.stream.closed = True
            conn.stream = None
        conn.gen += 1                 # outstanding replies become stale
        conn.state = _CLOSING
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- sweeps --------------------------------------------------------------

    def _sweep(self, now: float) -> None:
        fe = self.frontend
        idle = fe.idle_timeout
        rt = fe.request_timeout
        doomed: List[_Conn] = []
        timed_out: List[_Conn] = []
        stalled: List[_Conn] = []
        for conn in self.conns.values():
            if conn.state == _AWAIT:
                if rt and rt > 0 and now - conn.t_await > rt:
                    timed_out.append(conn)
                continue
            if conn.state == _STREAM:
                # a wedged producer (hung device, dead scheduler)
                # must not park streaming clients forever: no event
                # within the stuck-batch budget drops the connection
                # (the 200 head is already out — there is no 504 to
                # send; closing flags the producer via the handle)
                if rt and rt > 0 and now - conn.t_await > rt:
                    stalled.append(conn)
                continue
            if conn.state == _TLS_HS:
                # a peer parked mid-handshake (connected then silent,
                # or trickling handshake bytes) is the TLS slow-loris:
                # reaped on the handshake's age, like a mid-request
                # stall
                if idle and idle > 0 and \
                        now - conn.t_req_start > idle:
                    doomed.append(conn)
                continue
            if idle and idle > 0 and conn.state in (_HEAD, _BODY):
                if conn.buf or conn.state == _BODY:
                    # mid-request stall: the slow-loris shape — bytes
                    # dribbling in keep t_last fresh, so the reap clock
                    # is the REQUEST's age, not the socket's idleness
                    if now - conn.t_req_start > idle:
                        doomed.append(conn)
                elif now - conn.t_last > idle:
                    doomed.append(conn)
        for conn in doomed:
            fe.n_idle_reaped += 1
            self._close(conn)
        for conn in stalled:
            fe.n_request_timeouts += 1
            self._close(conn)
        for conn in timed_out:
            # same contract as the threaded frontend's Event.wait
            # expiry: 504 now, drop the late real reply by generation
            gen = conn.gen
            body = fe.request_timeout_body
            self._deliver(conn, gen,
                          build_head(504, len(body),
                                     close=not conn.keep_alive),
                          body, not conn.keep_alive)
            fe.n_request_timeouts += 1

    # -- shutdown ------------------------------------------------------------

    def _shutdown(self) -> None:
        self._close_listener()
        # deliver any replies already posted (the pipeline quiesced
        # before stop; what is queued now is all there will ever be),
        # then give pending writes a short bounded flush
        self._drain_replies()
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline and any(
                c.out for c in self.conns.values()):
            events = self.sel.select(timeout=0.05)
            for key, mask in events:
                if isinstance(key.data, _Conn) and \
                        mask & selectors.EVENT_WRITE:
                    self._on_writable(key.data)
        for conn in list(self.conns.values()):
            self._close(conn)
        try:
            self.sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


def _json_str(s: str) -> str:
    import json
    return json.dumps(s)


# ---------------------------------------------------------------------------
# The frontend
# ---------------------------------------------------------------------------

class EventLoopFrontend:
    """N accept/event loops sharing one port, speaking the
    ``handle_request`` protocol to an application (see module doc)."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0, *,
                 acceptors: int = 1, reuse_port: bool = False,
                 idle_timeout: float = 0.0,
                 request_timeout: Optional[float] = None,
                 request_timeout_body: bytes =
                 b'{"error": "inference timed out"}',
                 max_header_bytes: int = 16384,
                 max_body_bytes: int = 64 << 20,
                 backlog: int = 1024,
                 max_conns_per_ip: int = 0,
                 max_pipelined_per_iter: int = 16,
                 max_stream_buffer_bytes: int = 256 << 10,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 ssl_context=None,
                 registry=None, name: str = "serving"):
        self.app = app
        self.name = name
        # -- TLS termination (docs/serving.md "TLS at the edge"):
        # pass a ready ssl.SSLContext, or a cert/key pair to build the
        # server-default one. The handshake is a first-class state of
        # the connection machine (non-blocking, WantRead/WantWrite
        # re-registration), so the encrypted edge keeps every event-
        # loop property — keep-alive, pipelining, streaming, sweeps —
        # without a fronting proxy.
        if ssl_context is not None and (tls_cert or tls_key):
            raise ValueError("pass ssl_context OR tls_cert/tls_key, "
                             "not both")
        if tls_cert or tls_key:
            if ssl is None:
                raise ValueError("this interpreter lacks the ssl "
                                 "module; TLS termination unavailable")
            if not (tls_cert and tls_key):
                raise ValueError("TLS needs BOTH tls_cert and tls_key")
            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(tls_cert, tls_key)
        self.ssl_context = ssl_context
        self.n_tls_handshakes = 0
        self.n_tls_handshake_failures = 0
        self.idle_timeout = float(idle_timeout or 0.0)
        self.request_timeout = request_timeout
        self.request_timeout_body = request_timeout_body
        self.max_header_bytes = int(max_header_bytes)
        self.max_body_bytes = int(max_body_bytes)
        self.acceptors = max(int(acceptors), 1)
        self.backlog = max(int(backlog), 1)
        self.reuse_port = bool(reuse_port)
        # -- per-IP connection cap: a shedding layer IN FRONT of the
        # application's max_queue — beyond this many concurrent
        # connections from one peer address, further accepts get an
        # immediate 429 + close. 0 disables. Tracked frontend-wide
        # (one peer's connections spread across every acceptor loop).
        self.max_conns_per_ip = int(max_conns_per_ip)
        self._ip_lock = threading.Lock()
        self._conns_per_ip: Dict[str, int] = {}
        self.per_ip_high_water = 0
        self.n_per_ip_rejected = 0
        self.n_per_ip_underflow = 0
        # -- HTTP/1.1 pipelining fairness: at most this many buffered
        # requests served per connection per _advance pass; the rest
        # are deferred to the next loop iteration so one flooding
        # pipelined connection cannot monopolize a loop. <= 0 disables.
        self.max_pipelined_per_iter = int(max_pipelined_per_iter)
        self.n_pipelining_deferred = 0
        # -- token streaming: a streamed response may only buffer this
        # many unwritten bytes per connection (slow consumer) before
        # the frontend drops the connection and flags the producer
        self.max_stream_buffer_bytes = int(max_stream_buffer_bytes)
        self.n_streams = 0
        self.n_stream_events = 0
        self.n_stream_overflows = 0
        if self.acceptors > 1 and not self.reuse_port:
            # N loops cannot share ONE listening socket without the
            # thundering-herd accept races SO_REUSEPORT exists to fix
            raise ValueError("acceptors > 1 requires reuse_port=True")
        # frontend counters: plain ints bumped from loop threads (int
        # += is tear-free under the GIL; exactness beyond that is not
        # worth a lock on the accept path), exposed via set_function
        # views exactly like the server's own counters
        self.n_connections = 0
        self.n_requests = 0
        self.n_keepalive_reuses = 0
        self.n_idle_reaped = 0
        self.n_parse_errors = 0
        self.n_request_timeouts = 0
        # batched reply flushing (the commit path's batched_replies
        # scope): flushes = one-wake loop passes, batched = replies
        # they carried (batched/flushes = coalescing factor)
        self.n_reply_flushes = 0
        self.n_batched_replies = 0
        self._listeners: List[socket.socket] = []
        first = self._bind(host, port)
        self.host, self.port = first.getsockname()[:2]
        self._listeners.append(first)
        for _ in range(self.acceptors - 1):
            self._listeners.append(self._bind(self.host, self.port))
        self._loops = [_Loop(self, i, lst)
                       for i, lst in enumerate(self._listeners)]
        if registry is not None:
            self._register_metrics(registry)

    # -- per-IP accounting (accept path; lock-guarded, accepts are
    # orders of magnitude rarer than requests) ------------------------------

    def _ip_acquire(self, ip: str) -> bool:
        """Admit a new connection from ``ip``; False = over the cap."""
        if self.max_conns_per_ip <= 0 or not ip:
            return True
        with self._ip_lock:
            n = self._conns_per_ip.get(ip, 0)
            if n >= self.max_conns_per_ip:
                return False
            self._conns_per_ip[ip] = n + 1
            if n + 1 > self.per_ip_high_water:
                self.per_ip_high_water = n + 1
            return True

    def _ip_release(self, ip: str) -> None:
        if self.max_conns_per_ip <= 0 or not ip:
            return
        with self._ip_lock:
            n = self._conns_per_ip.get(ip, 0) - 1
            if n < 0:
                # a release with no matching acquire: clamped, counted
                # — the leak-check test asserts this stays 0 (every
                # teardown path funnels through _Loop._close exactly
                # once; its conns-dict pop guards the double call)
                self.n_per_ip_underflow += 1
            elif n == 0:
                self._conns_per_ip.pop(ip, None)
            else:
                self._conns_per_ip[ip] = n

    def _bind(self, host: str, port: int) -> socket.socket:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if self.reuse_port:
                if not hasattr(socket, "SO_REUSEPORT"):
                    raise OSError(
                        errno.ENOPROTOOPT,
                        "SO_REUSEPORT unavailable on this platform")
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind((host, port))
            s.listen(self.backlog)
            s.setblocking(False)
        except BaseException:
            s.close()
            raise
        return s

    def _register_metrics(self, registry) -> None:
        registry.gauge(
            "serving_open_connections",
            "Sockets currently registered with the frontend loops "
            "(keep-alive connections park here between requests)."
        ).set_function(lambda: sum(len(lp.conns) for lp in self._loops))
        registry.gauge(
            "serving_accept_loop_busy_ratio",
            "Fraction of wall time the busiest accept loop spent "
            "processing events (1.0 = the socket edge is saturated; "
            "add SO_REUSEPORT acceptors)."
        ).set_function(
            lambda: max((lp.busy_ratio for lp in self._loops),
                        default=0.0))
        for mname, help_, attr in (
            ("serving_connections_total",
             "Connections accepted by the event-loop frontend.",
             "n_connections"),
            ("serving_frontend_requests_total",
             "Requests framed by the event-loop frontend (all routes).",
             "n_requests"),
            ("serving_keepalive_reuses_total",
             "Requests served on an already-used connection (reuse "
             "rate = reuses / frontend requests).", "n_keepalive_reuses"),
            ("serving_idle_reaped_total",
             "Connections closed by the idle/slow-loris sweep.",
             "n_idle_reaped"),
            ("serving_parse_errors_total",
             "Requests rejected at the framing layer (400/411/413/"
             "431/501).", "n_parse_errors"),
            ("serving_request_timeouts_total",
             "In-flight requests 504ed by the request-timeout sweep.",
             "n_request_timeouts"),
            ("serving_pipelining_deferred_total",
             "Times a connection's buffered pipelined requests were "
             "deferred to the next loop iteration by the fairness cap "
             "(max_pipelined_per_iter).", "n_pipelining_deferred"),
            ("serving_per_ip_rejected_total",
             "Connections refused at accept by the per-IP cap "
             "(429 + close before any queue slot was spent).",
             "n_per_ip_rejected"),
            ("serving_reply_flush_batches_total",
             "Batched reply flushes (one deque extend + one wake per "
             "loop per commit batch).", "n_reply_flushes"),
            ("serving_batched_replies_total",
             "Replies delivered through batched flushes (ratio to "
             "flush batches = coalescing factor).",
             "n_batched_replies"),
            ("serving_streams_total",
             "Requests upgraded to incremental chunked-SSE delivery "
             "(token streaming).", "n_streams"),
            ("serving_stream_events_total",
             "SSE events written to streamed responses (terminal "
             "events included).", "n_stream_events"),
            ("serving_stream_overflows_total",
             "Streamed connections dropped because the bounded "
             "per-connection write buffer overflowed (slow consumer).",
             "n_stream_overflows"),
            ("serving_tls_handshakes_total",
             "TLS handshakes completed by the event-loop edge "
             "(connections that reached the HTTP state).",
             "n_tls_handshakes"),
            ("serving_tls_handshake_failures_total",
             "TLS handshakes that failed (plaintext bytes on the TLS "
             "port, protocol mismatch, mid-handshake disconnect) — "
             "each closed cleanly.", "n_tls_handshake_failures"),
        ):
            registry.counter(mname, help_).set_function(
                lambda a=attr: getattr(self, a))
        registry.gauge(
            "serving_per_ip_conns_high_water",
            "Highest concurrent-connection count any single peer "
            "address has reached (0 when the per-IP cap is off)."
        ).set_function(lambda: self.per_ip_high_water)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "EventLoopFrontend":
        # idempotent: ServingServer.start() may run twice (helper +
        # context-manager __enter__ is a common test shape) and the
        # loops are long-lived Thread objects, not per-call ones
        for lp in self._loops:
            if not lp._started.is_set():
                lp.start()
        return self

    def pause_accept(self) -> None:
        """Stop accepting new connections; established connections keep
        being served. Part of graceful drain: readiness flips first,
        then the listeners go away, then in-flight work finishes."""
        for lp in self._loops:
            lp.pause_accept()

    def stop(self) -> None:
        """Stop the loops. Call only after the application has quiesced
        (every ``reply`` that will ever fire has fired): each loop
        delivers already-posted replies, briefly flushes pending
        writes, then closes everything."""
        for lp in self._loops:
            lp.request_stop()
        for lp in self._loops:
            if lp.is_alive():
                lp.join(timeout=5)
        for lst in self._listeners:
            try:
                lst.close()
            except OSError:
                pass

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        reqs = self.n_requests
        return {
            "kind": "eventloop",
            "acceptors": self.acceptors,
            "reuse_port": self.reuse_port,
            "tls": self.ssl_context is not None,
            "tls_handshakes_total": self.n_tls_handshakes,
            "tls_handshake_failures_total":
                self.n_tls_handshake_failures,
            "open_connections": sum(len(lp.conns) for lp in self._loops),
            "connections_total": self.n_connections,
            "requests_total": reqs,
            "keepalive_reuses_total": self.n_keepalive_reuses,
            "keepalive_reuse_rate": round(
                self.n_keepalive_reuses / reqs, 4) if reqs else 0.0,
            "idle_reaped_total": self.n_idle_reaped,
            "parse_errors_total": self.n_parse_errors,
            "request_timeouts_total": self.n_request_timeouts,
            "pipelining_deferred_total": self.n_pipelining_deferred,
            "per_ip_rejected_total": self.n_per_ip_rejected,
            "per_ip_conns_high_water": self.per_ip_high_water,
            # live per-IP ledger: tracked addresses and release-
            # without-acquire underflows — the leak-check test's
            # public surface (0 tracked and 0 underflows at idle)
            "per_ip_tracked": len(self._conns_per_ip),
            "per_ip_underflow_total": self.n_per_ip_underflow,
            "reply_flush_batches_total": self.n_reply_flushes,
            "batched_replies_total": self.n_batched_replies,
            "streams_total": self.n_streams,
            "stream_events_total": self.n_stream_events,
            "stream_overflows_total": self.n_stream_overflows,
            "busy_ratio": round(max(
                (lp.busy_ratio for lp in self._loops), default=0.0), 4),
        }
