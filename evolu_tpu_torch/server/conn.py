"""Event-loop connection tier: idle connections cost file descriptors,
not threads.

The port's copy of `evolu_tpu.server.conn`. The threaded tier
(`ThreadingHTTPServer`) pins one thread a connection for the connection's
whole life: fine for request/response traffic, fatal for push, where
10^4 parked long-polls would be 10^4 parked threads. This tier inverts
the ownership: ONE loop thread (`selectors`) owns every socket and does
the non-blocking accept, incremental read, HTTP framing and response
write, and only a COMPLETE request ever occupies a thread: it is
dispatched to a bounded handler pool that drives the UNCHANGED relay
`_Handler` over an in-memory socket. Byte-identity with the threaded
tier is therefore by construction: the same handler code runs the same
serve paths (scheduler admission, fleet routing, replication, capability
negotiation) and produces the same bytes. Push long-polls (`GET
/push/poll`, server/push.py) never reach the pool: the loop parks the
bare connection in the hub and writes the response when a mutation wakes
it.

Admission layering (all bounded, all flow control, never an error):
  connections   → file descriptors
  dispatches    → `max_pending` in-flight pool jobs; past it the loop
                  answers 503 + Retry-After itself, without a thread
  engine work   → the scheduler's own bounded queue, unchanged
  subscriptions → the hub's `max_subscriptions`

Slow-client hardening: a request must arrive COMPLETELY within
`read_timeout_s` of its first byte (an absolute budget: a sliding one is
what slowloris exploits), headers are capped at `max_header_bytes` (431
past it), bodies at the relay's MAX_BODY_BYTES (the handler's own 413
answers an oversized declaration without the tier buffering it), and a
response write that stops progressing for `write_timeout_s` closes the
connection. Every one of these is enforced from the loop.

Observability as the reference's: the `evolu_conn_*` families (accepted,
shed and closed connections, the open and dispatch-pending gauges),
`evolu_relay_requests_total` for the polls the loop parks itself,
`evolu_push_redirects_total` for its fleet redirects, and log lines for a
handler escape or a failed dispatch. Plain `counts` (accepted, shed,
closed by reason) are kept beside them; `stats_payload` answers the
reference's keys from them.
"""

from __future__ import annotations

import io
import selectors
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Tuple

from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.utils.log import log

# Defaults; RelayServer threads the Config knobs through.
MAX_HEADER_BYTES = 16384
READ_TIMEOUT_S = 30.0
WRITE_TIMEOUT_S = 30.0
HANDLER_THREADS = 8
MAX_PENDING = 512

_RECV_CHUNK = 65536

# The reasons a closed connection is counted under, in `stats_payload` order.
CLOSE_REASONS = ("done", "hup", "read_timeout", "write_timeout", "header_overflow", "error", "shutdown")


# -- driving the existing handler over an in-memory socket --


class _BufferedSocket:
    """Just enough socket surface for BaseHTTPRequestHandler: rfile comes
    from `makefile("rb")` over the buffered request bytes, wfile is
    socketserver's _SocketWriter calling `sendall`, captured here."""

    __slots__ = ("_data", "out")

    def __init__(self, data: bytes):
        self._data = data
        self.out = bytearray()

    def makefile(self, mode: str, *a, **k):
        assert "r" in mode
        return io.BytesIO(self._data)

    def sendall(self, b) -> None:
        self.out += b

    def settimeout(self, *_a) -> None:
        pass

    def setsockopt(self, *_a) -> None:
        pass


class _ServerShim:
    """The `server` argument handler construction wants; nothing in the
    BaseHTTPRequestHandler paths driven here reads it."""

    __slots__ = ()


_SERVER_SHIM = _ServerShim()


def serve_buffered(handler_cls, raw: bytes, client_address: Tuple[str, int]) -> bytes:
    """Run one fully buffered HTTP request through the relay's real
    handler class → the raw response bytes (status line + headers + body,
    exactly what the threaded tier would put on the wire). An escape from
    the handler (it answers its own 500s; this is the socketserver
    handle_error analog) counts as a relay error and degrades to a bare
    500 if nothing was written yet."""
    fake = _BufferedSocket(raw)
    try:
        handler_cls(fake, client_address, _SERVER_SHIM)
    except Exception as e:  # noqa: BLE001
        log("dev", "conn tier handler escape", error=repr(e))
        counts = getattr(handler_cls, "counts", None)
        if counts is not None:
            counts.error()  # counts evolu_relay_errors_total too
        else:
            metrics.inc("evolu_relay_errors_total")
        if not fake.out:
            body = b"handler failure"
            fake.out += (
                b"HTTP/1.0 500 Internal Server Error\r\n"
                b"Content-Type: text/plain\r\nContent-Length: "
                + str(len(body)).encode() + b"\r\n\r\n" + body
            )
    return bytes(fake.out)


# -- in-loop response framing (push fast paths) --
# Mirrors BaseHTTPRequestHandler's send_response framing (status line,
# Server, Date, then per-call headers) so the two tiers stay
# byte-identical on the endpoints the loop answers itself.


def _date_header() -> str:
    return BaseHTTPRequestHandler.date_time_string(None)  # type: ignore[arg-type]


_SERVER_HEADER = BaseHTTPRequestHandler.server_version + " " + BaseHTTPRequestHandler.sys_version


def frame_response(code: int, headers: List[Tuple[str, str]], body: bytes = b"") -> bytes:
    from http import HTTPStatus

    try:
        phrase = HTTPStatus(code).phrase
    except ValueError:
        phrase = ""
    lines = [f"HTTP/1.0 {code} {phrase}", f"Server: {_SERVER_HEADER}", f"Date: {_date_header()}"]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


# -- per-connection state --

_READ, _DISPATCHED, _PARKED, _WRITE = range(4)


class _Conn:
    __slots__ = ("sock", "addr", "buf", "header_end", "content_length",
                 "state", "deadline", "outbuf", "outpos", "scan_from",
                 "postreq")

    def __init__(self, sock, addr, now: float, read_timeout: float):
        self.sock = sock
        self.addr = addr
        self.buf = bytearray()
        self.header_end = -1
        self.content_length = 0
        self.state = _READ
        # ABSOLUTE request deadline, never slid on progress, so a
        # byte-per-second trickle cannot hold a slot past the budget.
        self.deadline = now + read_timeout
        self.outbuf: Optional[memoryview] = None
        self.outpos = 0
        self.scan_from = 0
        self.postreq = 0  # bytes tolerated after a complete request


class EventLoopHTTPServer:
    """Drop-in for `_RelayHTTPServer` in `RelayServer`: the same
    `server_address` / `serve_forever` / `shutdown` / `server_close`
    lifecycle, event-loop internals. `handler_cls` is the relay's bound
    handler class; its `push_hub` / `fleet` class attributes are read per
    request, so `enable_fleet()` after construction works as on the
    threaded tier.

    `counts`: `accepted`, `shed` (503s of the dispatch bound) and
    `closed`, a dict by reason (`CLOSE_REASONS`)."""

    def __init__(self, server_address, handler_cls, *,
                 push_hub=None,
                 handler_threads: int = HANDLER_THREADS,
                 max_pending: int = MAX_PENDING,
                 read_timeout_s: float = READ_TIMEOUT_S,
                 write_timeout_s: float = WRITE_TIMEOUT_S,
                 max_header_bytes: int = MAX_HEADER_BYTES):
        self.handler_cls = handler_cls
        self.push_hub = push_hub
        self.handler_threads = int(handler_threads)
        self.max_pending = int(max_pending)
        self.read_timeout_s = float(read_timeout_s)
        self.write_timeout_s = float(write_timeout_s)
        self.max_header_bytes = int(max_header_bytes)
        self.counts = {"accepted": 0, "shed": 0, "closed": dict.fromkeys(CLOSE_REASONS, 0)}

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._lsock.bind(server_address)
            self._lsock.listen(1024)
        except BaseException:
            self._lsock.close()
            raise
        self._lsock.setblocking(False)
        self.server_address = self._lsock.getsockname()

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, "accept")
        # Cross-thread wakeups (pool completions, hub wakeups, shutdown):
        # a socketpair the selector always watches.
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._sel.register(self._waker_r, selectors.EVENT_READ, "waker")

        self._pool = None  # lazy: no threads until the first dispatch
        self._pool_lock = threading.Lock()
        self._conns: Dict[socket.socket, _Conn] = {}
        # Connections with a LIVE deadline (READ/WRITE states). Parked and
        # dispatched connections leave this set, so the per-tick timeout
        # and sweep scans cost O(active requests), not O(open
        # connections).
        self._active: set = set()
        self._done: deque = deque()  # (conn, response_bytes)
        self._done_lock = threading.Lock()
        self._inflight = 0
        self._stopping = threading.Event()
        self._stopped = threading.Event()
        if push_hub is not None:
            push_hub.on_wake = self._on_hub_wake

    # -- lifecycle (socketserver-compatible surface) --

    def serve_forever(self) -> None:
        try:
            while not self._stopping.is_set():
                self._tick()
        finally:
            self._teardown()
            self._stopped.set()

    def shutdown(self) -> None:
        self._stopping.set()
        self._wake()
        self._stopped.wait(timeout=10.0)

    def server_close(self) -> None:
        # serve_forever's teardown closed the sockets; this mops up a
        # never-started server.
        if not self._stopped.is_set():
            self._teardown()

    def _teardown(self) -> None:
        # Flush responses already queued (hub.close() ran just before
        # shutdown and resolved every parked poll) with a short bounded
        # grace, then close everything.
        deadline = time.monotonic() + 1.0
        self._drain_done()
        while time.monotonic() < deadline and any(c.state == _WRITE for c in self._conns.values()):
            for c in [c for c in self._conns.values() if c.state == _WRITE]:
                self._try_write(c)
            time.sleep(0.01)
        for conn in list(self._conns.values()):
            self._close(conn, reason="shutdown", quiet=True)
        for s in (self._lsock, self._waker_r, self._waker_w):
            try:
                s.close()
            except OSError:
                pass
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        try:
            self._sel.close()
        except Exception:  # noqa: BLE001,S110 - already closed
            pass

    # -- the loop --

    def _tick(self) -> None:
        timeout = self._next_timeout()
        for key, _mask in self._sel.select(timeout):
            if key.data == "accept":
                self._accept()
            elif key.data == "waker":
                try:
                    while self._waker_r.recv(4096):
                        pass
                except OSError:
                    pass
            else:
                conn: _Conn = key.data
                if conn.state == _WRITE:
                    self._try_write(conn)
                else:
                    self._on_readable(conn)
        self._drain_done()
        self._sweep_deadlines()
        if self.push_hub is not None:
            self.push_hub.expire_due()
            self._drain_done()

    def _next_timeout(self) -> float:
        now = time.monotonic()
        nxt = now + 0.5
        for c in self._active:
            if c.deadline < nxt:
                nxt = c.deadline
        if self.push_hub is not None:
            hd = self.push_hub.next_deadline()
            if hd is not None and hd < nxt:
                nxt = hd
        return max(0.0, nxt - now)

    def _wake(self) -> None:
        try:
            self._waker_w.send(b"\0")
        except OSError:
            pass

    # -- accept / read / parse --

    def _accept(self) -> None:
        for _ in range(64):  # bounded burst a tick
            try:
                sock, addr = self._lsock.accept()
            except OSError:
                return
            sock.setblocking(False)
            conn = _Conn(sock, addr, time.monotonic(), self.read_timeout_s)
            self._conns[sock] = conn
            self._active.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)
            self.counts["accepted"] += 1
            metrics.inc("evolu_conn_accepted_total")
            metrics.set_gauge("evolu_conn_open", len(self._conns))

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn, reason="error")
            return
        if not data:
            self._close(conn, reason="hup")
            return
        if conn.state != _READ:
            # Bytes past a complete request are DISCARDED, never buffered
            # (the header cap and read deadline do not apply past _READ).
            # Both tiers speak HTTP/1.0 close-after-response, so tolerate a
            # bounded trickle (a declared body the handler won't read) and
            # close past it.
            conn.postreq += len(data)
            if conn.postreq > 65536:
                self._close(conn, reason="error")
            return
        conn.buf += data
        self._advance_parse(conn)

    def _advance_parse(self, conn: _Conn) -> None:
        if conn.state != _READ:
            return
        if conn.header_end < 0:
            idx = conn.buf.find(b"\r\n\r\n", conn.scan_from)
            if idx < 0:
                conn.scan_from = max(0, len(conn.buf) - 3)
                if len(conn.buf) > self.max_header_bytes:
                    self._respond_inline(conn, frame_response(431, [("Content-Length", "0")]),
                                         counted="header_overflow")
                return
            if idx + 4 > self.max_header_bytes:
                # The budget applies to COMPLETE header sections too:
                # arrival in one segment must not bypass the cap.
                self._respond_inline(conn, frame_response(431, [("Content-Length", "0")]),
                                     counted="header_overflow")
                return
            conn.header_end = idx + 4
            conn.content_length = self._parse_content_length(bytes(conn.buf[:idx]))
            # Push polls are GETs with no body semantics: intercept on the
            # headers alone, BEFORE any body-size decision, so a poll with
            # an absurd Content-Length never parks a pool thread.
            if self._maybe_push(conn, bytes(conn.buf[:conn.header_end])):
                return
            from evolu_tpu_torch.server.relay import MAX_BODY_BYTES

            if conn.content_length > MAX_BODY_BYTES:
                # Dispatch headers-only NOW: the handler's own length check
                # answers 413 without reading the body.
                self._dispatch(conn, bytes(conn.buf[:conn.header_end]))
                return
        total = conn.header_end + conn.content_length
        if len(conn.buf) < total:
            return
        self._dispatch(conn, bytes(conn.buf[:total]))

    @staticmethod
    def _parse_content_length(header_blob: bytes) -> int:
        """Best-effort Content-Length for FRAMING only (how many body
        bytes to buffer before dispatch). The handler re-parses headers
        itself and owns the 400-on-malformed answer: an unparsable value
        frames as 0 so the request dispatches at once."""
        for line in header_blob.split(b"\r\n")[1:]:
            if line[:15].lower() == b"content-length:":
                try:
                    n = int(line[15:].strip())
                except ValueError:
                    return 0
                return n if n >= 0 else 0
        return 0

    # -- dispatch to the bounded handler pool --

    def _ensure_pool(self):
        with self._pool_lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.handler_threads,
                                                thread_name_prefix="evolu-conn-handler")
            return self._pool

    def _dispatch(self, conn: _Conn, raw: bytes) -> None:
        if self._inflight >= self.max_pending:
            # The loop's own admission bound: shedding here keeps a request
            # flood from buffering without bound ahead of the pool.
            self.counts["shed"] += 1
            metrics.inc("evolu_conn_shed_total")
            self._respond_inline(conn, frame_response(503, [("Retry-After", "1"), ("Content-Length", "0")]))
            return
        conn.state = _DISPATCHED
        conn.buf = bytearray()  # the raw copy owns the bytes now
        self._active.discard(conn)
        self._sel.unregister(conn.sock)
        self._inflight += 1
        metrics.set_gauge("evolu_conn_dispatch_pending", self._inflight)
        handler_cls, addr = self.handler_cls, conn.addr

        def job():
            try:
                out = serve_buffered(handler_cls, raw, addr)
            except BaseException as e:  # noqa: BLE001 - never lose a connection
                log("dev", "conn dispatch failed", error=repr(e))
                out = frame_response(500, [("Content-Length", "0")])
            with self._done_lock:
                self._done.append((conn, out))
            self._wake()

        self._ensure_pool().submit(job)

    def _drain_done(self) -> None:
        while True:
            with self._done_lock:
                if not self._done:
                    return
                conn, out = self._done.popleft()
            if conn.sock not in self._conns:
                continue  # closed while handling (client hangup)
            if conn.state == _DISPATCHED:
                self._inflight -= 1
                metrics.set_gauge("evolu_conn_dispatch_pending", self._inflight)
                self._sel.register(conn.sock, selectors.EVENT_WRITE, conn)
            elif conn.state == _PARKED:
                self._sel.modify(conn.sock, selectors.EVENT_WRITE, conn)
            else:
                continue
            conn.state = _WRITE
            conn.outbuf = memoryview(out)
            conn.outpos = 0
            conn.deadline = time.monotonic() + self.write_timeout_s
            self._active.add(conn)
            self._try_write(conn)

    # -- push long-polls, handled in-loop --

    def _maybe_push(self, conn: _Conn, raw: bytes) -> bool:
        """Park a `GET /push/poll` without a thread. True when this
        request was fully handled (or parked) here. What the loop can't
        answer on its own terms (a malformed query → 400, no hub → 404)
        falls through to the pool, where the threaded tier's own handler
        code answers it byte-identically."""
        line_end = raw.find(b"\r\n")
        parts = raw[:line_end].split(b" ")
        if len(parts) != 3 or parts[0] != b"GET":
            return False
        target = parts[1].decode("latin-1")
        if not target.startswith("/push/poll"):
            return False
        hub = self.push_hub
        if hub is None:
            return False  # pool → handler → 404
        from urllib.parse import urlsplit

        from evolu_tpu_torch.server import push as push_mod

        try:
            owner, node, cursor, timeout, tags = push_mod.parse_poll_query(urlsplit(target).query)
        except ValueError:
            return False  # pool → handler → 400, byte-identical
        metrics.inc("evolu_relay_requests_total", endpoint="/push/poll")
        fleet = getattr(self.handler_cls, "fleet", None)
        if fleet is not None:
            resp = _push_fleet_route(fleet, owner, target, hub)
            if resp is not None:
                self._respond_inline(conn, resp)
                return True
        try:
            kind, val = hub.park(owner, node, cursor, timeout, token=conn, tags=tags)
        except push_mod.HubFull as e:
            # _fmt_retry, not str(): the threaded tier formats through
            # scheduler.format_retry_after ("1", not "1.0").
            self._respond_inline(conn, frame_response(
                503, [("Retry-After", _fmt_retry(e.retry_after)), ("Content-Length", "0")]))
            return True
        if kind == "now":
            self._respond_inline(conn, _frame_poll(val))
            return True
        conn.state = _PARKED
        conn.buf = bytearray()
        self._active.discard(conn)  # the hub owns the park deadline
        # Stay registered for EVENT_READ: a parked client hanging up
        # (recv → b"") must free the subscription at once.
        return True

    def _on_hub_wake(self, token, body: bytes) -> None:
        """Installed as PushHub.on_wake: called from ANY thread with a
        parked connection's response."""
        with self._done_lock:
            self._done.append((token, _frame_poll(body)))
        self._wake()

    # -- write / close / sweep --

    def _respond_inline(self, conn: _Conn, out: bytes, counted: Optional[str] = None) -> None:
        if counted:
            self.counts["closed"][counted] += 1
            metrics.inc("evolu_conn_closed_total", reason=counted)
        conn.state = _WRITE
        conn.outbuf = memoryview(out)
        conn.outpos = 0
        conn.deadline = time.monotonic() + self.write_timeout_s
        self._active.add(conn)
        self._sel.modify(conn.sock, selectors.EVENT_WRITE, conn)
        self._try_write(conn)

    def _try_write(self, conn: _Conn) -> None:
        try:
            while conn.outpos < len(conn.outbuf):
                n = conn.sock.send(conn.outbuf[conn.outpos:])
                if n == 0:
                    break
                conn.outpos += n
                conn.deadline = time.monotonic() + self.write_timeout_s
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn, reason="hup")
            return
        if conn.outpos >= len(conn.outbuf):
            self._close(conn, reason="done")

    def _close(self, conn: _Conn, reason: str, quiet: bool = False) -> None:
        if conn.sock not in self._conns:
            return
        if conn.state == _PARKED and self.push_hub is not None:
            self.push_hub.cancel(conn)
        del self._conns[conn.sock]
        self._active.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if not quiet:
            self.counts["closed"][reason] += 1
            metrics.inc("evolu_conn_closed_total", reason=reason)
            metrics.set_gauge("evolu_conn_open", len(self._conns))

    def _sweep_deadlines(self) -> None:
        now = time.monotonic()
        overdue = [c for c in self._active if c.deadline <= now]
        for conn in overdue:
            self._close(conn, reason=("read_timeout" if conn.state == _READ else "write_timeout"))

    # -- observability --

    def stats_payload(self) -> dict:
        """The `/stats` `conn` section, with the reference's keys."""
        return {
            "tier": "eventloop",
            "open_connections": len(self._conns),
            "dispatch_pending": self._inflight,
            "handler_threads": self.handler_threads,
            "accepted_total": self.counts["accepted"],
            "shed_total": self.counts["shed"],
            "closed_total": dict(self.counts["closed"]),
        }


def _frame_poll(body: bytes) -> bytes:
    return frame_response(200, [("Content-Type", "application/json"),
                                ("Content-Length", str(len(body)))], body)


def _push_fleet_route(fleet, owner: str, target: str, hub=None) -> Optional[bytes]:
    """Fleet placement for a push poll: a subscription lives at the
    owner's PLACED relay (where that owner's mutations are served and
    hub-notified). Non-placed polls are 307'd to it, in forward mode too:
    proxying a long-poll would pin a poller on the hop for the park's
    whole duration. `hub` counts the redirect. None → placed locally,
    park here."""
    from evolu_tpu_torch.server.fleet import FleetNotReady

    try:
        action, peer = fleet.route(owner)
    except FleetNotReady as e:
        return frame_response(503, [("Retry-After", _fmt_retry(e.retry_after)), ("Content-Length", "0")])
    if action == "local":
        return None
    if hub is not None:
        hub._count("redirects")
    metrics.inc("evolu_push_redirects_total")
    return frame_response(307, [("Location", peer + target), ("Content-Length", "0")])


def _fmt_retry(seconds: float) -> str:
    from evolu_tpu_torch.server.scheduler import format_retry_after

    return format_retry_after(seconds)
