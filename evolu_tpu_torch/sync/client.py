"""The sync transport — SyncWorker analog.

The port's copy of `evolu_tpu.sync.client`. Reference:
packages/evolu/src/sync.worker.ts. One input shape (a sync request
carrying optional fresh messages + the clock), one pipeline
(sync.worker.ts:177-229): encrypt each message's content → protobuf
SyncRequest → HTTP POST octet-stream → parse SyncResponse → decrypt →
hand the result back to the DbWorker as a Receive command.

As in the reference, each leg takes the fused C layer first
(`sync.native_crypto`, built at first use) and the pure per-message
loops behind it: a push body is one native call, and a response decodes
in one call into a columnar `PackedReceive` that the worker applies
without per-row objects. Any shape the native layer declines re-runs on
the pure path, which owns the exact error surface.

Network failure is swallowed by design — offline is a normal state,
recovery is the next sync trigger (sync.worker.ts:217-227). Every
round runs under the per-database sync lock, making sync mutually
exclusive across clients of the same database (syncLock.ts:8-12).

Observability as the reference's: the transport records the
`evolu_sync_*` request, response, redirect, route, error and offline
metrics and its crypto and scope counters, traces each round as a
`sync.round` span (joining the mutation's trace) and sends its context as
the POST's traceparent header; the `PushSubscriber` records
`evolu_push_client_*`. Both keep plain `counts` beside them.

Under `Config.sync_scope` (`sync/scope.py`) a round carries the scope
clause (SyncRequest field 6), with a lane tag for each pushed message,
once the relay it posts to has echoed `sync-scope-v1`; a failover target
that did not is sent the round again without it, and the push
subscription carries the scope's lane tags.

Under `Config.push_subscribe`, `connect` attaches a `PushSubscriber`: a
thread that long-polls the relay's `GET /push/poll` (server/push.py) for
the owner and fires a sync round when the relay reports foreign-authored
rows. It binds from the first successful round, which learns the owner,
the clock's node id and the relay that actually served.
"""

from __future__ import annotations

import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional, Tuple

from evolu_tpu_torch.core.timestamp import timestamp_from_string
from evolu_tpu_torch.core.types import CrdtMessage, UnknownError
from evolu_tpu_torch.obs import metrics, trace
from evolu_tpu_torch.runtime.messages import OnError, SyncRequestInput
from evolu_tpu_torch.runtime.synclock import SyncLock
from evolu_tpu_torch.sync import aead, native_crypto, protocol
from evolu_tpu_torch.sync.crypto import encrypt_symmetric
from evolu_tpu_torch.utils.config import Config
from evolu_tpu_torch.utils.log import log


def encrypt_messages(messages, mnemonic: str):
    """sync.worker.ts:50-91 — per-message protobuf-encode + encrypt;
    the timestamp stays plaintext (the relay orders and diffs by it).
    The transport always encodes with extensions allowed: the wire gate
    (incl. strict interop, Config.wire_extensions=False) is enforced at
    MUTATION time (worker._send), so anything in the log is either
    authored encodable or arrived from a remote peer — and a relay must
    forward remote messages verbatim, never refuse them (refusing here
    would wedge anti-entropy resends forever).

    The batched C++ path handles canonical values; None from it means
    some value needs the pure loop's error surface, so it re-runs here."""
    if messages:
        native = native_crypto.encrypt_batch(messages, mnemonic)
        if native is not None:
            return native
    return encrypt_messages_pure(messages, mnemonic)


def encrypt_messages_pure(messages, mnemonic: str):
    """The pure per-message OpenPGP loop behind `encrypt_messages`."""
    out = []
    for m in messages:
        content = protocol.encode_content(m.table, m.row, m.column, m.value)
        out.append(
            protocol.EncryptedCrdtMessage(m.timestamp, encrypt_symmetric(content, mnemonic))
        )
    return tuple(out)


def encrypt_messages_v2(messages, mnemonic: str):
    """The aead-batch-v1 twin of `encrypt_messages` (sync/aead.py):
    session-keyed GCM records instead of per-message OpenPGP S2K. Only
    the NEGOTIATED push path calls this; it raises exactly what the v1
    loop raises for unencodable values (encode_content owns the
    TypeError surface in both)."""
    session = aead.get_session(mnemonic, records=len(messages))
    out = []
    for m in messages:
        content = protocol.encode_content(m.table, m.row, m.column, m.value)
        out.append(
            protocol.EncryptedCrdtMessage(
                m.timestamp, aead.encrypt_record(session.key, session.salt, content)
            )
        )
    return tuple(out)


def _decrypt_one(m, password: str) -> CrdtMessage:
    # decrypt_content dispatches v1 OpenPGP vs aead-batch-v1 records by
    # the self-describing magic — both are read unconditionally
    # (negotiation gates emission, never decoding).
    table, row, column, value = protocol.decode_content(
        aead.decrypt_content(m.content, password)
    )
    return CrdtMessage(m.timestamp, table, row, column, value)


def decrypt_messages(messages, mnemonic: str):
    """sync.worker.ts:135-173. Canonical rows decrypt on the batched C++
    path; every other row, and the whole batch when the library is
    unavailable, re-runs through the pure oracle at its original
    position (the same errors, first failure first)."""
    return native_crypto.decrypt_batch(messages, mnemonic)


def decrypt_messages_pure(messages, mnemonic: str):
    """The pure loop, message by message in order, so the first failing
    message raises (PgpError for the ciphertext, ValueError for the
    content's wire)."""
    return tuple(_decrypt_one(m, mnemonic) for m in messages)


class SyncTransport:
    """Owns a transport thread; `request_sync` enqueues a round.

    `on_receive(messages, merkle_tree, previous_diff)` is called with
    the decrypted response — typically `Evolu.receive`, closing the
    anti-entropy loop (SURVEY.md §3.3).

    `counts` tallies what the reference sends to its metrics registry:
    requests, responses and their messages and bytes, v2 push legs,
    v1 fallbacks by reason, scope-clause downgrades on failover,
    redirects, route and capability invalidations, HTTP errors and
    offline rounds.
    """

    def __init__(
        self,
        config: Config,
        on_receive: Callable[[tuple, str, Optional[int]], None],
        sync_lock: Optional[SyncLock] = None,
        on_error: Optional[Callable[[Exception], None]] = None,
        http_post: Optional[Callable[[str, bytes], bytes]] = None,
        http_probe: Optional[Callable[[str], None]] = None,
        on_reconnect: Optional[Callable[[], None]] = None,
    ):
        self.config = config
        self.on_receive = on_receive
        self.sync_lock = sync_lock or SyncLock()
        self.on_error = on_error or (lambda _e: None)
        self._http_post = http_post or _http_post
        self._http_probe = http_probe or _http_ping
        self.on_reconnect = on_reconnect or (lambda: None)
        self._queue: "queue.Queue[object]" = queue.Queue()
        self._stop = object()
        self.counts: dict = {}
        self._counts_lock = threading.Lock()  # the prober thread counts too
        # Learned owner→relay routes (fleet 307 redirects). Touched only
        # on the transport thread. Invalidated by the next 307
        # (re-learn), a 404 (stale route — the owner moved or the relay
        # left the fleet), or a connection failure on the learned URL
        # (fail back to the configured relay before declaring offline).
        self._routes: dict = {}
        # Negotiated wire capabilities per relay URL: what the LAST
        # response from that relay echoed back from our advertised set.
        # Empty/absent = a v1 peer.
        self.negotiated_capabilities: dict = {}
        # Reconnect probing state (db.ts:390-412 analog): offline is
        # entered by a swallowed fetch error, left by the first probe
        # success or successful round — either fires on_reconnect.
        self._probe_lock = threading.Lock()
        self._probe_stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._offline = False
        self._pending_reconnect = False  # transport-thread only
        # The optional push-subscription leg, attached by connect() under
        # Config.push_subscribe and bound lazily from the first successful
        # round.
        self.push_subscriber = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-sync")
        self._thread.start()

    def _count(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def request_sync(self, request: SyncRequestInput) -> None:
        self._queue.put(request)

    def stop(self) -> None:
        if self.push_subscriber is not None:
            self.push_subscriber.stop()
        self._probe_stop.set()
        with self._probe_lock:
            prober = self._prober
        if prober is not None and prober is not threading.current_thread():
            # Bounded: the prober may be mid-GET with a 5s socket
            # timeout; it is a daemon thread that only touches the
            # network, so don't stall dispose() on it.
            prober.join(timeout=0.2)
        self._queue.put(self._stop)
        self._thread.join()

    # -- offline → online transitions --

    def _note_offline(self) -> None:
        """A fetch error was swallowed: start probing GET /ping until
        the transport comes back (unless probing is disabled)."""
        interval = self.config.reconnect_probe_interval
        with self._probe_lock:
            self._offline = True
            if interval is None or self._probe_stop.is_set():
                return
            if self._prober is not None and self._prober.is_alive():
                return
            self._prober = threading.Thread(
                target=self._probe_loop, args=(interval,),
                daemon=True, name="evolu-sync-probe",
            )
            self._prober.start()

    def _probe_loop(self, interval: float) -> None:
        ping_url = _ping_url(self.config.sync_url)
        delay = interval
        try:
            while not self._probe_stop.wait(delay):
                with self._probe_lock:
                    if not self._offline:
                        return  # a successful round beat the probe
                try:
                    self._http_probe(ping_url)
                except urllib.error.HTTPError:
                    # The server ANSWERED (e.g. /ping 404s behind a
                    # path-prefixed deployment): the transport is up.
                    pass
                except Exception:  # noqa: BLE001 - still offline; back
                    # off so an hours-long outage doesn't hammer 1/s
                    delay = min(delay * 2, max(30.0, interval))
                    continue
                self._came_back()
                # Back off after a reconnect attempt too: if /ping
                # succeeds but the sync POST keeps failing, each probe
                # success fires a doomed round. A true recovery exits at
                # the next _offline check. Do NOT return here: a flap may
                # already have re-marked us offline, and exiting while
                # _note_offline still saw this thread alive would leave
                # NO prober running.
                delay = min(delay * 2, max(30.0, interval))
        finally:
            # Closes the remaining flap window: if offline was re-set
            # between our last check and this exit, restart a fresh
            # prober (suppressed during stop()).
            with self._probe_lock:
                self._prober = None
                restart = self._offline and not self._probe_stop.is_set()
            if restart:
                self._note_offline()

    def _note_online(self) -> None:
        """A round succeeded (or the server answered an error — either
        way the transport is up); if we were offline this IS the
        reconnect. Firing is deferred to the loop, after the sync lock
        is released (see _loop)."""
        with self._probe_lock:
            was_offline = self._offline
            self._offline = False
        if was_offline:
            self._pending_reconnect = True

    def _came_back(self) -> None:
        with self._probe_lock:
            # stop() joins the daemon prober with a short timeout, so a
            # probe can complete mid-dispose — don't fire the reconnect
            # hook into an already-disposed Evolu instance.
            if self._probe_stop.is_set() or not self._offline:
                return
            self._offline = False
        self._fire_reconnect()

    def _fire_reconnect(self) -> None:
        self._count("reconnects")
        try:
            self.on_reconnect()
        except Exception as e:  # noqa: BLE001 - hook must not kill transport
            self.on_error(UnknownError(e))

    def flush(self) -> None:
        done = threading.Event()
        self._queue.put(done)
        done.wait()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is self._stop:
                return
            if isinstance(item, threading.Event):
                item.set()
                continue
            with self.sync_lock.hold():
                received = self._sync_round(item)
            # Everything below runs with the sync lock RELEASED. The
            # worker's _receive skips its anti-entropy resend while the
            # lock is pending/held — handing it the response under the
            # lock would race that gate and silently drop the resend.
            # Same for the reconnect hook's pull round.
            if received is not None:
                try:
                    self.on_receive(*received)
                except Exception as e:  # noqa: BLE001
                    self.on_error(UnknownError(e))
            if self._pending_reconnect:
                self._pending_reconnect = False
                self._fire_reconnect()

    def _aead_negotiated(self, url: str, caps) -> bool:
        """v2 emission gate: we advertise aead-batch-v1 AND the LAST
        response from `url` echoed it back. Everything else — first
        contact, a v1 relay, a failover target we never spoke to —
        gets the v1 wire. Decoding needs no gate (records
        self-describe), so this only ever controls what we WRITE."""
        return (
            protocol.CAP_AEAD_BATCH in caps
            and protocol.CAP_AEAD_BATCH in self.negotiated_capabilities.get(url, ())
        )

    def _scope_negotiated(self, url: str, caps) -> bool:
        """The scope clause's emission gate (the aead gate's twin): we
        advertise sync-scope-v1 AND the last response from `url` echoed
        it. A relay that does not is never sent a clause; it answers the
        full serve, and the worker's materialization filter still
        applies."""
        return (
            protocol.CAP_SYNC_SCOPE in caps
            and protocol.CAP_SYNC_SCOPE in self.negotiated_capabilities.get(url, ())
        )

    def _drop_negotiated(self, url: str) -> None:
        """Invalidate the cached capability set alongside a route
        invalidation: a failover replica must be treated as
        un-negotiated (v1) until its own response says otherwise."""
        if self.negotiated_capabilities.pop(url, None) is not None:
            self._count("capability_invalidations")
            metrics.inc("evolu_crypto_capability_invalidations_total")

    def _encode_push(self, request: SyncRequestInput, node_id: str,
                     caps, use_v2: bool, scope_clause=None) -> bytes:
        """One request body. v1: the fused C wire path (byte-identical
        to `encode_sync_request` over `encrypt_messages`), the pure
        per-message OpenPGP loop behind it. v2 (negotiated only): one
        session key and one GCM record a message
        (`encode_push_request_aead`), the pure aead loop behind it.
        Capabilities append identically on every path; absent caps =
        the v1 wire byte for byte. `scope_clause` (negotiated only)
        appends as field 6 the same way; None = the unscoped wire."""
        body = None
        if use_v2 and request.messages:
            session = aead.get_session(request.owner.mnemonic, records=len(request.messages))
            body = native_crypto.encode_push_request_aead(
                request.messages, session.key, session.salt,
                request.owner.id, node_id, request.merkle_tree,
            )
            if body is None:
                encrypted = encrypt_messages_v2(request.messages, request.owner.mnemonic)
                body = protocol.encode_sync_request(
                    protocol.SyncRequest(encrypted, request.owner.id, node_id, request.merkle_tree)
                )
        if body is None:
            body = native_crypto.encode_push_request(
                request.messages, request.owner.mnemonic,
                request.owner.id, node_id, request.merkle_tree,
            )
        if body is None:
            encrypted = encrypt_messages(request.messages, request.owner.mnemonic)
            body = protocol.encode_sync_request(
                protocol.SyncRequest(encrypted, request.owner.id, node_id, request.merkle_tree)
            )
        if caps:
            body = body + protocol.encode_request_capabilities(caps)
        if scope_clause is not None:
            body = body + protocol.encode_request_scope(scope_clause)
        return body

    def _decode_response(self, response_bytes: bytes, mnemonic: str):
        """Response bytes → (messages, merkle_tree). The fully fused
        decode first: protobuf walk, decrypt and columns in one C call
        → a `PackedReceive` for the worker's packed apply. Any
        non-canonical shape falls to the object-path fused decoder, then
        to the pure decoder (identical error surfaces down the chain)."""
        packed = native_crypto.decrypt_response_columns(response_bytes, mnemonic)
        if packed is not None:
            return packed
        fused = native_crypto.decrypt_response(response_bytes, mnemonic)
        if fused is not None:
            return fused
        response = protocol.decode_sync_response(response_bytes)
        return decrypt_messages(response.messages, mnemonic), response.merkle_tree

    def _post_traced(self, url: str, body: bytes) -> bytes:
        """The sync POST with the ambient trace context as a traceparent
        header (headers only: the body bytes are untouched). An injected
        2-argument http_post is served without the header rather than
        broken."""
        hdrs = trace.inject_headers()
        if hdrs and _accepts_headers(self._http_post):
            return self._http_post(url, body, headers=hdrs)
        return self._http_post(url, body)

    def _sync_round(self, request: SyncRequestInput):
        """One round, traced end to end: the round span joins the
        mutation's trace when the request carries one (the worker mints it
        at Send) and roots a fresh trace for pull-only rounds; the POST
        carries this span's context. Returns what `_sync_round_body`
        returns."""
        rspan = trace.start_span("sync.round", parent=getattr(request, "trace", None),
                                 attrs={"messages": len(request.messages)})
        with rspan, trace.use(rspan.context):
            return self._sync_round_body(request)

    def _sync_round_body(self, request: SyncRequestInput):
        """One encrypt→POST→decrypt round. Returns the decoded
        (messages, merkle_tree, previous_diff) for the caller to hand
        to on_receive AFTER releasing the lock, or None when there is
        nothing to receive."""
        caps = tuple(self.config.sync_capabilities or ())
        owner_id = request.owner.id
        base = self.config.sync_url
        url = self._routes.get(owner_id, base)
        use_v2 = self._aead_negotiated(url, caps)
        scope = getattr(self.config, "sync_scope", None)
        clause = None
        if scope is not None and not scope.is_noop and self._scope_negotiated(url, caps):
            # The clause rides only a negotiated wire. Its push lanes name
            # each pushed message's table, out-of-scope tables too: the
            # relay's lanes must stay true for other scoped clients.
            clause = scope.wire_clause(request.owner.mnemonic,
                                       push_tables=tuple(m.table for m in request.messages))
        try:
            node_id = timestamp_from_string(request.clock_timestamp).node
            body = self._encode_push(request, node_id, caps, use_v2, scope_clause=clause)
        except Exception as e:  # noqa: BLE001
            self.on_error(UnknownError(e))
            return None
        self._count("requests")
        self._count("request_messages", len(request.messages))
        self._count("request_bytes", len(body))
        metrics.inc("evolu_sync_requests_total")
        metrics.inc("evolu_sync_request_messages_total", len(request.messages))
        metrics.observe("evolu_sync_request_bytes", len(body), buckets=metrics.SIZE_BUCKETS)
        log("sync:request", url=url, messages=len(request.messages), bytes=len(body))

        class _Abort(Exception):
            pass

        downgraded = False

        def retarget(new_url: str):
            """Move this round to another relay. If the body was a v2
            envelope but the new target is not negotiated for it,
            re-emit the round as v1 — a failover replica must NEVER
            receive v2 records it didn't advertise for. Likewise a scope
            clause: a target that did not advertise sync-scope-v1 gets
            the round unscoped (the full serve; the worker still
            filters)."""
            nonlocal url, body, use_v2, downgraded, clause
            url = new_url
            need_v1 = use_v2 and not self._aead_negotiated(new_url, caps)
            drop_scope = clause is not None and not self._scope_negotiated(new_url, caps)
            if not (need_v1 or drop_scope):
                return
            if need_v1:
                use_v2 = False
                downgraded = True
            if drop_scope:
                clause = None
                self._count("scope_downgrades_failover")
                metrics.inc("evolu_scope_downgrades_total", reason="failover")
            try:
                body = self._encode_push(request, node_id, caps, use_v2, scope_clause=clause)
            except Exception as e:  # noqa: BLE001 - encode must never
                # kill the transport thread; surface and end the round
                self.on_error(UnknownError(e))
                raise _Abort() from e
            if need_v1:
                self._count("v1_fallback_failover")
                metrics.inc("evolu_crypto_v1_fallback_total", reason="failover")

        followed = False
        try:
            while True:
                try:
                    response_bytes = self._post_traced(url, body)
                    break
                except urllib.error.HTTPError as e:
                    # A fleet relay answers a non-placed sync POST with
                    # 307 + the authoritative peer URL. Follow AT MOST ONE
                    # redirect per request and cache the learned
                    # owner→relay route; each hop's POST keeps its own
                    # 429/503/connection backoff inside _http_post.
                    location = e.headers.get("Location") if e.headers else None
                    if e.code == 307 and location and not followed:
                        followed = True
                        target = urllib.parse.urljoin(url, location)
                        self._routes[owner_id] = target
                        self._count("redirects")
                        metrics.inc("evolu_sync_redirects_total")
                        trace.record_span("sync.redirect", trace.current(), time.time(), 0.0,
                                          {"target": target})
                        log("sync:request", "fleet redirect", url=target)
                        retarget(target)
                        continue
                    if e.code in (307, 404) and self._routes.pop(owner_id, None):
                        # A second 307 (ring churn) or a 404 (the learned
                        # relay no longer serves this owner): the cached
                        # route is stale — and so is what we thought that
                        # relay had negotiated.
                        self._count("route_invalidations")
                        metrics.inc("evolu_sync_route_invalidations_total")
                        self._drop_negotiated(url)
                        if e.code == 404 and url != base:
                            retarget(base)
                            continue
                    # The server answered: a real error (4xx/5xx), not
                    # offline — surface it so divergence isn't silent.
                    # The transport is demonstrably UP.
                    self._count("http_errors")
                    metrics.inc("evolu_sync_http_errors_total")
                    self._note_online()
                    self.on_error(UnknownError(e))
                    return None
                except (urllib.error.URLError, OSError):
                    if url != base and self._routes.pop(owner_id, None):
                        # The LEARNED relay is unreachable — that says
                        # nothing about the configured one: drop the
                        # route (and its negotiated set) and fail over.
                        self._count("route_invalidations")
                        metrics.inc("evolu_sync_route_invalidations_total")
                        self._drop_negotiated(url)
                        retarget(base)
                        continue
                    # Offline is not an error (sync.worker.ts:217-227)
                    # — but it arms the reconnect probe.
                    self._count("offline_rounds")
                    metrics.inc("evolu_sync_offline_rounds_total")
                    self._note_offline()
                    return None
        except _Abort:
            return None
        self._note_online()
        if self.push_subscriber is not None:
            # Bind or retarget the push leg with what this round learned:
            # the owner, the clock's node id (the own-write exclusion key)
            # and the relay that actually served (after any 307 follow). A
            # scoped client's subscription carries its lane tags, so the
            # hub skips wakes its filter cannot see, under the clause's
            # own emission gate.
            sub_tags = None
            if scope is not None and scope.tables and self._scope_negotiated(url, caps):
                from evolu_tpu_torch.sync.scope import derive_scope_tag

                sub_tags = tuple(derive_scope_tag(request.owner.mnemonic, t) for t in scope.tables)
            self.push_subscriber.ensure(owner_id, node_id, url, tags=sub_tags)
        # Push-mix counts AFTER the POST landed: `use_v2` reflects the
        # FINAL body (the failover downgrade is counted in retarget).
        if request.messages:
            if use_v2:
                self._count("v2_push_legs")
                metrics.inc("evolu_crypto_v2_push_legs_total")
                self._count("v2_push_messages", len(request.messages))
                metrics.inc("evolu_crypto_v2_push_messages_total", len(request.messages))
            elif protocol.CAP_AEAD_BATCH in caps and not downgraded:
                self._count("v1_fallback_not_negotiated")
                metrics.inc("evolu_crypto_v1_fallback_total", reason="not_negotiated")
        if caps:
            try:
                negotiated = protocol.scan_sync_response_capabilities(response_bytes)
            except ValueError:
                negotiated = ()  # decode error surfaces below, on the real decoder
            self.negotiated_capabilities[url] = negotiated
            metrics.set_gauge("evolu_crdt_capability_negotiated", int(protocol.CAP_CRDT_TYPES in negotiated))
            metrics.set_gauge("evolu_crdt_list_capability_negotiated", int(protocol.CAP_CRDT_LIST in negotiated))
            metrics.set_gauge("evolu_crdt_tensor_capability_negotiated",
                              int(protocol.CAP_CRDT_TENSOR in negotiated))
            metrics.set_gauge("evolu_crypto_aead_negotiated", int(protocol.CAP_AEAD_BATCH in negotiated))
        try:
            messages, merkle_tree = self._decode_response(response_bytes, request.owner.mnemonic)
            self._count("responses")
            self._count("response_messages", len(messages))
            self._count("response_bytes", len(response_bytes))
            metrics.inc("evolu_sync_responses_total")
            metrics.inc("evolu_sync_response_messages_total", len(messages))
            metrics.observe("evolu_sync_response_bytes", len(response_bytes),
                            buckets=metrics.SIZE_BUCKETS)
            log("sync:response", messages=len(messages), bytes=len(response_bytes))
            return (messages, merkle_tree, request.previous_diff)
        except Exception as e:  # noqa: BLE001
            self.on_error(UnknownError(e))
            return None


# Transport backoff policy. A sync POST is idempotent (INSERT OR
# IGNORE + pure diff), so retrying a 429/503 or a connection failure is
# always safe. Bounded: after the retries are spent, the original
# error surfaces — a 4xx/5xx to on_error (divergence must not be
# silent), a connection error to the offline/probe machinery (offline
# remains a normal state, not an error).
BACKOFF_RETRIES = 3
BACKOFF_BASE_S = 0.05
BACKOFF_MAX_S = 5.0
RETRYABLE_HTTP = (429, 503)


def _retry_after_seconds(error: urllib.error.HTTPError) -> Optional[float]:
    """Parse a Retry-After header: RFC 7231 delay-seconds (a float is
    accepted too — relays emit sub-second values for local deploys).
    HTTP-date form and garbage fall back to our own backoff schedule
    (None)."""
    raw = error.headers.get("Retry-After") if error.headers else None
    if raw is None:
        return None
    try:
        value = float(raw.strip())
    except ValueError:
        return None
    return value if value >= 0 else None


def _http_post(url: str, body: bytes, *, retries: int = BACKOFF_RETRIES,
               base_delay: float = BACKOFF_BASE_S, max_delay: float = BACKOFF_MAX_S,
               sleep=None, rng=None, headers: Optional[dict] = None) -> bytes:
    """POST with bounded exponential backoff + full jitter on 429/503
    (honoring Retry-After — the relay's backpressure contract) and on
    connection errors. `sleep`/`rng` are injectable for tests;
    `headers` merge over the defaults."""
    import random
    import time

    sleep = sleep or time.sleep
    rng = rng or random.random
    attempt = 0
    base_headers = {"Content-Type": "application/octet-stream"}
    if headers:
        base_headers.update(headers)
    while True:
        req = urllib.request.Request(
            url, data=body, headers=base_headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code not in RETRYABLE_HTTP or attempt >= retries:
                raise
            delay = _retry_after_seconds(e)
            if delay is None:
                # Full jitter: delay ∈ [0, base * 2^attempt] — the
                # standard de-synchronizer for a fleet of clients all
                # bounced by the same overloaded relay.
                delay = min(max_delay, base_delay * (2 ** attempt)) * rng()
            metrics.inc("evolu_sync_backoff_retries_total", reason=str(e.code))
            log("sync:request", "backoff retry", code=e.code, delay_s=round(delay, 4))
        except (urllib.error.URLError, OSError):
            if attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2 ** attempt)) * rng()
            metrics.inc("evolu_sync_backoff_retries_total", reason="connection")
        sleep(min(delay, max_delay))
        attempt += 1


def _accepts_headers(fn) -> bool:
    """Whether an http_post callable takes a `headers` keyword: injected
    2-argument transports (tests, embedders, fault injectors) keep
    working without one. Memoized per callable, since a Signature is too
    heavy to build on every POST."""
    try:
        return _ACCEPTS_HEADERS_MEMO[fn]
    except TypeError:
        return _accepts_headers_probe(fn)  # unhashable callable
    except KeyError:
        pass
    ok = _accepts_headers_probe(fn)
    try:
        if len(_ACCEPTS_HEADERS_MEMO) > 256:  # unbounded-growth guard
            _ACCEPTS_HEADERS_MEMO.clear()
        _ACCEPTS_HEADERS_MEMO[fn] = ok
    except TypeError:
        pass
    return ok


_ACCEPTS_HEADERS_MEMO: dict = {}


def _accepts_headers_probe(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = sig.parameters
    return "headers" in params or any(p.kind == p.VAR_KEYWORD for p in params.values())


def _ping_url(sync_url: str) -> str:
    """The relay's health endpoint (index.ts:250-252) lives at /ping on
    the same origin as the sync POST endpoint."""
    parts = urllib.parse.urlsplit(sync_url)
    return urllib.parse.urlunsplit((parts.scheme, parts.netloc, "/ping", "", ""))


def _http_ping(url: str) -> None:
    """One cheap GET — raises while offline, returns once reachable."""
    with urllib.request.urlopen(url, timeout=5) as resp:
        resp.read()


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """Surface 3xx as HTTPError instead of following it: the push loop
    must LEARN the placed relay from a 307's Location (and cache it), not
    pay a redirect hop on every poll."""

    def redirect_request(self, *a, **k):
        return None


_PUSH_OPENER = urllib.request.build_opener(_NoRedirect)


def _push_get(url: str, timeout: float) -> bytes:
    with _PUSH_OPENER.open(url, timeout=timeout) as resp:
        return resp.read()


class PushSubscriber:
    """The client half of relay-held push subscriptions (server/push.py):
    one daemon thread long-polls `GET /push/poll?owner&node&cursor`
    against the owner's placed relay and fires `on_wake` (typically
    `evolu.sync`) whenever the relay reports foreign-authored rows. The
    parked poll replaces the polling interval: mutation→visible becomes
    the push round trip.

    Robustness mirrors the sync transport's: at most one 307 follow a poll
    with the learned route cached (dropped on 404, error or connection
    failure, failing back to the bound URL), bounded exponential backoff
    with full jitter while the relay is unreachable (offline is a normal
    state), and cursor resume across reconnects (the hub answers a
    conservative wake for a cursor its ring outgrew, so a wakeup is never
    missed). `ensure` is idempotent and re-callable: every successful sync
    round re-binds the target, so the subscription follows fleet
    placement as the sync leg does.

    `counts` (polls, wakes, redirects, errors, offline) are kept beside
    the reference's `evolu_push_client_*` metrics; `wakes` is the number
    of `on_wake` firings."""

    def __init__(self, config: Config, on_wake: Callable[[], None],
                 http_get: Optional[Callable[[str, float], bytes]] = None,
                 poll_timeout_s: Optional[float] = None):
        self.config = config
        self.on_wake = on_wake
        self._http_get = http_get or _push_get
        self._poll_timeout_s = (float(poll_timeout_s) if poll_timeout_s is not None
                                else float(config.push_poll_timeout_s))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._owner: Optional[str] = None
        self._node: Optional[str] = None
        self._base: Optional[str] = None  # bound by ensure()
        self._route: Optional[str] = None  # learned via 307
        self._tags: Optional[Tuple[str, ...]] = None  # scope lanes
        self.cursor = 0
        self.wakes = 0
        self.counts = dict.fromkeys(("polls", "wakes", "redirects", "errors", "offline"), 0)

    def ensure(self, owner_id: str, node: str, url: str,
               tags: Optional[Tuple[str, ...]] = None) -> None:
        """Bind (or re-bind) the subscription; starts the loop thread on
        the first call. Safe from any thread, idempotent. `tags` scopes the
        subscription to those lanes (None = wake on every foreign
        write)."""
        with self._lock:
            self._owner, self._node = owner_id, node
            self._base = url.rstrip("/")
            self._tags = tuple(tags) if tags else None
            if self._thread is None and not self._stop.is_set():
                self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-push")
                self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            # Bounded: the loop may be parked in a long poll; it is a daemon
            # thread that only touches the network.
            t.join(timeout=0.2)

    def _target(self) -> Tuple[str, str, str, Optional[Tuple[str, ...]]]:
        with self._lock:
            return (self._route or self._base, self._owner, self._node, self._tags)

    def _backoff(self, delay: float) -> Optional[float]:
        """Wait `delay` (capped); None once stopped, else the next delay."""
        if self._stop.wait(min(BACKOFF_MAX_S, delay)):
            return None
        return min(BACKOFF_MAX_S, delay * 2)

    def _loop(self) -> None:
        import json
        import random

        delay = BACKOFF_BASE_S
        attempt = 0
        follows = 0  # consecutive 307s without a successful poll
        while not self._stop.is_set():
            base, owner, node, tags = self._target()
            url = (f"{base}/push/poll?owner={urllib.parse.quote(owner)}"
                   f"&node={node}&cursor={self.cursor}&timeout={self._poll_timeout_s}")
            if tags:
                url += "&tags=" + urllib.parse.quote(",".join(tags))
            try:
                raw = self._http_get(url, self._poll_timeout_s + 10.0)
            except urllib.error.HTTPError as e:
                if e.code == 307:
                    location = e.headers.get("Location") if e.headers else None
                    follows += 1
                    if location and follows <= 1:
                        with self._lock:
                            self._route = urllib.parse.urljoin(base + "/", location).split("/push/", 1)[0]
                        self.counts["redirects"] += 1
                        metrics.inc("evolu_push_client_redirects_total")
                        continue
                    # A SECOND consecutive 307 means the relays' rings
                    # disagree (mid-rebalance): drop the learned route and
                    # back off instead of spinning a redirect loop.
                    with self._lock:
                        self._route = None
                    delay = self._backoff(delay)
                    if delay is None:
                        return
                    follows = 0
                    continue
                if e.code in (429, 503):
                    # Flow control (hub full, relay shedding): honor
                    # Retry-After, degrade toward polling cadence.
                    ra = _retry_after_seconds(e)
                    if self._stop.wait(ra if ra is not None else min(BACKOFF_MAX_S, delay)):
                        return
                    delay = min(BACKOFF_MAX_S, max(delay * 2, BACKOFF_BASE_S))
                    continue
                # Definitive rejection (404: stale route or a push-less
                # relay; 400): drop the learned route, fail back, back off.
                with self._lock:
                    self._route = None
                self.counts["errors"] += 1
                metrics.inc("evolu_push_client_errors_total")
                delay = self._backoff(delay)
                if delay is None:
                    return
                continue
            except Exception:  # noqa: BLE001 - offline: backoff with full jitter
                with self._lock:
                    self._route = None
                self.counts["offline"] += 1
                metrics.inc("evolu_push_client_offline_total")
                jittered = min(BACKOFF_MAX_S, BACKOFF_BASE_S * (2 ** attempt))
                if self._stop.wait(jittered * random.random() + 0.01):
                    return
                attempt = min(attempt + 1, 10)
                continue
            attempt = 0
            delay = BACKOFF_BASE_S
            follows = 0
            self.counts["polls"] += 1
            metrics.inc("evolu_push_client_polls_total")
            try:
                body = json.loads(raw)
                cursor = int(body["cursor"])
                wake = bool(body["wake"])
            except (ValueError, KeyError, TypeError):
                self.counts["errors"] += 1
                metrics.inc("evolu_push_client_errors_total")
                delay = self._backoff(delay)
                if delay is None:
                    return
                continue
            # ADOPT the relay's cursor, never max() it: cursors are per-hub
            # sequence numbers, and a relay restart or a retarget
            # legitimately answers a smaller one.
            self.cursor = cursor
            if wake and not self._stop.is_set():
                self.wakes += 1
                self.counts["wakes"] += 1
                metrics.inc("evolu_push_client_wakes_total")
                try:
                    self.on_wake()
                except Exception:  # noqa: BLE001,S110 - the wake hook must never
                    pass           # kill the subscription loop


class PeriodicSyncer:
    """Timer analog of the reference's load/online/focus sync triggers
    (db.ts:390-412): posts a pull-only sync round every `interval`
    seconds until stopped."""

    def __init__(self, evolu, interval: float):
        self._evolu = evolu
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-autosync")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._evolu.sync(refresh_queries=False)
            except Exception:  # noqa: BLE001 — never kill the timer
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join()


def connect(evolu, config: Optional[Config] = None) -> SyncTransport:
    """Wire a client to its relay: transport → Evolu.receive, and
    Evolu's post_sync → transport (db.ts:134-156's channel setup).
    When the config sets `sync_interval`, a periodic pull starts too
    (stopped by `evolu.dispose()`)."""
    cfg = config or evolu.config

    def on_reconnect():
        # The reference's online listener re-syncs immediately
        # (db.ts:390-412); app listeners fire first so they observe the
        # transition itself. The disposed gate closes the straggler-probe
        # race: stop() only joins the prober for 0.2s.
        if getattr(evolu, "_disposed", False):
            return
        evolu._fire_reconnect()
        evolu.sync(refresh_queries=False)

    transport = SyncTransport(
        cfg,
        on_receive=evolu.receive,
        sync_lock=evolu.worker.sync_lock,
        on_error=lambda e: evolu._dispatch_output(OnError(e)),
        on_reconnect=on_reconnect,
    )
    if cfg.push_subscribe:
        # The push leg: wake-driven sync rounds instead of a timer. A wake
        # only means "foreign rows may exist"; the round it fires is the
        # same anti-entropy round a timer would, so a spurious wake costs
        # one empty round.
        def on_push_wake():
            if getattr(evolu, "_disposed", False):
                return
            evolu.sync(refresh_queries=False)

        transport.push_subscriber = PushSubscriber(cfg, on_push_wake)
    evolu.attach_transport(transport)
    prev = getattr(evolu, "_auto_syncer", None)
    if prev is not None:
        prev.stop()
        evolu._auto_syncer = None
    if cfg.sync_interval:
        evolu._auto_syncer = PeriodicSyncer(evolu, cfg.sync_interval)
    return transport
