"""Relay-held push subscriptions: wake affected clients on mutation
instead of waiting for their next polling sync round.

The port's copy of `evolu_tpu.server.push`. The hub gates wakeups on
exactly the metadata E2EE exposes to the relay: the OWNER a batch belongs
to, and the AUTHOR NODE of each newly visible row (the 16-hex-char suffix
of its plaintext timestamp, the field the serve path's `timestamp NOT
LIKE '%' || nodeId` exclusion reads). A wakeup only tells the subscriber
"rows you don't have may exist; run a sync round". The fast path may only
OVER-approximate: "don't know" (`authors=None`) wakes everyone, so
correctness never depends on precision. Merkle anti-entropy stays the
convergence mechanism; push is a latency lever, and a missed or spurious
wakeup costs at most one polling interval or one empty sync round.

Wire shape: long-poll. `GET /push/poll?owner=<id>&node=<16hex>&
cursor=<int>[&timeout=<s>]` parks until the owner's event sequence
advances past `cursor` with at least one row authored by a DIFFERENT
node, then answers `{"wake": true, "cursor": <latest>}`; on timeout it
answers `{"wake": false, "cursor": <latest>}` and the client re-polls. A
cursor older than the bounded per-owner event ring can no longer be
qualified → a conservative `wake=true`. Both connection tiers serve the
same hub: the threaded tier parks a handler thread on an Event, the
event-loop tier (server/conn.py) parks the bare connection.

Wakeup sources (all call `notify` AFTER rows are committed, so a woken
client's sync round observes them): the sync POST handler and the
`/fleet/forward` serve (server/relay.py), replication ingest
(server/replicate.py), and `notify_all` after a whole-store snapshot
install.

Observability as the reference's: the `evolu_push_*` families (poll
requests, wakeups by reason, timeouts, rejections, the subscriptions
gauge; the relay counts fleet redirects), beside plain `counts`, one set
a hub, from which `stats_payload` answers the reference's keys.
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.sync.wire_scan import PackedMessages

# Per-owner bounded event ring: enough to qualify any plausibly-live
# cursor; older cursors degrade to a conservative wake (never a miss).
EVENT_RING = 512
# Server-side park ceiling a poll (seconds); clients may ask for less,
# never more.
MAX_POLL_TIMEOUT_S = 55.0
DEFAULT_POLL_TIMEOUT_S = 25.0

NODE_HEX_LEN = 16  # timestamp suffix width (core/timestamp.py)

# The reasons a wakeup is counted under, in `stats_payload` order.
WAKE_REASONS = ("write", "replication", "ready", "stale_cursor", "conservative")


def _author_nodes(timestamps: Sequence[str]) -> Optional[frozenset]:
    """The set of author node ids for one notify batch, or None when any
    timestamp is too short to carry a node suffix (unknown author →
    conservative: wakes every subscriber). Packed messages (the relay
    front's `wire_scan.PackedMessages`, 46-character timestamps) give
    theirs from the packed column."""
    if isinstance(timestamps, PackedMessages):
        return timestamps.node_suffixes(NODE_HEX_LEN)
    nodes = set()
    for ts in timestamps:
        if len(ts) < NODE_HEX_LEN:
            return None
        nodes.add(ts[-NODE_HEX_LEN:])
    return frozenset(nodes)


def _event_wakes(authors: Optional[frozenset], ev_tags: Optional[frozenset],
                 node: str, tags: Optional[frozenset]) -> bool:
    """Whether one ring event wakes one subscriber: a foreign-authored row
    (own-write exclusion), AND, when BOTH the subscriber's scope lanes and
    the event's lane tags are known, an overlapping lane. Either side
    unknown → the lane gate passes (over-approximation only)."""
    if authors is not None and not any(a != node for a in authors):
        return False
    if tags is not None and ev_tags is not None and not (tags & ev_tags):
        return False
    return True


class _Channel:
    """One owner's event sequence + bounded (seq, authors, tags) ring."""

    __slots__ = ("seq", "ring")

    def __init__(self):
        self.seq = 0
        self.ring: deque = deque(maxlen=EVENT_RING)

    def floor(self) -> int:
        """Oldest cursor the ring can still qualify exactly."""
        return self.ring[0][0] - 1 if self.ring else self.seq

    def qualifies(self, cursor: int, node: str,
                  tags: Optional[frozenset] = None) -> Optional[bool]:
        """Whether events past `cursor` include a row this subscriber can
        see: foreign-authored AND in one of its scope lanes (when both
        sides know their lanes). None = cursor predates the ring, or was
        minted by another hub epoch (ahead of this channel): can't know →
        the caller wakes."""
        if cursor > self.seq:
            return None
        if cursor == self.seq:
            return False
        if cursor < self.floor():
            return None
        for seq, authors, ev_tags in self.ring:
            if seq <= cursor:
                continue
            if _event_wakes(authors, ev_tags, node, tags):
                return True
        return False


class _Waiter:
    """One parked subscription. The event tier parks a connection token;
    the threaded tier parks its handler thread on the Event."""

    __slots__ = ("owner", "node", "cursor", "deadline", "event",
                 "result", "token", "registered_at", "tags")

    def __init__(self, owner: str, node: str, cursor: int,
                 deadline: float, token=None,
                 tags: Optional[frozenset] = None):
        self.owner = owner
        self.node = node
        self.cursor = cursor
        self.deadline = deadline
        self.token = token  # event-tier connection handle (opaque)
        self.event = threading.Event() if token is None else None
        self.result: Optional[bytes] = None
        self.registered_at = time.monotonic()
        self.tags = tags  # scope lanes this subscriber can see; None = all


def poll_body(wake: bool, cursor: int) -> bytes:
    """The one long-poll response body shape, shared by both tiers."""
    return json.dumps({"wake": wake, "cursor": cursor}).encode("utf-8")


class PushHub:
    """Thread-safe subscription registry + wakeup fan-out.

    `on_wake(token, body)` is installed by the event-loop tier: called
    (outside the hub lock) for each parked connection token whose
    response is ready (wakeup, timeout or shutdown). Threaded-tier
    waiters are resolved through their Event instead.

    `counts`: `poll_requests`, `timeouts`, `rejected`, `redirects` (fleet
    307s of a poll) and `wakeups`, a dict by reason (`WAKE_REASONS`).
    """

    def __init__(self, max_subscriptions: int = 1 << 17,
                 default_timeout_s: float = DEFAULT_POLL_TIMEOUT_S):
        self._lock = threading.Lock()
        self._channels: Dict[str, _Channel] = {}
        self._waiters: Dict[str, List[_Waiter]] = {}
        # token → waiter for O(1) cancel on client hangup (event-tier
        # parks only; threaded waiters have no token).
        self._by_token: Dict[object, _Waiter] = {}
        self._n_waiters = 0
        self.max_subscriptions = int(max_subscriptions)
        self.default_timeout_s = float(default_timeout_s)
        self.on_wake = None  # set by the event tier
        self._closed = False
        # Event-tier park deadlines as a lazy-deletion min-heap of
        # (deadline, tiebreak, waiter): the loop asks for the earliest
        # deadline every tick, and entries whose waiter already resolved
        # are skipped at pop time.
        self._park_heap: List[tuple] = []
        self._park_tiebreak = 0
        # Bumped by notify_all (snapshot installs): lets _admit answer a
        # conservative wake for owners the hub has NEVER seen a notify
        # for (a subscriber between polls at install time has no parked
        # waiter to wake and possibly no channel to bump).
        self._installs = 0
        self.counts = {"poll_requests": 0, "timeouts": 0, "rejected": 0, "redirects": 0,
                       "wakeups": dict.fromkeys(WAKE_REASONS, 0)}

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] += n

    def _count_wakeups(self, reason: str, n: int) -> None:
        with self._lock:
            wakeups = self.counts["wakeups"]
            wakeups[reason] = wakeups.get(reason, 0) + n
        metrics.inc("evolu_push_wakeups_total", n, reason=reason)

    # -- registration / polling --

    def _clamp_timeout(self, timeout: Optional[float]) -> float:
        t = self.default_timeout_s if timeout is None else float(timeout)
        return max(0.0, min(t, MAX_POLL_TIMEOUT_S))

    def _admit(self, owner: str, node: str, cursor: int,
               timeout: Optional[float], token=None,
               tags: Optional[frozenset] = None):
        """Shared admission: → ("now", body) for an immediately
        answerable poll, ("parked", waiter) otherwise. Caller holds no
        lock. Raises HubFull at the subscription bound."""
        with self._lock:
            self.counts["poll_requests"] += 1
            metrics.inc("evolu_push_poll_requests_total")
            if self._closed:
                return ("now", poll_body(False, cursor))
            ch = self._channels.get(owner)
            if ch is None and self._installs:
                # A snapshot install happened and this owner has no
                # channel: the install may have landed rows for it with
                # nobody parked to wake. Mint the channel with ONE
                # unknown-author event: this poll wakes conservatively
                # (once — the returned cursor parks the next one).
                ch = self._channels[owner] = _Channel()
                ch.seq = 1
                ch.ring.append((1, None, None))
            if ch is not None:
                q = ch.qualifies(cursor, node, tags)
                if q is None or q:
                    # None: the cursor predates the ring (or another
                    # epoch's), so the interim can't be proved self-only.
                    self.counts["wakeups"]["stale_cursor" if q is None else "ready"] += 1
                    metrics.inc("evolu_push_wakeups_total", reason="stale_cursor" if q is None else "ready")
                    return ("now", poll_body(True, ch.seq))
            if self._n_waiters >= self.max_subscriptions:
                self.counts["rejected"] += 1
                metrics.inc("evolu_push_rejected_total")
                raise HubFull()
            w = _Waiter(owner, node, cursor,
                        time.monotonic() + self._clamp_timeout(timeout),
                        token=token, tags=tags)
            if token is not None:
                self._park_tiebreak += 1
                heapq.heappush(self._park_heap, (w.deadline, self._park_tiebreak, w))
                self._by_token[token] = w
            self._waiters.setdefault(owner, []).append(w)
            self._n_waiters += 1
            metrics.set_gauge("evolu_push_subscriptions", self._n_waiters)
            return ("parked", w)

    def poll_blocking(self, owner: str, node: str, cursor: int,
                      timeout: Optional[float] = None,
                      tags: Optional[frozenset] = None) -> bytes:
        """Threaded-tier long-poll: park THIS thread until wakeup or
        timeout. → response body bytes."""
        kind, val = self._admit(owner, node, cursor, timeout, tags=tags)
        if kind == "now":
            return val
        w: _Waiter = val
        w.event.wait(max(0.0, w.deadline - time.monotonic()))
        with self._lock:
            if w.result is None:  # timed out parked: resolve ourselves
                self._remove_locked(w)
                ch = self._channels.get(owner)
                w.result = poll_body(False, ch.seq if ch else cursor)
                self.counts["timeouts"] += 1
                metrics.inc("evolu_push_timeouts_total")
        return w.result

    def park(self, owner: str, node: str, cursor: int,
             timeout: Optional[float], token,
             tags: Optional[frozenset] = None):
        """Event-tier long-poll: → ("now", body) or ("parked", waiter). A
        parked waiter resolves later via `on_wake(token, body)`: from
        notify, from `expire_due`, or from close()."""
        return self._admit(owner, node, cursor, timeout, token=token, tags=tags)

    def cancel(self, token) -> None:
        """Drop a parked event-tier waiter whose connection died. O(1) via
        the token index."""
        with self._lock:
            w = self._by_token.get(token)
            if w is not None:
                self._remove_locked(w)

    # -- wakeup sources --

    def notify(self, owner: str, timestamps: Optional[Sequence[str]] = None,
               reason: str = "write",
               tags: Optional[frozenset] = None) -> int:
        """Rows for `owner` became newly visible. `timestamps` are the
        batch's plaintext timestamps, or the `PackedMessages` that carry
        them (their node suffixes gate the own-write exclusion); None =
        authors unknown → wake everyone.
        `tags` are the batch's scope-lane tags when the pushing client
        assigned them; None = lanes unknown → every scoped waiter
        qualifies. Callers must notify on every path that makes rows
        visible, and may pass tags=None whenever lane attribution is
        uncertain. → waiters woken."""
        authors = None if timestamps is None else _author_nodes(timestamps)
        woken: List[_Waiter] = []
        with self._lock:
            ch = self._channels.get(owner)
            if ch is None:
                ch = self._channels[owner] = _Channel()
            ch.seq += 1
            ch.ring.append((ch.seq, authors, tags))
            lst = self._waiters.get(owner)
            if lst:
                keep = []
                for w in lst:
                    if _event_wakes(authors, tags, w.node, w.tags):
                        w.result = poll_body(True, ch.seq)
                        woken.append(w)
                    else:
                        keep.append(w)
                if keep:
                    self._waiters[owner] = keep
                else:
                    del self._waiters[owner]
                self._drop_tokens_locked(woken)
                self._n_waiters -= len(woken)
                metrics.set_gauge("evolu_push_subscriptions", self._n_waiters)
        if woken:
            self._count_wakeups(reason, len(woken))
        self._resolve(woken)
        return len(woken)

    def notify_all(self, reason: str = "conservative") -> int:
        """Everything may have changed (snapshot install): wake every
        parked subscription AND advance every known channel, so a
        subscriber that is merely BETWEEN polls sees the event on its
        next poll. Owners the hub has never seen get the conservative
        first-poll wake via `_installs` in `_admit`."""
        woken: List[_Waiter] = []
        with self._lock:
            self._installs += 1
            for owner, lst in list(self._waiters.items()):
                if owner not in self._channels:
                    self._channels[owner] = _Channel()
                woken.extend(lst)
                del self._waiters[owner]
            for ch in self._channels.values():
                ch.seq += 1
                ch.ring.append((ch.seq, None, None))
            for w in woken:
                w.result = poll_body(True, self._channels[w.owner].seq)
            self._drop_tokens_locked(woken)
            self._n_waiters -= len(woken)
            metrics.set_gauge("evolu_push_subscriptions", self._n_waiters)
        if woken:
            self._count_wakeups(reason, len(woken))
        self._resolve(woken)
        return len(woken)

    # -- expiry / lifecycle --

    def next_deadline(self) -> Optional[float]:
        """Earliest parked deadline (monotonic; possibly stale-early —
        resolved waiters linger in the heap until popped — never
        stale-late), for the event loop's select timeout."""
        with self._lock:
            return self._park_heap[0][0] if self._park_heap else None

    def expire_due(self, now: Optional[float] = None) -> int:
        """Resolve event-tier waiters past their deadline with wake=false
        (threaded-tier waiters time out on their own Event). Lazy-deletion
        heap pop: O(log n) an expiry, O(1) when nothing is due. → expired
        count."""
        now = time.monotonic() if now is None else now
        expired: List[_Waiter] = []
        with self._lock:
            while self._park_heap and self._park_heap[0][0] <= now:
                _d, _t, w = heapq.heappop(self._park_heap)
                if self._by_token.get(w.token) is not w or w.result is not None:
                    continue  # already woken or cancelled: lazy deletion
                ch = self._channels.get(w.owner)
                w.result = poll_body(False, ch.seq if ch else w.cursor)
                self._remove_locked(w)
                expired.append(w)
            self.counts["timeouts"] += len(expired)
            metrics.inc("evolu_push_timeouts_total", len(expired))
        self._resolve(expired)
        return len(expired)

    def close(self) -> None:
        """Resolve every parked subscription with wake=false (clients
        re-poll and get connection-refused → their backoff path) and
        refuse new parks."""
        waiters: List[_Waiter] = []
        with self._lock:
            self._closed = True
            for lst in self._waiters.values():
                waiters.extend(lst)
            self._waiters.clear()
            self._by_token.clear()
            self._park_heap.clear()
            self._n_waiters = 0
            metrics.set_gauge("evolu_push_subscriptions", 0)
            for w in waiters:
                if w.result is None:
                    ch = self._channels.get(w.owner)
                    w.result = poll_body(False, ch.seq if ch else w.cursor)
        self._resolve(waiters)

    def _remove_locked(self, w: _Waiter) -> None:
        if w.token is not None:
            self._by_token.pop(w.token, None)
        lst = self._waiters.get(w.owner)
        if lst and w in lst:
            lst.remove(w)
            if not lst:
                del self._waiters[w.owner]
            self._n_waiters -= 1
            metrics.set_gauge("evolu_push_subscriptions", self._n_waiters)

    def _drop_tokens_locked(self, waiters: List[_Waiter]) -> None:
        for w in waiters:
            if w.token is not None:
                self._by_token.pop(w.token, None)

    def _resolve(self, waiters: List[_Waiter]) -> None:
        """Deliver results outside the hub lock: threaded waiters via
        their Event, event-tier waiters via the installed on_wake."""
        on_wake = self.on_wake
        for w in waiters:
            if w.event is not None:
                w.event.set()
            elif on_wake is not None:
                try:
                    on_wake(w.token, w.result)
                except Exception:  # noqa: BLE001,S110 - a dead connection must
                    pass           # not break the notify fan-out

    # -- observability --

    def stats_payload(self) -> dict:
        """The `/stats` `push` section, with the reference's keys."""
        with self._lock:
            return {
                "subscriptions": self._n_waiters,
                "owners_with_waiters": len(self._waiters),
                "channels": len(self._channels),
                "wakeups_total": {r: self.counts["wakeups"].get(r, 0) for r in WAKE_REASONS},
                "timeouts_total": self.counts["timeouts"],
                "rejected_total": self.counts["rejected"],
            }


class HubFull(Exception):
    """Subscription registry at capacity: the caller answers 503 +
    Retry-After (flow control; a client degrades to its polling interval
    and retries)."""

    retry_after = 1.0


def parse_poll_query(
    query: str,
) -> Tuple[str, str, int, Optional[float], Optional[frozenset]]:
    """Decode /push/poll query params → (owner, node, cursor, timeout,
    tags). `tags` (optional, comma-separated opaque scope-lane tags)
    scopes the subscription: the hub skips wakes whose lane attribution
    provably misses every listed lane. None = wake on everything. Raises
    ValueError on malformed input (the relay answers 400)."""
    from urllib.parse import parse_qs

    from evolu_tpu_torch.sync.protocol import _MAX_SCOPE_TAG_LEN, _MAX_SCOPE_TAGS

    q = parse_qs(query, keep_blank_values=True)
    owner = q.get("owner", [""])[0]
    if not owner:
        raise ValueError("push poll needs an owner")
    node = q.get("node", [""])[0]
    if len(node) != NODE_HEX_LEN or any(c not in "0123456789abcdef" for c in node):
        raise ValueError("push poll needs node=<16 lowercase hex>")
    try:
        cursor = int(q.get("cursor", ["0"])[0])
    except ValueError:
        raise ValueError("push poll cursor must be an integer")
    timeout: Optional[float] = None
    raw_t = q.get("timeout", [None])[0]
    if raw_t is not None:
        try:
            timeout = float(raw_t)
        except ValueError:
            raise ValueError("push poll timeout must be a number")
        if not timeout >= 0:  # also rejects NaN
            raise ValueError("push poll timeout must be >= 0")
    tags: Optional[frozenset] = None
    raw_tags = q.get("tags", [None])[0]
    if raw_tags:
        parts = [t for t in raw_tags.split(",") if t]
        if len(parts) > _MAX_SCOPE_TAGS:
            raise ValueError(f"push poll caps tags at {_MAX_SCOPE_TAGS}")
        if any(len(t) > _MAX_SCOPE_TAG_LEN for t in parts):
            raise ValueError("push poll tag too long")
        tags = frozenset(parts) or None
    return owner, node, cursor, timeout, tags
