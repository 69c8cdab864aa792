"""End-to-end distributed tracing: follow one mutation across
client → relay → batch → engine → replica.

The port's copy of `evolu_tpu.obs.trace`. The metrics and flight
recorder are process-local, while a single mutation crosses client
backoff/redirect, fleet forwarding, scheduler micro-batch coalescing,
one engine pass shared with strangers, and Merkle gossip to replicas. This module is that signal: a W3C-traceparent-style
context (trace id, span id, deterministic hash-based sampling)
carried on every HTTP hop the system already makes, with spans
recorded in a bounded per-process ring (the flight-recorder shape,
obs/flight.py) and exported three ways:

- `GET /trace/<id>` per relay (server/relay.py): the JSON span tree
  for one trace, including FAN-IN spans that *link* to it (the
  scheduler's one `engine.batch` span serves N request spans from N
  different traces — it links them, it does not parent them);
- a Chrome-trace/perfetto export (`export_chrome`) interleaving host
  spans with the `kernel:*` names (utils/log.py `span()` mirrors
  into the active trace, so the fused pass's kernel spans land inside
  the batch span that dispatched them);
- span-derived exemplars on the existing latency histograms
  (obs/metrics.py `observe(..., exemplar=trace_id)`).

Propagation rules (no wire-format change — context rides HTTP headers
only; ciphertext stays opaque; v1/v2 wire bytes untouched):
- the client's sync POST carries the mutation's context
  (runtime/worker.py mints it, sync/client.py sends it);
- `POST /fleet/forward` carries the forwarding relay's server span;
- `POST /replicate/{summary,pull,snapshot*}` carry the gossip round's
  span, whose trace id is the ORIGIN trace id from the write's hint —
  so a fleet-wide "convergence trace" exists: the replica's ingest
  span lands in the same trace the client's mutation started.
- A malformed or oversized incoming `traceparent` is IGNORED (the
  request proceeds untraced) — never a 4xx/5xx (header-fuzz-pinned).

Hard constraints: HOST-SIDE ONLY — this module imports no torch and no
jax (tests/test_torch_import_hygiene.py) and adds no launch or pull to
a pass (tests/test_torch_obs_liveness.py; `chip_smoke.py` path O
prints its overhead on the card).
Sampling is DETERMINISTIC from the trace id alone, so every process
in the fleet makes the same decision with no flag coordination.
"""

from __future__ import annotations

import json
import os
import random as _random
import threading
import time
from collections import deque
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple

# Span/trace ids come from a private Mersenne generator seeded once
# from the OS — ids need uniqueness and uniformity (the deterministic
# sampler hashes them), not cryptographic strength, and getrandbits is
# ~5× cheaper per span than os.urandom. Instance methods are C-level
# atomic under the GIL, so no per-call lock.
_rng = _random.Random(int.from_bytes(os.urandom(16), "big"))

TRACEPARENT_HEADER = "traceparent"
# Anything longer is ignored outright (header smuggling / fuzz): the
# longest valid version-00 value is 55 chars; future versions may
# append members, so allow modest slack but never unbounded parsing.
TRACEPARENT_MAX_LEN = 128

# One compiled pass over the header (this runs per relay request; the
# split+set-scan form was a third of the whole tracing sequence):
# version, trace id, span id, flags — lowercase hex only, per W3C.
# Version 00 must end exactly at the flags; later versions may append
# "-member" suffixes.
import re as _re

_TRACEPARENT_RE = _re.compile(
    r"\s*([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-\S*)?\s*\Z"
)


class SpanContext(NamedTuple):
    """What crosses a process boundary: ids + the (deterministic)
    sampling decision. Immutable and cheap to copy between threads
    (the scheduler hands it handler→dispatcher; replication hands it
    handler→gossip loop). A NamedTuple, not a dataclass: one is built
    per span on the request hot path and tuple construction is ~4×
    cheaper than a frozen dataclass's __init__."""

    trace_id: str  # 32 lowercase hex chars, never all-zero
    span_id: str  # 16 lowercase hex chars, never all-zero
    sampled: bool = True


@dataclass
class Span:
    """One finished span in the ring. `links` are (trace_id, span_id)
    pairs for fan-in edges (batch ← requests, gossip round ← extra
    write origins); `tid` is the recording thread (chrome export
    lanes)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    t_start: float  # wall-clock epoch seconds
    duration_ms: float
    attrs: Dict[str, object] = field(default_factory=dict)
    links: Tuple[Tuple[str, str], ...] = ()
    tid: int = 0

    def to_json(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start": self.t_start,
            "duration_ms": self.duration_ms,
            "attrs": self.attrs,
            "links": [list(l) for l in self.links],
        }


def format_traceparent(ctx: SpanContext) -> str:
    """W3C version-00 header value for an outgoing hop."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Strict parse of an INCOMING traceparent. Returns None for
    anything malformed, oversized, all-zero, or absent — the caller
    proceeds untraced; by contract this function never raises (pinned
    by the header-fuzz test: a hostile header must never turn into a
    4xx/5xx or a handler traceback)."""
    if not value or not isinstance(value, str) or len(value) > TRACEPARENT_MAX_LEN:
        return None
    m = _TRACEPARENT_RE.match(value)
    if m is None:
        return None
    version, trace_id, span_id, _flags, extra = m.groups()
    if version == "ff" or (version == "00" and extra is not None):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    # The flag records the upstream's decision, but OUR decision is
    # re-derived deterministically from the trace id (same rate ⇒ the
    # whole fleet agrees without trusting the bit).
    return SpanContext(trace_id, span_id, recorder.sampled(trace_id))


class _NoopSpan:
    """Returned when tracing is disabled or the trace is unsampled
    with no context to propagate: every method is a no-op, `context`
    is None (callers emit no header). Singleton — zero per-call
    allocation on the disabled path."""

    __slots__ = ()
    context = None
    trace_id = None

    def set_attr(self, _k, _v) -> None:
        pass

    def add_link(self, _ctx) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.end()
        return False


NOOP_SPAN = _NoopSpan()


class ActiveSpan:
    """A started span. `context` is ready immediately (headers go out
    before the span ends); `end()` records into the ring exactly once.
    Usable as a context manager."""

    __slots__ = ("_rec", "name", "context", "parent_id", "t_start",
                 "_t0", "attrs", "links", "_done")

    def __init__(self, rec: "TraceRecorder", name: str, context: SpanContext,
                 parent_id: Optional[str], links: Tuple[Tuple[str, str], ...],
                 attrs: Optional[dict]):
        self._rec = rec
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        self.attrs = dict(attrs) if attrs else {}
        self.links = list(links)
        self._done = False

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def add_link(self, ctx: Optional[SpanContext]) -> None:
        if ctx is not None:
            self.links.append((ctx.trace_id, ctx.span_id))

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        self._rec.record(Span(
            trace_id=self.context.trace_id,
            span_id=self.context.span_id,
            parent_id=self.parent_id,
            name=self.name,
            t_start=self.t_start,
            duration_ms=(time.perf_counter() - self._t0) * 1e3,
            attrs=self.attrs,
            links=tuple(self.links),
            tid=threading.get_ident(),
        ))

    def __enter__(self) -> "ActiveSpan":
        return self

    def __exit__(self, exc_type, exc, _tb):
        if exc is not None:
            self.attrs.setdefault("error", repr(exc))
        self.end()
        return False


class TraceRecorder:
    """Bounded per-process span ring + id minting + sampling.

    The ring is the flight-recorder shape (obs/flight.py): a deque
    under a lock, one append per finished span, post-mortem reads scan
    it. Default capacity 4096 spans ≈ a few hundred recent requests —
    `GET /trace/<id>` is a debugging surface for RECENT traffic, not
    long-term storage (ship the chrome export for that)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._ring: Deque[Span] = deque(maxlen=capacity)
        self.enabled = True
        # 1.0 = trace everything (the measured-≤1% default); the
        # decision is pure in (trace_id, rate): same rate fleet-wide
        # ⇒ same decision fleet-wide. A malformed env value falls back
        # to the default — config must never crash the import (this
        # constructor runs at module import via the singleton below).
        try:
            self.sample_rate = float(os.environ.get("EVOLU_TRACE_SAMPLE", "1.0"))
        except ValueError:
            self.sample_rate = 1.0

    # -- ids / sampling --

    def new_trace_id(self) -> str:
        return f"{_rng.getrandbits(128) or 1:032x}"  # never all-zero

    def new_span_id(self) -> str:
        return f"{_rng.getrandbits(64) or 1:016x}"

    def sampled(self, trace_id: str) -> bool:
        """Deterministic hash-based decision: the top 32 bits of the
        (already uniformly random) trace id against the rate. Every
        process holding the same rate agrees — no flag coordination,
        no per-hop re-rolls."""
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        try:
            return int(trace_id[:8], 16) < rate * 0x100000000
        except ValueError:
            return False

    # -- span lifecycle --

    def start_span(
        self,
        name: str,
        parent: Optional[SpanContext] = None,
        links: Sequence[Optional[SpanContext]] = (),
        attrs: Optional[dict] = None,
        force_sample: bool = False,
    ):
        """Start a span. With a parent, the span joins the parent's
        trace (and inherits its sampling decision); without one it
        roots a fresh trace. `links` are fan-in edges to OTHER traces
        (None entries are dropped). `force_sample=True` records even
        when the own-trace decision says no — the batch span must
        exist whenever any request span it links is sampled.
        Unsampled spans still carry a real context so downstream hops
        keep making the same deterministic decision."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is not None:
            ctx = SpanContext(parent.trace_id, self.new_span_id(), parent.sampled)
            parent_id = parent.span_id
        else:
            trace_id = self.new_trace_id()
            ctx = SpanContext(trace_id, self.new_span_id(), self.sampled(trace_id))
            parent_id = None
        link_pairs = tuple((l.trace_id, l.span_id) for l in links if l is not None)
        if not ctx.sampled:
            if not force_sample and not any(
                True for l in links if l is not None and l.sampled
            ):
                # Propagate-only: context flows on, nothing lands in
                # the ring (the unsampled fast path is one branch +
                # one tuple).
                return _PropagateOnlySpan(ctx)
            # Recorded despite the own-trace decision (a sampled link
            # or an explicit force): PROMOTE the context, so children
            # opened under it — the engine pass's kernel:* spans —
            # record too, instead of silently vanishing whenever the
            # fan-in span's own fresh trace rolled unsampled.
            ctx = SpanContext(ctx.trace_id, ctx.span_id, True)
        return ActiveSpan(self, name, ctx, parent_id, link_pairs, attrs)

    def record_span(
        self,
        name: str,
        parent: Optional[SpanContext],
        t_start: float,
        duration_ms: float,
        attrs: Optional[dict] = None,
        links: Sequence[Optional[SpanContext]] = (),
    ) -> None:
        """Record an already-measured interval (the scheduler's
        queue-wait is only known at dispatch time). No-op when
        disabled or the parent trace is unsampled."""
        if not self.enabled or parent is None or not parent.sampled:
            return
        self.record(Span(
            trace_id=parent.trace_id,
            span_id=self.new_span_id(),
            parent_id=parent.span_id,
            name=name,
            t_start=t_start,
            duration_ms=duration_ms,
            attrs=dict(attrs) if attrs else {},
            links=tuple((l.trace_id, l.span_id) for l in links if l is not None),
            tid=threading.get_ident(),
        ))

    def record(self, span: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(span)

    # -- read side --

    def dump(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def size(self) -> int:
        """Spans currently in the ring — O(1), no copy."""
        with self._lock:
            return len(self._ring)

    def spans_for(self, trace_id: str) -> List[Span]:
        """Every span OF the trace plus every span LINKING to it (the
        fan-in engine.batch span lives in its own trace but must show
        up when you ask about the request's)."""
        out = []
        for s in self.dump():
            if s.trace_id == trace_id or any(t == trace_id for t, _ in s.links):
                out.append(s)
        return out

    def recent_trace_ids(self, limit: int = 64) -> List[str]:
        """Most-recent-first distinct trace ids in the ring."""
        seen: List[str] = []
        for s in reversed(self.dump()):
            if s.trace_id not in seen:
                seen.append(s.trace_id)
                if len(seen) >= limit:
                    break
        return seen

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class _PropagateOnlySpan:
    """Unsampled but context-carrying: downstream hops still see the
    trace id (and re-derive the same negative decision); nothing is
    recorded. `trace_id` is None like NOOP_SPAN's: exemplars minted
    from `<span>.trace_id` must skip unsampled spans — an exemplar
    pointing at a trace `GET /trace/<id>` can never show (and
    latest-wins overwriting the rare sampled one) would dead-end the
    histogram→trace jump the feature exists for."""

    __slots__ = ("context",)

    def __init__(self, ctx: SpanContext):
        self.context = ctx

    trace_id = None

    def set_attr(self, _k, _v) -> None:
        pass

    def add_link(self, _ctx) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        return False


# -- ambient context (thread/task-local) --

_current: ContextVar[Optional[SpanContext]] = ContextVar(
    "evolu_trace_ctx", default=None
)


def current() -> Optional[SpanContext]:
    """The ambient span context on this thread (None = untraced)."""
    return _current.get()


@contextmanager
def use(ctx: Optional[SpanContext]):
    """Make `ctx` ambient for the block — what `utils.log.span()`
    mirrors kernel spans under, and what outgoing HTTP hops read."""
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


def activate(ctx: Optional[SpanContext]):
    """Token form of `use` for call sites whose scope does not nest as
    a `with` block (the relay handler's try/finally). Pair with
    `deactivate(token)`."""
    return _current.set(ctx)


def deactivate(token) -> None:
    _current.reset(token)


def inject_headers(headers: Optional[dict] = None,
                   ctx: Optional[SpanContext] = None) -> Optional[dict]:
    """Add the traceparent header for `ctx` (default: the ambient
    context) to `headers`. Returns the dict unchanged (possibly None)
    when there is nothing to propagate — callers pass the result
    straight to the transport."""
    ctx = ctx if ctx is not None else current()
    if ctx is None or not recorder.enabled:
        return headers
    headers = dict(headers) if headers else {}
    headers[TRACEPARENT_HEADER] = format_traceparent(ctx)
    return headers


# -- exports --


def _build_tree(spans: List[Span], trace_id: str) -> List[dict]:
    """Parent-nest the trace's own spans; linked (fan-in) spans ride
    at top level with `"linked": true` — they belong to another trace
    and have no parent here."""
    own = [s for s in spans if s.trace_id == trace_id]
    linked = [s for s in spans if s.trace_id != trace_id]
    nodes = {s.span_id: {**s.to_json(), "children": []} for s in own}
    roots: List[dict] = []
    for s in sorted(own, key=lambda s: s.t_start):
        node = nodes[s.span_id]
        parent = nodes.get(s.parent_id) if s.parent_id else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for s in sorted(linked, key=lambda s: s.t_start):
        roots.append({**s.to_json(), "linked": True, "children": []})
    return roots


def serve_trace(trace_id: str) -> dict:
    """The GET /trace/<id> payload: flat spans + the nested tree."""
    spans = recorder.spans_for(trace_id)
    return {
        "trace_id": trace_id,
        "span_count": len(spans),
        "spans": [s.to_json() for s in spans],
        "tree": _build_tree(spans, trace_id),
    }


def export_chrome(spans: Optional[List[Span]] = None) -> dict:
    """Chrome-trace ("traceEvents") export of the ring (or a given
    span list): complete ("X") events in microseconds, one lane per
    recording thread. Host spans and the `kernel:*` spans mirrored by
    utils.log.span() interleave on the same timebase, so loading this
    next to a torch.profiler capture (relay `/profile`) lines the
    names up."""
    spans = recorder.dump() if spans is None else spans
    events = []
    pid = os.getpid()
    for s in spans:
        events.append({
            "name": s.name,
            "cat": "evolu",
            "ph": "X",
            "ts": s.t_start * 1e6,
            "dur": max(s.duration_ms, 0.0) * 1e3,
            "pid": pid,
            "tid": s.tid,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                **({"parent_id": s.parent_id} if s.parent_id else {}),
                **({"links": [list(l) for l in s.links]} if s.links else {}),
                **s.attrs,
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_evidence(label: str, seed=None, extra: Optional[dict] = None) -> str:
    """Seed-replay evidence dump: write the seed + flight-recorder ring + span export + metrics
    snapshot to a tmp artifact and return its path — the model-check
    episodes print it in the failure message so a failed seed arrives
    with its causal history, not just a stack. NEVER raises: a failing
    dump (full/read-only tmp, unserializable field) must not mask the
    assertion it documents — it returns a `<evidence dump failed…>`
    marker string instead of a path."""
    try:
        import tempfile

        from evolu_tpu_torch.obs import flight, ledger, metrics

        payload = {
            "label": label,
            "seed": seed,
            "written_at": time.time(),
            "flight": [
                {"target": e.target, "message": e.message, "t": e.t,
                 "duration_ms": e.duration_ms,
                 "fields": {k: repr(v) for k, v in e.fields.items()}}
                for e in flight.recorder.dump()
            ],
            "trace": export_chrome(),
            "metrics": metrics.snapshot(),
            # The conservation proof state at failure time: station
            # totals + per-owner sub-ledgers + the audit verdict — a
            # failed episode arrives knowing where every message went.
            "ledger": ledger.snapshot(),
        }
        if extra:
            payload["extra"] = extra
        fd, path = tempfile.mkstemp(
            prefix=f"evolu-evidence-{label}-", suffix=".json"
        )
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, default=repr)
        return path
    except Exception as e:  # noqa: BLE001 - see docstring
        return f"<evidence dump failed: {e!r}>"


# Module-level default recorder, like obs.metrics.registry and
# obs.flight.recorder — the process's one span store; the relay's
# /trace endpoint serves this instance.
recorder = TraceRecorder()

start_span = recorder.start_span
record_span = recorder.record_span
spans_for = recorder.spans_for
clear = recorder.clear


def set_enabled(flag: bool) -> None:
    """Tracing kill switch (bench guard / overhead measurement): when
    off, start_span returns the no-op singleton and parse/inject
    short-circuit."""
    recorder.enabled = bool(flag)


def set_sample_rate(rate: float) -> None:
    recorder.sample_rate = float(rate)
