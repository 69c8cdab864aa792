"""Thread-safe metrics registry: counters, gauges, log-bucket histograms.

The only runtime signal used to be the print-gated logger; this module
gives every hot-path decision point (winner-cache hit/miss, host-oracle
routing, packed-vs-object bounces, shard sizes, sync wire volume, relay
latency) a numeric home that the relay can serve as Prometheus v0.0.4
text exposition (`render_prometheus`) or a JSON snapshot (`snapshot`).

The port's copy of `evolu_tpu.obs.metrics`, with the same family names
and byte-identical exposition.

Design constraints (the device-path invariant):
- HOST-SIDE ONLY. This package never imports torch or jax:
  instrumentation records Python ints/floats the hot paths already
  hold. Nothing here may force a device pull or add a kernel launch —
  enforced by tests/test_torch_import_hygiene.py (no torch import in
  `evolu_tpu_torch.obs`) and tests/test_torch_obs_liveness.py (outputs,
  pull waves and launches unchanged with every plane on).
- O(1) and cheap per event: one lock + one dict update. A disabled
  registry (`set_enabled(False)`) short-circuits before the lock so
  the bench guard can prove zero interaction with the timed graph.
- No module-level device state (trivially: no torch at all), so
  importing obs can never initialise CUDA or a process group.

Histograms use FIXED log-spaced buckets chosen per family at first
observe (defaults below) so exposition shape is batch-independent and
two snapshots always subtract cleanly.

Two extensions:
- **Label-cardinality bound.** Per-owner/per-peer trace labels (the
  convergence-plane freshness gauges) mean label VALUES can now come
  from data, not just code. Each family admits at most
  `label_cardinality_cap` distinct label sets; past the cap, new sets
  fold into one `"__overflow__"` value per label (the aggregate stays
  countable) and `evolu_obs_label_overflow_total{family=...}` counts
  the folds — the registry can never grow unboundedly from hostile or
  merely numerous label values.
- **Exemplars.** `observe(..., exemplar=trace_id)` attaches the most
  recent trace id to a histogram series (OpenMetrics exemplar
  semantics: one per series, latest wins — enough to jump from a
  latency histogram to `GET /trace/<id>`). Exposed via `snapshot()`
  and `get_exemplar`; the text exposition stays Prometheus 0.0.4
  unless `render_prometheus(exemplars=True)` opts into the
  OpenMetrics-style `# {trace_id="..."}` suffix.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float, hi: float, ratio: float = 2.0) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds: lo, lo*ratio, ... >= hi."""
    edges: List[float] = []
    b = float(lo)
    while b < hi:
        edges.append(b)
        b *= ratio
    edges.append(b)
    return tuple(edges)


# Default bucket families (upper bounds; +Inf is implicit).
# Durations in ms: 62.5us .. ~65.5s, x2.
LATENCY_MS_BUCKETS = log_buckets(0.0625, 1 << 16)
# Wire/byte sizes: 64B .. 64MB, x4 (the relay caps bodies at 20MB).
SIZE_BUCKETS = log_buckets(64, 1 << 26, 4.0)
# Row/message counts: 1 .. 16M, x4 (batches cap at 2^24 rows).
COUNT_BUCKETS = log_buckets(1, 1 << 24, 4.0)

_LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(items: _LabelItems, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_num(v: float) -> str:
    """Prometheus sample value / le bound: trim floats that are ints."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Hist:
    __slots__ = ("counts", "sum", "count", "exemplar")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        # (trace_id, value, unix_ts) of the latest exemplar-bearing
        # observe, or None — OpenMetrics semantics, latest wins.
        self.exemplar: Optional[Tuple[str, float, float]] = None


# Distinct label sets a family admits before new sets fold into the
# "__overflow__" aggregate. Generous: code-controlled label sets
# (shards, endpoints, peers) sit far below it; only data-driven
# labels (per-owner gauges) ever approach it.
LABEL_CARDINALITY_CAP = 512


class MetricsRegistry:
    """Counters, gauges, histograms keyed by (name, sorted labels).

    The flat imperative API (`inc`/`set_gauge`/`observe`) keeps call
    sites one line and the per-event cost one lock + one dict op —
    families (help text, histogram buckets) register implicitly on
    first use, or explicitly via `describe`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = True
        self.label_cardinality_cap = LABEL_CARDINALITY_CAP
        self._counters: Dict[str, Dict[_LabelItems, float]] = {}
        self._gauges: Dict[str, Dict[_LabelItems, float]] = {}
        self._hists: Dict[str, Dict[_LabelItems, _Hist]] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._help: Dict[str, str] = {}

    # -- write side (hot paths) --

    def _admit(self, fam: dict, name: str, key: _LabelItems) -> _LabelItems:
        """Cardinality gate, called under the lock: an already-known
        key (or the unlabeled key) passes untouched; a NEW key past
        the per-family cap folds every label value into "__overflow__"
        and counts the fold. Direct dict write for the fold counter —
        re-entering inc() under the held lock would deadlock."""
        if key in fam or not key or len(fam) < self.label_cardinality_cap:
            return key
        ofam = self._counters.setdefault("evolu_obs_label_overflow_total", {})
        okey: _LabelItems = (("family", name),)
        ofam[okey] = ofam.get(okey, 0) + 1
        return tuple((k, "__overflow__") for k, _v in key)

    def inc(self, name: str, value: float = 1, **labels) -> None:
        if not self.enabled or value == 0:
            return
        key = _label_key(labels)
        with self._lock:
            fam = self._counters.setdefault(name, {})
            key = self._admit(fam, name, key)
            fam[key] = fam.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            fam = self._gauges.setdefault(name, {})
            fam[self._admit(fam, name, key)] = float(value)

    def observe(
        self, name: str, value: float,
        buckets: Optional[Sequence[float]] = None,
        exemplar: Optional[str] = None, **labels,
    ) -> None:
        """Record into a histogram; `buckets` fixes the family's edges
        on first observe (LATENCY_MS_BUCKETS otherwise) and is ignored
        afterwards — exposition shape must not drift per call.
        `exemplar` (a trace id) replaces the series' stored exemplar
        (latest wins)."""
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            edges = self._buckets.get(name)
            if edges is None:
                edges = self._buckets[name] = tuple(
                    buckets if buckets is not None else LATENCY_MS_BUCKETS
                )
            fam = self._hists.setdefault(name, {})
            key = self._admit(fam, name, key)
            h = fam.get(key)
            if h is None:
                h = fam[key] = _Hist(len(edges))
            i = _bisect(edges, value)
            h.counts[i] += 1
            h.sum += value
            h.count += 1
            if exemplar is not None:
                h.exemplar = (exemplar, float(value), time.time())

    def describe(self, name: str, help_: str) -> None:
        with self._lock:
            self._help[name] = help_

    # -- read side --

    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels), 0)

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name, {}).get(_label_key(labels))

    def get_histogram(self, name: str, **labels):
        """(bucket_edges, cumulative_counts_incl_inf, sum, count) or None."""
        with self._lock:
            h = self._hists.get(name, {}).get(_label_key(labels))
            if h is None:
                return None
            edges = self._buckets[name]
            cum, acc = [], 0
            for c in h.counts:
                acc += c
                cum.append(acc)
            return edges, cum, h.sum, h.count

    def get_exemplar(self, name: str, **labels):
        """(trace_id, value, unix_ts) of a histogram series' latest
        exemplar, or None."""
        with self._lock:
            h = self._hists.get(name, {}).get(_label_key(labels))
            return h.exemplar if h is not None else None

    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        """Estimate the q-quantile (0..1) from a histogram's log-spaced
        buckets by linear interpolation inside the bucket. Mass in the
        overflow bucket clamps to the TOP FINITE bucket edge — never
        +Inf, even when a caller registered an explicit inf edge or all
        mass sits past the last finite bound (an estimate, not exact;
        dashboards need a plottable number)."""
        got = self.get_histogram(name, **labels)
        if got is None:
            return None
        edges, cum, _s, count = got
        if count == 0:
            return None
        import math

        finite = [e for e in edges if math.isfinite(e)]
        top = float(finite[-1]) if finite else 0.0
        target = q * count
        lo_edge = 0.0
        for i, hi_cum in enumerate(cum):
            if hi_cum >= target:
                if i >= len(edges) or not math.isfinite(edges[i]):
                    return top  # overflow mass (implicit or explicit inf)
                lo_cum = cum[i - 1] if i else 0
                width = hi_cum - lo_cum
                frac = (target - lo_cum) / width if width else 1.0
                return lo_edge + frac * (edges[i] - lo_edge)
            if i < len(edges) and math.isfinite(edges[i]):
                lo_edge = edges[i]
        return top

    def reset(self) -> None:
        with self._lock:
            self._clear_locked()

    def _clear_locked(self) -> None:
        """Clear every family. Caller holds the lock — reset must be
        atomic against concurrent inc/observe, or a racing writer could
        see one family cleared and another not (half-cleared snapshots;
        hammer-tested in tests/test_obs.py)."""
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        # _buckets/_help persist: family shape is configuration,
        # not data — a post-reset observe keeps identical buckets.

    # -- exposition --

    def render_prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format version 0.0.4. With
        `exemplars=True` the +Inf bucket line of a series carrying an
        exemplar gets the OpenMetrics-style `# {trace_id="..."} v ts`
        suffix — opt-in because 0.0.4 scrapers do not expect it (the
        relay's /metrics default stays plain 0.0.4)."""
        with self._lock:
            lines: List[str] = []
            for name in sorted(self._counters):
                self._head(lines, name, "counter")
                for key, v in sorted(self._counters[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {_fmt_num(v)}")
            for name in sorted(self._gauges):
                self._head(lines, name, "gauge")
                for key, v in sorted(self._gauges[name].items()):
                    lines.append(f"{name}{_fmt_labels(key)} {_fmt_num(v)}")
            for name in sorted(self._hists):
                self._head(lines, name, "histogram")
                edges = self._buckets[name]
                for key, h in sorted(self._hists[name].items()):
                    acc = 0
                    for edge, c in zip(edges, h.counts):
                        acc += c
                        le = _fmt_labels(key, f'le="{_fmt_num(edge)}"')
                        lines.append(f"{name}_bucket{le} {acc}")
                    acc += h.counts[-1]
                    le = _fmt_labels(key, 'le="+Inf"')
                    ex = ""
                    if exemplars and h.exemplar is not None:
                        tid, v, ts = h.exemplar
                        ex = (f' # {{trace_id="{_escape(str(tid))}"}} '
                              f"{_fmt_num(v)} {ts:.3f}")
                    lines.append(f"{name}_bucket{le} {acc}{ex}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {_fmt_num(h.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {h.count}")
            return "\n".join(lines) + ("\n" if lines else "")

    def _head(self, lines: List[str], name: str, typ: str) -> None:
        help_ = self._help.get(name)
        if help_:
            lines.append(f"# HELP {name} {_escape(help_)}")
        lines.append(f"# TYPE {name} {typ}")

    def snapshot(self, reset: bool = False) -> dict:
        """JSON-ready snapshot of every metric (same data as the text
        exposition, structured). With `reset=True`, the snapshot and
        the clear happen under ONE lock acquisition: an event can land
        either wholly before (in the snapshot) or wholly after (in the
        next window) — never be lost between a separate snapshot() and
        reset() pair (the drain-window contract the baseline-drift and
        ledger tooling rely on; hammer-tested)."""
        with self._lock:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, fam in self._counters.items():
                out["counters"][name] = [
                    {"labels": dict(k), "value": v} for k, v in sorted(fam.items())
                ]
            for name, fam in self._gauges.items():
                out["gauges"][name] = [
                    {"labels": dict(k), "value": v} for k, v in sorted(fam.items())
                ]
            for name, fam in self._hists.items():
                edges = self._buckets[name]
                out["histograms"][name] = [
                    {
                        "labels": dict(k),
                        "buckets": list(edges),
                        "counts": list(h.counts),
                        "sum": h.sum,
                        "count": h.count,
                        **({"exemplar": list(h.exemplar)}
                           if h.exemplar is not None else {}),
                    }
                    for k, h in sorted(fam.items())
                ]
            if reset:
                self._clear_locked()
            return out

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot())


# -- build info + process gauges --

_PROCESS_START = time.time()


def set_build_info(**labels) -> None:
    """Publish `evolu_build_info` — the constant-1 gauge whose LABELS
    carry the facts (version, backend, mesh device count, the
    write-behind/mesh/conn-tier flags): fleet dashboards tell a
    mesh-sharded event-loop relay from a default one by scraping, not
    SSH. Call once per process at server start; last call wins (one
    series — the relay re-publishes on reconfigure)."""
    registry.describe(
        "evolu_build_info",
        "constant 1; labels identify this process's build and topology",
    )
    registry.set_gauge(
        "evolu_build_info", 1, **{k: str(v) for k, v in labels.items()}
    )


def _read_rss_bytes() -> Optional[float]:
    """Current RSS. /proc (exact, Linux) with a getrusage fallback
    (ru_maxrss = peak, close enough where /proc is absent). Never
    raises — a gauge is not worth a failed scrape."""
    try:
        with open("/proc/self/statm", "r") as f:
            fields = f.read().split()
        import os as _os

        return float(fields[1]) * _os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 - non-Linux / masked procfs
        try:
            import resource
            import sys as _sys

            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss units differ by platform: KiB on Linux, BYTES
            # on macOS/BSD — exactly where this fallback actually runs.
            if _sys.platform != "darwin":
                peak *= 1024.0
            return float(peak)
        except Exception:  # noqa: BLE001
            return None


def update_process_gauges() -> None:
    """Refresh `evolu_process_uptime_seconds` / `evolu_process_rss_bytes`
    — called by the relay right before rendering /metrics or /stats so
    scrapes always carry current values without a background thread."""
    registry.set_gauge("evolu_process_uptime_seconds",
                       time.time() - _PROCESS_START)
    rss = _read_rss_bytes()
    if rss is not None:
        registry.set_gauge("evolu_process_rss_bytes", rss)


def _bisect(edges: Sequence[float], value: float) -> int:
    """Index of the first bucket whose upper bound >= value (len(edges)
    = the +Inf bucket). Buckets are short tuples (<= ~24): a linear
    scan beats bisect's call overhead at this size."""
    for i, e in enumerate(edges):
        if value <= e:
            return i
    return len(edges)


# Module-level default registry (the process's metric store — the relay
# endpoint and the JSON snapshot both serve this instance).
registry = MetricsRegistry()

inc = registry.inc
observe = registry.observe
set_gauge = registry.set_gauge
get_counter = registry.get_counter
get_gauge = registry.get_gauge
get_exemplar = registry.get_exemplar
render_prometheus = registry.render_prometheus
snapshot = registry.snapshot
reset = registry.reset
quantile = registry.quantile

# Content-Type for the text exposition endpoint.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def set_enabled(flag: bool) -> None:
    """Global instrumentation kill switch (bench guard / overhead
    measurement). Disabled = every write is a single attribute check."""
    registry.enabled = bool(flag)
