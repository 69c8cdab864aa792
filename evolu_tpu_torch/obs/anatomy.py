"""Stage-anatomy plane: the reconcile pipeline as a declarative stage
registry with priced floors.

The port's copy of `evolu_tpu.obs.anatomy`, with the same stage names,
inputs, outputs and price terms (so `registry_digest` agrees with the
reference's once both hold the same laws), and its own cost laws:

- `STAGES` — the ordered registry over the reconcile pipeline
  (packed-key sort → plan/compare → hash render → Merkle minute fold →
  compact-delta encode → pull wave) plus the runtime seams the engine
  times per batch (device dispatch / pull wave / host apply). Each
  stage declares its inputs, outputs, and a priced floor as cost-law
  terms.
- `COST_LAWS` — the machine-readable cost laws, a `cuda` row only,
  priced from H100 runs of `chip_smoke.py` path O1/O2. `floor_ms`
  prices a stage from them. Floors are the RECORDED BEST for the
  platform, not an ideal roofline: "over floor" means "regressed
  ≥ FLOOR_FACTOR× from what this repo has measured". The CPU (the
  plain versions of the kernels) is unpriced: floor 0.0, never
  flagged, as the reference treats an unknown platform.
- `record_stage` / `record_span` — the runtime accountant feeding the
  `evolu_stage_*` metrics family: per-stage histograms + totals, an
  online (decayed) least-squares fit per stage separating the fixed
  per-call intercept from the per-row slope, per-batch
  device-dispatch / pull-wave / host-apply share gauges (EWMA over
  recent batches), and `evolu_stage_over_floor_total` flags when a
  stage runs above FLOOR_FACTOR× its priced floor.

This module imports no torch and no jax
(tests/test_torch_import_hygiene.py): the platform is pushed in via
`set_platform` from the device side (parallel/mesh.py), and every value
recorded here is a host-side Python float the hot paths already hold.
The accountant follows `metrics.registry.enabled` — disabled, a record
call is one attribute read.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from evolu_tpu_torch.obs import metrics

# --------------------------------------------------------------------
# Cost laws: ms per 1M rows (per_1m_rows), MB/s (bandwidth), rows/s
# (rows_per_s) or plain ms (fixed). One row, `cuda`, priced from one
# run of `chip_smoke.py` on an NVIDIA H100 80GB HBM3 at 700.00 W (the
# whole script, its path O): O1's median CUDA-events ms of each stage
# over the columns pass's obs-off runs at 2^20 rows, scaled to 1M rows,
# and O2's engine stage records. Floors are that run's numbers, so
# "over floor" means FLOOR_FACTOR× slower than it.
# --------------------------------------------------------------------

COST_LAWS: Dict[str, Dict[str, float]] = {
    "cuda": {
        # key_sort is one torch.sort of the packed i64 key plus 2 gathers
        # of the u64 HLC payloads (k1, k2) by its permutation. O1 times the
        # stage as a whole (1.3469 ms) and the bare sort of the same key
        # apart (0.2197 ms): the sort is the key's law, and each gather
        # takes half of the rest.
        "sort_key_ms_per_1m": 0.2095,
        "sort_payload_ms_per_1m": 0.5375,
        # plan_compare: the two segmented lex-max scans (kernel L, forward
        # and reverse) and the flag algebra.
        "plan_scan_pair_ms_per_1m": 0.6911,
        # hash_render: kernel H (render, murmur3, mask, digest).
        "hash_render_ms_per_1m": 0.0719,
        # minute_fold: the tile sort and kernel X.
        "minute_fold_ms_per_1m": 0.6995,
        # delta_encode: the engine's compact-delta encode
        # (`engine.compact_segments`) on the minute fold's outputs.
        "delta_encode_ms_per_1m": 0.2681,
        # device_dispatch's intercept in O2's stage fit (start_batch's
        # host packing and parse, not a device round trip) and one
        # to_host_many wave's rate (O1's pull of 20 MB, pageable).
        "fixed_rtt_ms": 121.19,
        "pull_mb_per_s": 3019.0,
        # host_apply in O2: the native packed insert, the delta decode,
        # the tree folds and the commit.
        "host_apply_rows_per_s": 58013.0,
    },
}


@dataclass(frozen=True)
class Stage:
    """One pipeline stage: identity (inputs / outputs name the dataflow)
    plus the priced floor as (law_key, unit) terms, where
    unit ∈ {per_1m_rows, bandwidth, fixed, rows_per_s, device_pipeline}."""

    name: str
    kind: str  # "device" (ablatable kernel stage) | "host" | "runtime"
    description: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    price: Tuple[Tuple[str, str], ...] = ()


STAGES: Tuple[Stage, ...] = (
    Stage(
        "key_sort", "device",
        "winner flags + packed owner|cell|idx|flags i64 key + torch.sort "
        "and the two u64 HLC payloads gathered (reconcile.shard_kernel head)",
        inputs=("cell_id", "k1", "k2", "ex_k1", "ex_k2", "owner_ix"),
        outputs=("key_sorted", "k1_sorted", "k2_sorted"),
        price=(("sort_key_ms_per_1m", "per_1m_rows"),
               ("sort_payload_ms_per_1m", "per_1m_rows"),
               ("sort_payload_ms_per_1m", "per_1m_rows")),
    ),
    Stage(
        "plan_compare", "device",
        "sorted-key field unpack + segmented max scans + LWW flag "
        "algebra (ops.merge.masks_from_sorted_flags)",
        inputs=("key_sorted", "k1_sorted", "k2_sorted"),
        outputs=("xor_sorted", "upsert_sorted", "idx_sorted"),
        price=(("plan_scan_pair_ms_per_1m", "per_1m_rows"),),
    ),
    Stage(
        "hash_render", "device",
        "HLC key unpack + canonical timestamp render + murmur3 hash, "
        "masked by the xor plan, + XOR-allreduced batch digest",
        inputs=("k1_sorted", "k2_sorted", "xor_sorted"),
        outputs=("hashes", "digest"),
        price=(("hash_render_ms_per_1m", "per_1m_rows"),),
    ),
    Stage(
        "minute_fold", "device",
        "tile-local (owner, minute) grouping + segmented XOR of the "
        "row hashes (ops.merkle_ops.owner_minute_segments)",
        inputs=("owner_ix", "k1_sorted", "hashes", "xor_sorted"),
        outputs=("owner_sorted", "minute_sorted", "seg_end", "seg_xor",
                 "valid_sorted"),
        price=(("minute_fold_ms_per_1m", "per_1m_rows"),),
    ),
    Stage(
        "delta_encode", "device",
        "compact-delta wire encode: pack owner<<32|minute, stable "
        "float-segments-to-front sort, segment count (the "
        "engine._compact_segments_tail shape, 16B/row upload form)",
        inputs=("owner_sorted", "minute_sorted", "seg_end", "seg_xor",
                "valid_sorted"),
        outputs=("delta_packed", "delta_xor", "seg_count"),
        price=(("delta_encode_ms_per_1m", "per_1m_rows"),),
    ),
    Stage(
        "pull_wave", "host",
        "one to_host_many transfer wave of the kernel outputs — "
        "one synchronize and a device-to-host copy of every output",
        inputs=("device_outputs",),
        outputs=("host_arrays",),
        price=(("pull_mb_per_s", "bandwidth"),),
    ),
    Stage(
        "device_dispatch", "runtime",
        "engine.start_batch: pack + native parse + device dispatch + "
        "async transfer start (no database access) — a fixed launch "
        "cost plus the whole device pipeline at batch size",
        inputs=("sync_requests",),
        outputs=("staged_batch",),
        price=(("fixed_rtt_ms", "fixed"), ("device_pipeline", "device_pipeline")),
    ),
    Stage(
        "host_apply", "runtime",
        "the btree+tree materialization leg: per-shard C inserts + "
        "delta decode + Merkle tree folds + one atomic commit per "
        "shard — engine.finish_batch synchronously, or the per-shard "
        "write-behind drain workers in deferred mode (each worker "
        "records its shard's batches with a shard= label)",
        inputs=("staged_batch",),
        outputs=("responses",),
        price=(("host_apply_rows_per_s", "rows_per_s"),),
    ),
)

_STAGE_BY_NAME: Dict[str, Stage] = {s.name: s for s in STAGES}

# Runtime stages whose EWMA durations form the per-batch share gauges.
RUNTIME_SHARE_STAGES = ("device_dispatch", "pull_wave", "host_apply")

# kernel:* span targets folded into the family get a priced floor when
# their work maps onto registry stages; everything else records
# unpriced (floor 0 → never flagged).
_SPAN_FLOOR_STAGES: Dict[str, Tuple[str, ...]] = {
    # reconcile_owner_batches wraps dispatch + device pipeline + pull.
    "kernel:reconcile": ("device_dispatch",),
    # The server Merkle kernels run hash + minute fold + delta encode.
    "kernel:merkle": ("hash_render", "minute_fold", "delta_encode"),
}

FLOOR_FACTOR = float(os.environ.get("EVOLU_STAGE_FLOOR_FACTOR", "4.0"))
_WARMUP_RECORDS = 2  # first records include compile; never flag them
_DECAY = 0.98  # sliding exponential window for the per-stage fit
_EWMA_ALPHA = 0.2


def registry_digest() -> str:
    """crc32 fingerprint of the registry + cost laws, served in
    `stages_payload()`: restructuring the registry or re-pricing a law
    changes it, so two payloads with one digest were priced alike."""
    doc = {
        "stages": [
            (s.name, s.kind, s.inputs, s.outputs, s.price) for s in STAGES
        ],
        "laws": COST_LAWS,
    }
    return f"{zlib.crc32(json.dumps(doc, sort_keys=True).encode()) & 0xFFFFFFFF:08x}"


def floor_ms(stage: str, rows: int = 0, nbytes: int = 0,
             platform: Optional[str] = None) -> float:
    """Priced floor for `stage` at this batch shape, in ms; 0.0 when
    the platform has no recorded laws (unknown platform = unpriced =
    never flagged) or the stage is unregistered."""
    p = platform if platform is not None else _acct.platform
    laws = COST_LAWS.get(p)
    st = _STAGE_BY_NAME.get(stage)
    if laws is None or st is None:
        if laws is not None and stage in _SPAN_FLOOR_STAGES:
            return sum(
                floor_ms(s, rows=rows, nbytes=nbytes, platform=p)
                for s in _SPAN_FLOOR_STAGES[stage]
            )
        return 0.0
    total = 0.0
    for law_key, unit in st.price:
        if unit == "per_1m_rows":
            total += laws[law_key] * (rows / 1e6)
        elif unit == "fixed":
            total += laws[law_key]
        elif unit == "bandwidth":
            total += nbytes / (laws[law_key] * 1e6) * 1e3
        elif unit == "rows_per_s":
            total += rows / laws[law_key] * 1e3
        elif unit == "device_pipeline":
            total += sum(
                floor_ms(s.name, rows=rows, platform=p)
                for s in STAGES if s.kind == "device"
            )
    return total


class _StageAccountant:
    """Per-stage running state behind the evolu_stage_* family. All
    host-side dict/float arithmetic under one lock (engine pull thread
    + relay handler threads record concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.platform = "unknown"
        self._stats: Dict[str, dict] = {}

    def _stage_state(self, stage: str) -> dict:
        st = self._stats.get(stage)
        if st is None:
            st = self._stats[stage] = {
                "count": 0, "total_ms": 0.0, "ewma_ms": None,
                # Decayed least-squares accumulators over (rows, ms).
                "n": 0.0, "sx": 0.0, "sy": 0.0, "sxx": 0.0, "sxy": 0.0,
                "slope_ns_per_row": None, "fixed_ms": None,
                "floor_ms": 0.0, "over_floor": 0,
            }
        return st

    def record(self, stage: str, seconds: float, rows: int = 0,
               nbytes: int = 0, shard: Optional[int] = None) -> None:
        if not metrics.registry.enabled:
            return
        ms = seconds * 1e3
        metrics.observe("evolu_stage_ms", ms, stage=stage)
        if shard is not None:
            # Per-shard split of a stage that runs concurrently per
            # shard (the write-behind drain): shard labels are bounded
            # by store topology, far inside the 512-per-family cap.
            metrics.observe("evolu_stage_shard_ms", ms, stage=stage,
                            shard=str(shard))
        metrics.inc("evolu_stage_seconds_total", seconds, stage=stage)
        if rows:
            metrics.inc("evolu_stage_rows_total", rows, stage=stage)
        if nbytes:
            metrics.inc("evolu_stage_bytes_total", nbytes, stage=stage)
        floor = floor_ms(stage, rows=rows, nbytes=nbytes)
        with self._lock:
            st = self._stage_state(stage)
            st["count"] += 1
            st["total_ms"] += ms
            st["ewma_ms"] = (
                ms if st["ewma_ms"] is None
                else (1 - _EWMA_ALPHA) * st["ewma_ms"] + _EWMA_ALPHA * ms
            )
            st["floor_ms"] = floor
            flagged = (
                floor > 0.0
                and st["count"] > _WARMUP_RECORDS
                and ms > FLOOR_FACTOR * floor
            )
            if flagged:
                st["over_floor"] += 1
            slope_fixed = None
            if rows > 0:
                # Decayed accumulators: the fit tracks the recent
                # regime, so a restructure shows up within ~50 batches
                # instead of being averaged against history forever.
                for k in ("n", "sx", "sy", "sxx", "sxy"):
                    st[k] *= _DECAY
                st["n"] += 1.0
                st["sx"] += rows
                st["sy"] += ms
                st["sxx"] += float(rows) * rows
                st["sxy"] += rows * ms
                n, sx, sy, sxx, sxy = (
                    st["n"], st["sx"], st["sy"], st["sxx"], st["sxy"]
                )
                var = n * sxx - sx * sx
                if n >= 2.0 and var > 1e-9:
                    slope_ms_per_row = (n * sxy - sx * sy) / var
                    fixed = (sy - slope_ms_per_row * sx) / n
                    st["slope_ns_per_row"] = max(slope_ms_per_row, 0.0) * 1e6
                    st["fixed_ms"] = max(fixed, 0.0)
                    slope_fixed = (st["slope_ns_per_row"], st["fixed_ms"])
            shares = None
            if stage in RUNTIME_SHARE_STAGES:
                ewmas = {
                    s: self._stats[s]["ewma_ms"]
                    for s in RUNTIME_SHARE_STAGES
                    if s in self._stats and self._stats[s]["ewma_ms"] is not None
                }
                total = sum(ewmas.values())
                if total > 0:
                    shares = {s: v / total for s, v in ewmas.items()}
        # Gauges outside the lock: metrics has its own.
        if floor > 0.0:
            metrics.set_gauge("evolu_stage_floor_ms", floor, stage=stage)
            metrics.set_gauge("evolu_stage_over_floor_ratio", ms / floor,
                              stage=stage)
            if flagged:
                metrics.inc("evolu_stage_over_floor_total", stage=stage)
        if slope_fixed is not None:
            # The fixed per-call intercept separated from the per-row
            # slope: a wall over a count mixes the two.
            metrics.set_gauge("evolu_stage_slope_ns_per_row",
                              slope_fixed[0], stage=stage)
            metrics.set_gauge("evolu_stage_fixed_ms", slope_fixed[1],
                              stage=stage)
        if shares is not None:
            for s, v in shares.items():
                metrics.set_gauge("evolu_stage_share", v, stage=s)

    def payload(self) -> dict:
        with self._lock:
            stages = {
                name: {
                    k: st[k]
                    for k in ("count", "total_ms", "ewma_ms",
                              "slope_ns_per_row", "fixed_ms", "floor_ms",
                              "over_floor")
                }
                for name, st in sorted(self._stats.items())
            }
        ewmas = {
            s: stages[s]["ewma_ms"]
            for s in RUNTIME_SHARE_STAGES
            if s in stages and stages[s]["ewma_ms"] is not None
        }
        total = sum(ewmas.values())
        for s, v in ewmas.items():
            stages[s]["share"] = v / total if total > 0 else None
        return {
            "platform": self.platform,
            "floor_factor": FLOOR_FACTOR,
            "registry_digest": registry_digest(),
            "stages": stages,
        }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


_acct = _StageAccountant()


def set_platform(platform: str) -> None:
    """Push the device platform in from the device side
    (parallel/mesh.py at mesh creation) — this module never asks torch
    itself. Unknown
    platforms price every floor at 0 (recorded, never flagged)."""
    _acct.platform = str(platform)


def get_platform() -> str:
    return _acct.platform


def record_stage(stage: str, seconds: float, rows: int = 0,
                 nbytes: int = 0, shard: Optional[int] = None) -> None:
    """Record one execution of a stage (runtime seams call this
    directly: engine.start_batch/finish_batch, ops.to_host_many, the
    write-behind drain workers with their shard index)."""
    _acct.record(stage, seconds, rows=rows, nbytes=nbytes, shard=shard)


def record_span(target: str, ms: float, rows: object = 0) -> None:
    """Fold a kernel:* log span into the family (utils/log.py span
    close). Stage label = the span target; rows from the span's n=
    field when present, so the per-target fit separates fixed RTT from
    slope exactly like the explicit seams."""
    n = rows if isinstance(rows, int) and rows > 0 else 0
    _acct.record(target, ms / 1e3, rows=n)


def stages_payload() -> dict:
    """The GET /stats "stages" section: per-stage counts, EWMA, fit,
    floor, over-floor tally, and runtime shares."""
    return _acct.payload()


def reset() -> None:
    """Clear accumulators (test isolation via logger.clear()); the
    platform survives — it is a process property, not a statistic."""
    _acct.reset()
