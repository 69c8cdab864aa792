"""Tensor-valued CRDT columns, the `"col:tensor:…"` type.

Column spec `"weights:tensor:<monoid>:<dtype>:<shape>"`, e.g.
`"weights:tensor:sum:f32:4x8"`: monoid ∈ {sum, mean, max}, dtype ∈
{f32, bf16}. The full type string is stored in `__crdt_schema`.

Exactness: sum and mean quantize at decode, `q = rint(v * 2^16)`, and
accumulate in modular u64, which is exactly associative and
commutative, so the device and the host agree in any order. Max maps
f32 bits through the monotone u32 key transform (nonneg → bits |
0x8000_0000, neg → ~bits) and takes the integer max.

Op kinds: `["d", b64]` delta, `["s", b64]` set (mean ops carry a
count). The latest set op (raw-string timestamp order) resets the fold
base; deltas after it reapply on top, deltas before it are shadowed.
The host does all timestamp ordering (`contributing_ops`); the device
(`ops/crdt_tensor_merge.py`) sees integers only.

bf16 without `ml_dtypes`: a bf16 value widens to f32 exactly by
shifting its 16 bits into the high half; f32 narrows to bf16 by
round-to-nearest-even on the bits. A float64 narrows through float32
first, as the JAX package's bf16 cast does.
"""

from __future__ import annotations

import base64
import functools
import json
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.obs import metrics

TENSOR = "tensor"
MONOIDS = ("sum", "mean", "max")
DTYPES = ("f32", "bf16")

# Payload cap, enforced at declaration and re-checked at decode.
TENSOR_MAX_BYTES = 1 << 16
_MAX_DIMS = 8

# Fixed-point lattice q = rint(v * 2^16); |v| ≤ 2^15 and count ≤ 2^15
# bound the unwrapped ranges; beyond them the u64 accumulator wraps,
# identically on every replica.
_FRAC_BITS = 16
_SCALE = float(1 << _FRAC_BITS)
_MAG_MAX = float(1 << 15)
_COUNT_MAX = 1 << 15

# Flat-element ceiling (ops × elements) of one device dispatch.
DEVICE_MAX_FLAT = 1 << 24

TENSOR_STATE_TABLES_SQL = (
    # One row per op: the log is the merge state. "kind" is "d"/"s",
    # "count" the mean weight (1 elsewhere), "payload" the raw
    # little-endian element bytes.
    'CREATE TABLE IF NOT EXISTS "__crdt_tensor" ('
    '"tag" BLOB PRIMARY KEY, "table" BLOB, "row" BLOB, "column" BLOB, '
    '"kind" BLOB, "count" INTEGER NOT NULL, "payload" BLOB)',
    'CREATE INDEX IF NOT EXISTS "index__crdt_tensor_cell" ON "__crdt_tensor" '
    '("table", "row", "column")',
)

Cell = Tuple[str, str, str]


class TensorConfig:
    """Parsed, validated column config; `type_string` round-trips to
    the `__crdt_schema` entry."""

    __slots__ = ("monoid", "dtype", "shape", "size", "nbytes", "type_string")

    def __init__(self, monoid: str, dtype: str, shape: Tuple[int, ...]):
        self.monoid = monoid
        self.dtype = dtype
        self.shape = shape
        self.size = 1
        for d in shape:
            self.size *= d
        self.nbytes = self.size * (4 if dtype == "f32" else 2)
        self.type_string = f"{TENSOR}:{monoid}:{dtype}:" + "x".join(str(d) for d in shape)


@functools.lru_cache(maxsize=None)
def parse_tensor_type(ct: str) -> TensorConfig:
    """`"tensor:sum:f32:4x8"` → TensorConfig. ValueError only."""
    parts = ct.split(":")
    if len(parts) != 4 or parts[0] != TENSOR:
        raise ValueError(f"tensor column type must be 'tensor:<monoid>:<dtype>:<shape>': {ct!r}")
    _tag, monoid, dtype, shape_s = parts
    if monoid not in MONOIDS:
        raise ValueError(f"unknown tensor merge monoid {monoid!r} in {ct!r}")
    if dtype not in DTYPES:
        raise ValueError(f"unknown tensor dtype {dtype!r} in {ct!r}")
    dims = shape_s.split("x")
    if not dims or len(dims) > _MAX_DIMS:
        raise ValueError(f"tensor shape must have 1..{_MAX_DIMS} dims: {ct!r}")
    shape: List[int] = []
    for d in dims:
        if not d.isdigit() or (len(d) > 1 and d[0] == "0") or int(d) < 1:
            raise ValueError(f"bad tensor dim {d!r} in {ct!r}")
        shape.append(int(d))
    cfg = TensorConfig(monoid, dtype, tuple(shape))
    if cfg.nbytes > TENSOR_MAX_BYTES:
        raise ValueError(f"tensor payload {cfg.nbytes}B exceeds the {TENSOR_MAX_BYTES}B cap: {ct!r}")
    return cfg


def is_tensor_type(ct: str) -> bool:
    return isinstance(ct, str) and ct.startswith(TENSOR + ":")


def tensor_type(monoid: str, dtype: str, shape: Sequence[int]) -> str:
    """Make (and validate) a spec suffix: → `"tensor:sum:f32:4x8"`."""
    ct = f"{TENSOR}:{monoid}:{dtype}:" + "x".join(str(int(d)) for d in shape)
    parse_tensor_type(ct)
    return ct


# --- element bytes (bf16 by bit arithmetic) ---


def bf16_bits(x) -> np.ndarray:
    """Finite float values → uint16 bf16 bit patterns: to float32 (RNE),
    then round-to-nearest-even on the upper 16 bits (overflow → inf)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)).astype(np.uint16)


def _element_bytes(cfg: TensorConfig, x) -> bytes:
    """Float values → the declared dtype's little-endian bytes."""
    if cfg.dtype == "f32":
        return np.asarray(x, np.float32).tobytes()
    return bf16_bits(x).astype("<u2").tobytes()


def _payload_f32(cfg: TensorConfig, payload: bytes) -> np.ndarray:
    """Payload bytes → (size,) float32 (bf16 widens exactly)."""
    if cfg.dtype == "f32":
        return np.frombuffer(payload, dtype=np.float32)
    bits = np.frombuffer(payload, dtype="<u2").astype(np.uint32)
    return (bits << np.uint32(16)).view(np.float32)


# --- op codecs (ValueError only) ---


def _encode(cfg: TensorConfig, kind: str, array, count: int = 1) -> str:
    arr = np.asarray(array, dtype=np.float32)
    if arr.shape != cfg.shape:
        raise ValueError(f"tensor op shape {arr.shape} != declared {cfg.shape}")
    if not np.all(np.isfinite(arr)):
        raise ValueError("tensor op values must be finite")
    if cfg.monoid != "max" and bool(np.any(np.abs(arr) > _MAG_MAX)):
        raise ValueError(f"tensor op magnitude exceeds {_MAG_MAX}")
    b64 = base64.b64encode(_element_bytes(cfg, arr.reshape(-1))).decode("ascii")
    if cfg.monoid == "mean":
        if isinstance(count, bool) or not isinstance(count, int) or not 1 <= count <= _COUNT_MAX:
            raise ValueError(f"tensor op count must be 1..{_COUNT_MAX}: {count!r}")
        return json.dumps([kind, b64, count], separators=(",", ":"))
    if count != 1:
        raise ValueError(f"count is the mean monoid's weight, not {cfg.monoid}'s")
    return json.dumps([kind, b64], separators=(",", ":"))


def tensor_delta_value(cfg: TensorConfig, array, count: int = 1) -> str:
    """Encode a delta op value for `cfg`'s monoid."""
    return _encode(cfg, "d", array, count)


def tensor_set_value(cfg: TensorConfig, array, count: int = 1) -> str:
    """Encode an overwrite: resets the fold base."""
    return _encode(cfg, "s", array, count)


def decode_tensor_op(cfg: TensorConfig, value) -> Tuple[str, bytes, int]:
    """Decode an op value against the declared config → (kind, payload
    bytes, count). Every accepted payload is exactly `cfg.nbytes` of
    finite elements, magnitude-bounded except for max."""
    if not isinstance(value, str):
        raise ValueError(f"tensor op value must be a JSON string: {value!r}")
    if len(value) > 2 * TENSOR_MAX_BYTES:
        raise ValueError("tensor op value exceeds the payload cap")
    try:
        op = json.loads(value)
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed tensor op JSON: {e}") from e
    if not isinstance(op, list) or not op or op[0] not in ("d", "s"):
        raise ValueError(f"malformed tensor op shape: {value!r}")
    count = 1
    if cfg.monoid == "mean":
        if len(op) != 3:
            raise ValueError(f"mean op must be [kind, b64, count]: {value!r}")
        count = op[2]
        if isinstance(count, bool) or not isinstance(count, int) or not 1 <= count <= _COUNT_MAX:
            raise ValueError(f"tensor op count must be 1..{_COUNT_MAX}: {count!r}")
    elif len(op) != 2:
        raise ValueError(f"{cfg.monoid} op must be [kind, b64]: {value!r}")
    if not isinstance(op[1], str):
        raise ValueError(f"tensor op payload must be base64: {value!r}")
    try:
        payload = base64.b64decode(op[1], validate=True)
    except Exception as e:  # binascii.Error
        raise ValueError(f"tensor op payload is not base64: {e}") from e
    if len(payload) != cfg.nbytes:
        raise ValueError(f"tensor op payload {len(payload)}B != declared {cfg.nbytes}B")
    arr = _payload_f32(cfg, payload)
    if not np.all(np.isfinite(arr)):
        raise ValueError("tensor op payload must be finite")
    if cfg.monoid != "max" and bool(np.any(np.abs(arr) > _MAG_MAX)):
        raise ValueError(f"tensor op magnitude exceeds {_MAG_MAX}")
    return op[0], payload, count


def decode_tensor_batch(
    cfg: TensorConfig, msgs: Sequence[CrdtMessage]
) -> Tuple[List[Tuple[CrdtMessage, str, bytes, int]], int]:
    """→ ([(msg, kind, payload, count)], malformed_count)."""
    out: List[Tuple[CrdtMessage, str, bytes, int]] = []
    bad = 0
    for m in msgs:
        try:
            kind, payload, count = decode_tensor_op(cfg, m.value)
        except ValueError:
            bad += 1
            continue
        out.append((m, kind, payload, count))
    return out, bad


# --- the fixed-point / key algebra (shared by oracle and device prep) ---


def quantize(cfg: TensorConfig, payload: bytes) -> np.ndarray:
    """Payload → (size,) int64 on the 2^-16 lattice (exact widening,
    IEEE round-half-even)."""
    v = _payload_f32(cfg, payload).astype(np.float64)
    return np.rint(v * _SCALE).astype(np.int64)


def monotone_key(cfg: TensorConfig, payload: bytes) -> np.ndarray:
    """f32 bits → (size,) uint32 keys whose unsigned order is the float
    order (-0.0 below +0.0)."""
    b = _payload_f32(cfg, payload).view(np.uint32)
    return np.where(b >> 31 != 0, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def monotone_key_invert(keys: np.ndarray) -> np.ndarray:
    """Inverse of `monotone_key` → float32."""
    k = keys.astype(np.uint32)
    b = np.where(k >> 31 != 0, k ^ np.uint32(0x80000000), ~k)
    return b.astype(np.uint32).view(np.float32)


def zeros_value(cfg: TensorConfig) -> bytes:
    """The app-table default for a never-touched cell (0.0 is all-zero
    bytes in both dtypes)."""
    return bytes(cfg.nbytes)


def _finalize(cfg: TensorConfig, acc: np.ndarray, den: int) -> bytes:
    """Accumulator → canonical app-table bytes, shared by the host
    oracle and the device unpack: sum/mean divide the two's-complement
    value on the exact f64 lattice, then one rounding into the dtype;
    max inverts the keys."""
    if cfg.monoid == "max":
        vec = monotone_key_invert(acc.astype(np.uint32))
    else:
        vec = acc.astype(np.uint64).view(np.int64).astype(np.float64) / (float(den) * _SCALE)
    return _element_bytes(cfg, vec)


# --- host-oracle fold ---


def contributing_ops(ops: Sequence[Tuple[str, str, int, bytes]]) -> List[Tuple[str, int, bytes]]:
    """The semidirect mask: [(tag, kind, count, payload)] in any order
    (duplicate tags keep the first) → [(kind, count, payload)]: the
    latest set op, then every delta tagged after it; with no set op,
    all deltas."""
    by_tag: Dict[str, Tuple[str, int, bytes]] = {}
    for tag, kind, count, payload in ops:
        if tag not in by_tag:
            by_tag[tag] = (kind, count, payload)
    tags = sorted(by_tag)
    base_i = -1
    for i, t in enumerate(tags):
        if by_tag[t][0] == "s":
            base_i = i
    contrib: List[Tuple[str, int, bytes]] = []
    if base_i >= 0:
        contrib.append(by_tag[tags[base_i]])
    for t in tags[base_i + 1:] if base_i >= 0 else tags:
        kind, count, payload = by_tag[t]
        if kind == "d":
            contrib.append((kind, count, payload))
    return contrib


def _fold_contributions(cfg: TensorConfig, contrib: Sequence[Tuple[str, int, bytes]]) -> bytes:
    """numpy reduction over a masked contributing list: modular u64 for
    sum/mean, integer max over monotone keys."""
    if not contrib:
        return zeros_value(cfg)
    if cfg.monoid == "max":
        acc: Optional[np.ndarray] = None
        for _kind, _count, payload in contrib:
            keys = monotone_key(cfg, payload)
            acc = keys if acc is None else np.maximum(acc, keys)
        return _finalize(cfg, acc, 1)
    acc64 = np.zeros(cfg.size, np.uint64)
    den = 0
    for _kind, count, payload in contrib:
        c = count if cfg.monoid == "mean" else 1
        acc64 += quantize(cfg, payload).view(np.uint64) * np.uint64(c)
        den += c
    return _finalize(cfg, acc64, den if cfg.monoid == "mean" else 1)


def fold_cell(cfg: TensorConfig, ops: Sequence[Tuple[str, str, int, bytes]]) -> bytes:
    """Per-cell fold: [(tag, kind, count, payload)] in any order →
    canonical materialized bytes."""
    return _fold_contributions(cfg, contributing_ops(ops))


def replay_log(types: Dict[Tuple[str, str], str], msgs: Sequence[CrdtMessage]) -> Dict[Cell, bytes]:
    """Host-oracle replay of a full op log (any order, duplicates fine)
    → {cell: materialized bytes} for every tensor column in `types`."""
    seen: Set[str] = set()
    per_cell: Dict[Cell, List[Tuple[str, str, int, bytes]]] = {}
    for m in msgs:
        if m.timestamp in seen:
            continue
        seen.add(m.timestamp)
        ct = types.get((m.table, m.column))
        if ct is None or not is_tensor_type(ct):
            continue
        try:
            kind, payload, count = decode_tensor_op(parse_tensor_type(ct), m.value)
        except ValueError:
            continue
        per_cell.setdefault((m.table, m.row, m.column), []).append((m.timestamp, kind, count, payload))
    return {cell: fold_cell(parse_tensor_type(types[(cell[0], cell[2])]), ops)
            for cell, ops in per_cell.items()}


# --- SQL state fold (runs inside the caller's apply transaction) ---


def apply_tensor_ops(db, ct: str, new_msgs: Sequence[CrdtMessage]) -> Set[Cell]:
    """Append new tensor ops of one declared type (already screened
    against `__message`) to the `__crdt_tensor` log. Returns touched
    cells."""
    if not new_msgs:
        return set()
    valid, bad = decode_tensor_batch(parse_tensor_type(ct), new_msgs)
    if bad:
        metrics.inc("evolu_crdt_malformed_ops_total", bad, type=TENSOR)
    if not valid:
        return set()
    metrics.inc("evolu_crdt_ops_total", len(valid), type=TENSOR)
    n_sets = sum(1 for _m, kind, _p, _c in valid if kind == "s")
    if n_sets:
        metrics.inc("evolu_crdt_tensor_ops_total", n_sets, kind="set")
    if len(valid) - n_sets:
        metrics.inc("evolu_crdt_tensor_ops_total", len(valid) - n_sets, kind="delta")
    metrics.inc("evolu_crdt_tensor_bytes_total", sum(len(p) for _m, _k, p, _c in valid))
    db.run_many(
        'INSERT OR IGNORE INTO "__crdt_tensor" '
        '("tag", "table", "row", "column", "kind", "count", "payload") VALUES (?, ?, ?, ?, ?, ?, ?)',
        [(m.timestamp, m.table, m.row, m.column, kind, count, payload)
         for m, kind, payload, count in valid],
    )
    return {(m.table, m.row, m.column) for m, _k, _p, _c in valid}


def _cell_rows(db, table: str, column: str, rows: Sequence[str]) -> Dict[str, List[Tuple[str, str, int, bytes]]]:
    """All stored ops of the touched cells, per row."""
    out: Dict[str, List[Tuple[str, str, int, bytes]]] = {}
    for i in range(0, len(rows), 500):
        part = rows[i : i + 500]
        q = ('SELECT "row", "tag", "kind", "count", "payload" FROM "__crdt_tensor" '
             'WHERE "table" = ? AND "column" = ? AND "row" IN ({})').format(",".join("?" * len(part)))
        for r in db.exec_sql_query(q, (table, column, *part)):
            out.setdefault(r["row"], []).append((r["tag"], r["kind"], r["count"], r["payload"]))
    return out


def materialize_tensor_values(db, ct: str, table: str, column: str, rows: Sequence[str],
                              device=None) -> Dict[str, bytes]:
    """→ {row: canonical element bytes} for the touched cells of one
    (table, column). The host applies the semidirect mask; the masked
    contributions fold on the device when the flattened element count
    reaches `DEVICE_FOLD_MIN`."""
    from evolu_tpu_torch.core.crdt_types import DEVICE_FOLD_MIN

    cfg = parse_tensor_type(ct)
    plans = {row: contributing_ops(ops) for row, ops in _cell_rows(db, table, column, rows).items()}
    total_elems = sum(len(c) for c in plans.values()) * cfg.size
    use_device = DEVICE_FOLD_MIN <= total_elems
    metrics.inc("evolu_crdt_tensor_fold_total", path="device" if use_device else "host", monoid=cfg.monoid)
    metrics.inc("evolu_crdt_tensor_folded_elements_total", total_elems)
    if use_device:
        return _materialize_device(cfg, plans, device)
    return {row: _fold_contributions(cfg, c) for row, c in plans.items()}


def _materialize_device(cfg: TensorConfig, plans: Dict[str, List[Tuple[str, int, bytes]]],
                        device=None) -> Dict[str, bytes]:
    """Every touched cell's contributions in `tensor_cell_folds`
    dispatches, row groups chunked under `DEVICE_MAX_FLAT` flat elements;
    a single cell too big for one dispatch folds on the host."""
    from evolu_tpu_torch.ops.crdt_tensor_merge import tensor_cell_folds

    out: Dict[str, bytes] = {}
    max_ops = DEVICE_MAX_FLAT // cfg.size
    chunk_rows: List[Tuple[str, List[Tuple[str, int, bytes]]]] = []
    chunk_ops = 0

    def _flush():
        nonlocal chunk_rows, chunk_ops
        if not chunk_rows:
            return
        cell_id = np.empty(chunk_ops, np.int32)
        contrib = np.empty((chunk_ops, cfg.size), np.uint64)
        dens: List[int] = []
        at = 0
        for ci, (_row, contribs) in enumerate(chunk_rows):
            den = 0
            for _kind, count, payload in contribs:
                if cfg.monoid == "max":
                    contrib[at] = monotone_key(cfg, payload).astype(np.uint64)
                else:
                    c = count if cfg.monoid == "mean" else 1
                    contrib[at] = quantize(cfg, payload).view(np.uint64) * np.uint64(c)
                    den += c
                cell_id[at] = ci
                at += 1
            dens.append(den if cfg.monoid == "mean" else 1)
        table = tensor_cell_folds(cell_id, contrib, len(chunk_rows), cfg.monoid, device=device)
        for ci, (row, _contribs) in enumerate(chunk_rows):
            out[row] = _finalize(cfg, table[ci], dens[ci])
        chunk_rows = []
        chunk_ops = 0

    for row in sorted(plans):
        contribs = plans[row]
        if not contribs:
            out[row] = zeros_value(cfg)
            continue
        if len(contribs) > max_ops:  # one cell exceeds a dispatch
            metrics.inc("evolu_crdt_tensor_oversized_host_folds_total")
            out[row] = _fold_contributions(cfg, contribs)
            continue
        if chunk_ops + len(contribs) > max_ops:
            _flush()
        chunk_rows.append((row, contribs))
        chunk_ops += len(contribs)
    _flush()
    return out


# --- reads for the client API ---


def tensor_config(db, table: str, column: str) -> TensorConfig:
    """The declared config of (table, column); ValueError when the
    column is not a declared tensor column."""
    from evolu_tpu_torch.core.crdt_types import load_schema

    ct = load_schema(db).column_type(table, column)
    if not is_tensor_type(ct):
        raise ValueError(f"{table}.{column} is not a declared tensor column: {ct!r}")
    return parse_tensor_type(ct)


def tensor_state(db, table: str, row: str, column: str):
    """The materialized cell value as a shaped CPU torch tensor of the
    declared dtype (torch.float32 or torch.bfloat16; numpy has no
    bfloat16), or None when the app row does not exist."""
    import torch

    from evolu_tpu_torch.storage.sqlite import quote_ident

    cfg = tensor_config(db, table, column)
    rows = db.exec_sql_query(
        f'SELECT {quote_ident(column)} AS "v" FROM {quote_ident(table)} WHERE "id" = ?', (row,)
    )
    if not rows:
        return None
    raw = rows[0]["v"]
    if raw is None:
        raw = zeros_value(cfg)
    if isinstance(raw, str):
        raw = raw.encode("latin-1")
    if cfg.dtype == "f32":
        return torch.from_numpy(np.frombuffer(bytes(raw), "<f4").astype(np.float32)).reshape(cfg.shape)
    bits = np.frombuffer(bytes(raw), "<u2").astype(np.uint16).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16).reshape(cfg.shape)
