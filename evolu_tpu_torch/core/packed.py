"""PackedReceive — a sync-response batch as columns, not objects.

The port's copy of `evolu_tpu.core.packed`. The object receive leg pays
~4 µs of per-message Python (the reference's measured floor):
`CrdtMessage` construction plus string decodes in
`native_crypto.decrypt_response`, then re-parsing and re-packing the
same strings in `worker._receive` → planner → `db.apply_planned`. This
type carries the batch exactly as the C decrypt emitted it — a
fixed-width timestamp slab, interned cells (only the k unique
(table,row,column) triples become Python strings), and bind-ready
value columns — so the whole client receive path
(reference sync.worker.ts:135-173 → receive.ts:144 →
applyMessages.ts:78) runs with zero per-row Python objects.

Fallback contract: every consumer that cannot take the columnar path
(pure-Python SQLite backend, non-canonical hex case, host-oracle plans,
sequential HLC error reproduction) calls `to_messages()` and continues
on the object path — the materialization is exact, so behavior and
error surfaces are identical to a response decoded the object way.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from evolu_tpu_torch.core.types import CrdtMessage

TS_WIDTH = 46


class PackedReceive:
    """Columnar CrdtMessage batch (the C decrypt's blob, parsed).

    Arrays are per-row: `cell_id` indexes `cells` (unique
    (table,row,column) tuples in first-appearance order, matching
    `host_parse.intern_cells`); `vkinds` uses the SQLite bind encoding
    (0 null, 1 int, 2 double, 3 text) with text payloads in `vblob`
    spanned by `voffs[i]:voffs[i]+vlens[i]`. `ts_slab` is n×46 ASCII
    bytes. Supports len()/slicing (chunked receive) and exact
    materialization via `to_messages()`.
    """

    __slots__ = (
        "n", "ts_slab", "cells", "cell_id", "vkinds", "ivals", "dvals",
        "vlens", "voffs", "vblob", "cell_blob", "cell_lens", "_parsed",
    )

    def __init__(self, n, ts_slab, cells, cell_id, vkinds, ivals, dvals,
                 vlens, voffs, vblob, cell_blob, cell_lens):
        self.n = n
        self.ts_slab = ts_slab
        self.cells = cells
        self.cell_id = cell_id
        self.vkinds = vkinds
        self.ivals = ivals
        self.dvals = dvals
        self.vlens = vlens
        self.voffs = voffs
        self.vblob = vblob
        # The raw interned-cell buffers ride along so the packed SQLite
        # apply can bind identifiers without re-encoding the `cells`
        # strings (same UTF-8 bytes by construction).
        self.cell_blob = cell_blob
        self.cell_lens = cell_lens
        self._parsed = None

    # -- construction --

    @classmethod
    def from_blob(cls, blob: bytes) -> Tuple["PackedReceive", str]:
        """Parse the `ehc_decrypt_response_columns` output blob →
        (batch, merkle_tree string). Layout documented at the C entry
        point (native/evolu_crypto.cpp,
        `ehc_decrypt_response_columns`)."""
        n, k, tree_len, vblob_len, cell_blob_len = np.frombuffer(
            blob, np.int64, 5
        )
        n, k = int(n), int(k)
        o = 40
        ivals = np.frombuffer(blob, np.int64, n, o); o += 8 * n
        dvals = np.frombuffer(blob, np.float64, n, o); o += 8 * n
        cell_id = np.frombuffer(blob, np.int32, n, o); o += 4 * n
        vlens = np.frombuffer(blob, np.int32, n, o); o += 4 * n
        cell_lens = np.frombuffer(blob, np.int32, 3 * k, o); o += 12 * k
        vkinds = np.frombuffer(blob, np.uint8, n, o); o += n
        ts_slab = blob[o : o + TS_WIDTH * n]; o += TS_WIDTH * n
        vblob = blob[o : o + int(vblob_len)]; o += int(vblob_len)
        cell_blob = blob[o : o + int(cell_blob_len)]; o += int(cell_blob_len)
        tree = blob[o : o + int(tree_len)].decode("utf-8")

        cells: List[Tuple[str, str, str]] = []
        if k:
            # The unique-cell count k approaches n on cold syncs, so
            # this materialization is per-ROW cost at its worst: one
            # whole-blob decode + offset slicing instead of 3k
            # bytes-slice+decode round-trips (measured ~4× cheaper on
            # an all-unique 100k batch). When the blob is pure ASCII —
            # identifiers almost always are — byte offsets ARE char
            # offsets and the slices never re-decode.
            bounds = np.empty(3 * k + 1, np.int64)
            bounds[0] = 0
            np.cumsum(cell_lens, out=bounds[1:])
            bl = bounds.tolist()
            text = cell_blob.decode("utf-8")
            if len(text) == len(cell_blob):
                parts = [text[a:b] for a, b in zip(bl, bl[1:])]
            else:
                parts = [cell_blob[a:b].decode("utf-8")
                         for a, b in zip(bl, bl[1:])]
            it = iter(parts)
            cells = list(zip(it, it, it))

        voffs = np.zeros(n, np.int64)
        if n:
            np.cumsum(vlens[:-1], out=voffs[1:])
        return cls(n, ts_slab, cells, cell_id, vkinds, ivals, dvals,
                   vlens, voffs, vblob, cell_blob, cell_lens), tree

    # -- sequence protocol (chunked receive slices in row ranges) --

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, item):
        if not isinstance(item, slice):
            raise TypeError("PackedReceive supports slice access only")
        a, b, step = item.indices(self.n)
        if step != 1:
            raise ValueError("PackedReceive slices must be contiguous")
        if a == 0 and b == self.n:
            return self
        child = PackedReceive(
            b - a, self.ts_slab[a * TS_WIDTH : b * TS_WIDTH], self.cells,
            self.cell_id[a:b], self.vkinds[a:b], self.ivals[a:b],
            self.dvals[a:b], self.vlens[a:b], self.voffs[a:b], self.vblob,
            self.cell_blob, self.cell_lens,
        )
        if self._parsed is not None:
            # All four parse outputs are per-row arrays: slicing them is
            # exact, and saves chunked receive a native re-parse per
            # chunk (the worker already parsed the full slab for HLC).
            child._parsed = tuple(arr[a:b] for arr in self._parsed)
        return child

    # -- columns --

    def parse_timestamps(self):
        """→ (millis i64, counter i32, node u64, case_ok bool) for the
        whole batch — one native call over the slab (numpy fallback via
        the string path). Raises TimestampParseError exactly like the
        scalar parser. Cached (the HLC fold and the planner both need
        it)."""
        if self._parsed is None:
            from evolu_tpu_torch.ops.host_parse import (
                parse_packed_timestamps,
                parse_timestamp_strings,
            )

            out = parse_packed_timestamps(
                self.ts_slab, self.n, with_case=True, strict=False
            )
            if out is None:  # no host library: go through strings
                out = parse_timestamp_strings(
                    self.timestamp_strings(), with_case=True
                )
            self._parsed = out
        return self._parsed

    def timestamp_strings(self) -> List[str]:
        s = self.ts_slab.decode("ascii")
        return [s[i * TS_WIDTH : (i + 1) * TS_WIDTH] for i in range(self.n)]

    def value(self, i: int):
        kind = int(self.vkinds[i])
        if kind == 1:
            return int(self.ivals[i])
        if kind == 2:
            return float(self.dvals[i])
        if kind == 3:
            off = int(self.voffs[i])
            return self.vblob[off : off + int(self.vlens[i])].decode("utf-8")
        return None

    def touched_cells(self):
        """→ (touched_ids, cells): the unique cell ids this batch
        actually references (a slice may touch only part of `cells`)
        and their (table,row,column) tuples, aligned."""
        touched_ids = np.unique(self.cell_id)
        return touched_ids, [self.cells[int(i)] for i in touched_ids]

    # -- exact materialization (fallback paths) --

    def to_messages(self) -> Tuple[CrdtMessage, ...]:
        ts = self.timestamp_strings()
        cells = self.cells
        cid = self.cell_id
        return tuple(
            CrdtMessage(ts[i], *cells[int(cid[i])], self.value(i))
            for i in range(self.n)
        )
