"""Device-resident per-cell winner cache.

Without it, each batch streams its stored winners out of SQLite
(`storage.apply.fetch_existing_winners`) and ships them to the card as
the `ex_k1/ex_k2` columns. With it, the per-cell winner table lives in
device memory across batches: one pass gathers the stored winners from
the slot arrays, plans the batch (kernel L twice), hashes the xor rows
(kernel H), folds the Merkle minutes (kernel X) and scatters the updated
winners back in place. SQLite stays the durable store it always was.

Coherence contract (the same as `evolu_tpu.ops.winner_cache`):
- SQLite is the source of truth. A cell's slot is seeded lazily, from
  one batched SQLite read for all of a batch's new cells; after that the
  scatter keeps the slot equal to SQLite's `MAX(timestamp)` for the
  cell, because every apply goes through `plan_batch`.
- The scatter runs at plan time, inside the caller's transaction. If the
  transaction fails, the cache is ahead of SQLite, so
  `on_transaction_failed()` (fired by `storage.apply.apply_messages`)
  drops everything and the next batch re-seeds.
- Non-canonical hex case (in messages or stored winners) cannot be
  ordered by numeric keys; such batches take the host oracle planner and
  every touched cell is invalidated.
- Typed CRDT cells keep slot == MAX(timestamp) unchanged: the slot feeds
  the timestamp-only xor/Merkle algebra; typed merge state lives in
  SQLite.
- A second connection writing the same database would strand stale
  winners, so every `plan_batch` reads `PRAGMA data_version`, which
  moves if and only if another connection changed the file, and resets
  the cache when it moved.

Memory: two int64 tensors (u64 bit patterns) of `capacity + 1` rows,
16 bytes a cell, capacity a power of two grown by doubling. The last row
is the dump slot that no cell owns: the scatter sends every row that is
not a cell's last (and every padding row) there, in place of JAX's
out-of-range `mode="drop"`, which `index_put_` does not have. Growth
copies only `[:capacity]`, and the audit never reads the dump row.
Invalidated cells release their slots to a free list; a reused slot is
always rewritten (winner or zeros), so it cannot leak a previous cell's
keys.

The gate's and seeding's decisions (`_slots`, `_free`, the EWMA) are
host data and never read the device; each cached batch moves its seven
outputs to the host in one wave.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.ops import bucket_size, columns_to_device, resolve_device, to_host_many
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.encode import pack_ts_key_host, unpack_ts_keys
from evolu_tpu_torch.ops.host_parse import intern_cells, parse_timestamp_strings
from evolu_tpu_torch.ops.merge import (
    PlannedBatch,
    _host_fallback,
    pad_columns,
    plan_batch_device_full,
    plan_merge_sorted_core,
    select_messages,
    unpermute_masks,
    winner_key_columns,
)
from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas, owner_minute_segments
from evolu_tpu_torch.storage.apply import fetch_existing_winners

Cell = Tuple[str, str, str]


def cached_plan(w1, w2, slots, cell_id, k1, k2):
    """Gather the stored winners from the slot arrays, plan, hash, fold
    the minutes, and scatter the updated winners back into `w1`/`w2` in
    place. Padding rows carry slot 0; their gathered value is dead (the
    pad cell masks it) and their scatter target is the dump row. →
    (xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid_sorted)."""
    xor_s, upsert_s, i_s, s1, s2, (slots_s,), (win1, win2, seg_end, real) = plan_merge_sorted_core(
        cell_id, k1, k2, w1[slots], w2[slots], extras=(slots,), return_winners=True
    )
    millis_s, _ = unpack_ts_keys(s1)
    hashes, _ = masked_key_hashes(s1, s2, xor_s)
    _, minute_sorted, m_seg_end, seg_xor, valid_sorted = owner_minute_segments(
        torch.zeros_like(hashes), millis_s, hashes, xor_s
    )
    # Each real cell has exactly one seg_end row and distinct cells own
    # distinct slots, so only the dump row receives duplicate writes.
    tgt = torch.where(seg_end & real, slots_s, w1.shape[0] - 1)
    w1.index_put_((tgt,), win1)
    w2.index_put_((tgt,), win2)
    return xor_s, upsert_s, i_s, minute_sorted, m_seg_end, seg_xor, valid_sorted


def seed_slots(w1, w2, idx, v1, v2) -> None:
    """Write seed winners into their slots, in place."""
    w1.index_put_((idx,), v1)
    w2.index_put_((idx,), v2)


def grow_slots(w, new_cap: int):
    """A slot array of `new_cap` slots (plus the dump row) holding `w`'s
    slots, zeros above them."""
    out = torch.zeros(new_cap + 1, dtype=w.dtype, device=w.device)
    out[: w.shape[0] - 1] = w[:-1]
    return out


class DeviceWinnerCache:
    """Keeps the (k1, k2) winner keys of each cell in device memory
    across batches. `plan_batch` has the planner contract of
    `storage.apply.apply_messages` and advertises `fetches_winners =
    False`: apply skips its SQLite winner read and the cache seeds its
    misses itself. `device` None means CUDA (raises without a card)."""

    fetches_winners = False

    # Adaptive gate: when a batch's new-cell rate is high, the seed pass
    # makes the cache lose to streaming winners from SQLite; with a
    # steady population it wins. An EWMA of the per-batch seed rate
    # drives a hysteresis: above `seed_hi` the planner streams (cache
    # dropped, membership tracked on the host only); below `seed_lo` it
    # warms the cache back up. With new weight 0.8 it returns to cached
    # mode about two clean batches after a churn burst; a workload that
    # churns a quarter of its cells every batch stays inside the band.
    seed_hi = 0.30
    seed_lo = 0.10
    _EWMA_NEW_WEIGHT = 0.8
    _KNOWN_CAP = 1 << 20  # bound on the streaming-mode membership estimator

    def __init__(
        self,
        db,
        capacity: int = 1 << 15,
        adaptive: bool = True,
        max_slots: "int | None" = 1 << 22,
        device=None,
    ):
        self._db = db
        self.device = resolve_device(device)
        self._slots: Dict[Cell, int] = {}
        self._free: List[int] = []  # invalidated slots, reused first
        self._next_slot = 0
        # Device-memory bound: the cache never grows past `max_slots`
        # (2^22 cells = 64 MiB of keys). Overflow evicts by drop and
        # reseed: eviction is invalidation, which the coherence protocol
        # already supports, so a capped cache never serves a stale winner.
        self.max_slots = max_slots
        if max_slots is not None:
            capacity = min(capacity, bucket_size(max_slots))
        self.capacity = capacity
        self.adaptive = adaptive  # False = always cached
        self._seed_ewma = 0.0
        self._streaming = False
        self._known: set = set()  # membership estimator while streaming
        # The first batch after a reset re-seeds every cell it touches;
        # that 1.0 rate is recovery, not churn, and is skipped once. Only
        # once per run of resets: under repeated resets the sustained
        # 1.0 rates are the workload's signal and must reach the EWMA.
        self._skip_ewma_once = False
        self._ewma_suppressed = False
        # What the reference counts as evolu_winner_cache_* metrics, the
        # batches planned on each route (`<route>_plans`), and the route
        # of the last batch ("cached", "stream" or "host").
        self.counts: Counter = Counter()
        self.last_route = None
        self._data_version = self._read_data_version()
        self._alloc_slot_arrays()

    def _alloc_slot_arrays(self) -> None:
        self._w1 = torch.zeros(self.capacity + 1, dtype=torch.int64, device=self.device)
        self._w2 = torch.zeros(self.capacity + 1, dtype=torch.int64, device=self.device)

    def slot_values(self) -> Tuple[np.ndarray, np.ndarray]:
        """Both slot arrays on the host as np.uint64, the dump row cut."""
        w1, w2 = to_host_many(self._w1[: self.capacity], self._w2[: self.capacity])
        return w1.view(np.uint64), w2.view(np.uint64)

    def _read_data_version(self):
        try:
            rows = self._db.exec_sql_query("PRAGMA data_version", ())
            return next(iter(rows[0].values())) if rows else None
        except Exception:  # noqa: BLE001 - a backend without PRAGMA
            # support degrades to the documented single-writer contract
            return None

    def _drop_if_foreign_write(self) -> None:
        version = self._read_data_version()
        if version != self._data_version:
            self._data_version = version
            if self._slots or self._free:
                self.counts["foreign_write_drops"] += 1
                self.reset()

    # -- slot management --

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap != self.capacity:
            self._w1 = grow_slots(self._w1, new_cap)
            self._w2 = grow_slots(self._w2, new_cap)
            self.capacity = new_cap
            self.counts["grows"] += 1

    def _seed_new_cells(self, new_cells: List[Cell]) -> bool:
        """Assign slots to first-seen cells (freed slots first) and load
        their winners from SQLite in one batched read. Every assigned
        slot is written, winner keys or zeros. Returns False when a seed
        winner is non-canonical (the caller takes the host path; the
        cells stay unassigned)."""
        winners = fetch_existing_winners(self._db, new_cells)
        v1, v2, canonical = winner_key_columns(new_cells, winners)
        if not canonical:
            self.counts["noncanonical_seeds"] += 1
            return False
        n = len(new_cells)
        self.counts["seeded_cells"] += n
        reused = min(len(self._free), n)
        self._grow_to(self._next_slot + n - reused)
        idx = np.empty(n, np.int64)
        for j, c in enumerate(new_cells):
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._next_slot
                self._next_slot += 1
            idx[j] = self._slots[c] = slot
        cols = columns_to_device({"idx": idx, "k1": v1, "k2": v2}, self.device)
        seed_slots(self._w1, self._w2, cols["idx"], cols["k1"], cols["k2"])
        return True

    def _enforce_capacity(self, cells, new_cells):
        """The `max_slots` cap, between the gate and seeding: if this
        batch's seeds would push the live slot count past the cap, drop
        the whole cache and reseed just this batch's cells. Returns the
        (possibly replaced) new_cells, or None when this batch alone
        exceeds the cap: the caller then plans it with streamed winners."""
        if self.max_slots is None or not new_cells:
            return new_cells
        if len(self._slots) + len(new_cells) <= self.max_slots:
            return new_cells
        self.counts["evictions"] += 1
        self.reset()
        if len(cells) > self.max_slots:
            return None
        return list(cells)

    def invalidate(self, cells) -> None:
        for c in cells:
            slot = self._slots.pop(c, None)
            if slot is not None:
                self._free.append(slot)
                self.counts["invalidated_cells"] += 1

    def reset(self) -> None:
        self.counts["resets"] += 1
        self._slots.clear()
        self._free.clear()
        self._next_slot = 0
        # Streaming mode measures churn against the carried-over _known,
        # so no re-seed artifact exists there; and never skip twice in a
        # row (consecutive resets are the workload).
        self._skip_ewma_once = not self._streaming and not self._ewma_suppressed
        self._alloc_slot_arrays()

    def on_transaction_failed(self) -> None:
        """The plan-time scatter already advanced the cache; a rolled-back
        transaction leaves SQLite behind it, so drop everything."""
        self.reset()

    # -- the planner --

    def _adaptive_gate(self, cells):
        """The EWMA and streaming hysteresis. Updates the EWMA and the
        mode; → (mode, new_cells): "stream" = plan with SQLite-streamed
        winners (cache dropped on entry), "cached" = seed `new_cells`,
        then plan from the slot arrays."""
        if not self.adaptive and self._streaming:
            # The gate was turned off while streaming: leave streaming
            # mode so the cached path reseeds from SQLite.
            self._streaming = False
            self._known = set()
        known = self._known if self._streaming else self._slots
        new_cells = [c for c in cells if c not in known]
        rate = len(new_cells) / len(cells)
        if self._skip_ewma_once:
            self._skip_ewma_once = False
            self._ewma_suppressed = True
        else:
            self._seed_ewma = (
                (1 - self._EWMA_NEW_WEIGHT) * self._seed_ewma + self._EWMA_NEW_WEIGHT * rate
            )
            self._ewma_suppressed = False
        if not self.adaptive:
            return "cached", new_cells
        if self._streaming:
            # Sustained churn would grow the estimator forever: on
            # overflow restart it from this batch.
            if len(self._known) > self._KNOWN_CAP:
                self._known = set(cells)
            else:
                self._known.update(cells)
            if self._seed_ewma > self.seed_lo:
                return "stream", new_cells
            # Churn subsided: warm the cache back up this batch.
            self._streaming = False
            self._known = set()
            self.counts["switches_to_cached"] += 1
            return "cached", [c for c in cells if c not in self._slots]
        if self._seed_ewma > self.seed_hi:
            # Seeding dominates: drop the cache (it stops being
            # maintained) and stream until the EWMA decays under seed_lo.
            self._streaming = True
            self._known = set(self._slots)
            self._known.update(cells)
            self.reset()  # arms no EWMA skip: _streaming is set
            self.counts["switches_to_stream"] += 1
            return "stream", new_cells
        return "cached", new_cells

    def _took(self, route: str) -> None:
        self.last_route = route
        self.counts[route + "_plans"] += 1

    def plan_batch(self, messages: Sequence[CrdtMessage], existing_winners=None):
        """Planner with the `plan_batch_device_full` contract
        ((xor_mask, upserts, deltas) and the positional upsert mask),
        winners sourced from the slot arrays instead of
        `existing_winners` (which apply passes as {})."""
        n = len(messages)
        if n == 0:
            return PlannedBatch([], [], {}, np.zeros(0, bool))
        self._drop_if_foreign_write()
        millis, counter, node, case_ok = parse_timestamp_strings(
            [m.timestamp for m in messages], with_case=True
        )
        cell_ids, cells = intern_cells(
            [m.table for m in messages], [m.row for m in messages], [m.column for m in messages],
        )
        if not bool(case_ok.all()):
            return self._host_fallback(messages, cells)
        mode, new_cells = self._adaptive_gate(cells)
        if mode == "cached":
            new_cells = self._enforce_capacity(cells, new_cells)
        if mode == "stream" or new_cells is None:
            return self._plan_streamed(messages, cells, cell_ids, millis, counter, node)
        if new_cells and not self._seed_new_cells(new_cells):
            return self._host_fallback(messages, cells)
        self.counts["hits"] += len(cells) - len(new_cells)
        self.counts["misses"] += len(new_cells)
        self._took("cached")
        slot_of = np.fromiter((self._slots[c] for c in cells), np.int64, len(cells))
        xor_mask, upsert_mask, deltas = self._run_cached_plan(
            cell_ids, slot_of[cell_ids], millis, counter, node, n
        )
        return PlannedBatch(
            xor_mask.tolist(), select_messages(messages, upsert_mask), deltas, upsert_mask,
        )

    def _run_cached_plan(self, cell_ids, slots, millis, counter, node, n):
        """pad → `cached_plan` → one-wave pull → unpermute → delta
        decode. → (xor_mask, upsert_mask, deltas), masks in batch order."""
        k1 = pack_ts_key_host(millis, counter)
        (cell_p, slots_p, k1_p, k2_p), size = pad_columns([cell_ids, slots, k1, node], n)
        cols = columns_to_device({"cell_id": cell_p, "slots": slots_p, "k1": k1_p, "k2": k2_p},
                                 self.device)
        outs = cached_plan(self._w1, self._w2, cols["slots"], cols["cell_id"], cols["k1"], cols["k2"])
        xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid = to_host_many(*outs)
        xor_mask, upsert_mask = unpermute_masks(xor_s, upsert_s, i_s)
        deltas = decode_owner_minute_deltas(
            np.zeros(size, np.int32), minute_sorted, seg_end, seg_xor, valid
        ).get(0, {})
        return xor_mask[:n], upsert_mask[:n], deltas

    def plan_packed(self, pb):
        """The packed twin of `plan_batch` for a `PackedReceive`: the
        columns come straight from the C decrypt (timestamps parsed once
        over the 46-wide slab, cells already interned), and the result
        is positional numpy masks `(xor_mask, upsert_mask, deltas)` for
        the packed SQLite apply, so no upsert message list is built.

        None when the batch must take the object path instead:
        non-canonical hex case in the batch (checked before any EWMA or
        cache change, so the re-route through `plan_batch` keeps the
        gate's state equal to an object-only flow), or a non-canonical
        stored winner seed (`_skip_ewma_once` is armed before that
        bounce, so the re-entered gate does not sample the EWMA twice
        for one batch)."""
        n = pb.n
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, bool), {}
        self._drop_if_foreign_write()
        millis, counter, node, case_ok = pb.parse_timestamps()
        if not bool(case_ok.all()):
            return None
        # A slice shares the whole batch's interned cells; only the ids
        # this chunk touches get slots and seeds.
        touched_ids, cells = pb.touched_cells()
        mode, new_cells = self._adaptive_gate(cells)
        if mode == "cached":
            new_cells = self._enforce_capacity(cells, new_cells)
        if mode == "stream" or new_cells is None:
            from evolu_tpu_torch.ops.merge import plan_packed_streamed

            plan = plan_packed_streamed(self._db, pb, millis, counter, node, cells, touched_ids,
                                        self.device)
            if plan is not None:
                self.counts["streamed_cells"] += len(cells)
                self._took("stream")
            return plan
        if new_cells and not self._seed_new_cells(new_cells):
            self._skip_ewma_once = True
            return None  # non-canonical stored winner: the object path
        self.counts["hits"] += len(cells) - len(new_cells)
        self.counts["misses"] += len(new_cells)
        self._took("cached")
        slot_arr = np.zeros(len(pb.cells), np.int64)
        slot_arr[touched_ids] = [self._slots[c] for c in cells]
        return self._run_cached_plan(pb.cell_id, slot_arr[pb.cell_id], millis, counter, node, n)

    def _plan_streamed(self, messages, cells, cell_ids, millis, counter, node):
        """High-churn mode: winners streamed from SQLite, no cache state
        touched (it was dropped on entry). The end state equals the
        cached route's; only the winner source differs. The parsed
        columns are reused."""
        winners = fetch_existing_winners(self._db, cells)
        ex1_u, ex2_u, canonical = winner_key_columns(cells, winners)
        if not canonical:
            return self._host_fallback(messages, cells)
        self.counts["streamed_cells"] += len(cells)
        self._took("stream")
        cols = (cell_ids, pack_ts_key_host(millis, counter), node, ex1_u[cell_ids],
                ex2_u[cell_ids], millis, counter, node, True)
        return plan_batch_device_full(messages, {}, cols=cols, device=self.device)

    def _host_fallback(self, messages, cells):
        """Non-canonical hex case: invalidate every touched cell (their
        SQLite winners may now be non-canonical, which the numeric cache
        cannot hold), then plan on the host."""
        self.counts["host_fallbacks"] += 1
        self._took("host")
        self.invalidate(cells)
        existing = fetch_existing_winners(self._db, cells)
        return _host_fallback(messages, existing, with_deltas=True)

    # -- the invariant audit --

    def verify_against_db(self, sample: "int | None" = None) -> int:
        """Every live slot's (k1, k2) must equal SQLite's MAX(timestamp)
        for its cell, read back from the slot arrays themselves. Streaming
        mode holds no slots, so the audit is vacuous there by design. →
        the number of cells checked; raises AssertionError naming the
        first divergent cells. `sample` caps the audit to the first N
        cells."""
        cells = list(self._slots)
        if sample is not None:
            cells = cells[: int(sample)]
        if not cells:
            return 0
        winners = fetch_existing_winners(self._db, cells)
        v1, v2, canonical = winner_key_columns(cells, winners)
        if not canonical:
            raise AssertionError(
                "non-canonical stored winner occupies a cache slot "
                "(the host-fallback invalidation contract is broken)"
            )
        # Gather only the audited slots on the card; pull both in one wave.
        idx = torch.from_numpy(
            np.fromiter((self._slots[c] for c in cells), np.int64, len(cells))
        ).to(self.device)
        w1, w2 = (a.view(np.uint64) for a in to_host_many(self._w1[idx], self._w2[idx]))
        bad = []
        for j, c in enumerate(cells):
            if w1[j] != v1[j] or w2[j] != v2[j]:
                bad.append((c, int(w1[j]), int(v1[j])))
                if len(bad) >= 5:
                    break
        if bad:
            raise AssertionError(f"winner cache != MAX(timestamp) for {len(bad)}+ cells: {bad}")
        return len(cells)
