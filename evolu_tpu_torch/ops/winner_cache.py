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
from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.ops import bucket_size, columns_to_device, resolve_device, to_host_many
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.cuda_lib import device_work
from evolu_tpu_torch.ops.encode import pack_ts_key_host, unpack_ts_keys
from evolu_tpu_torch.ops.host_parse import intern_cells, parse_timestamp_strings
from evolu_tpu_torch.ops.merge import (
    _PAD_CELL,
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


# `counts` key → its `evolu_winner_cache_*` metric and labels.
_TALLY_METRICS = {
    "foreign_write_drops": ("evolu_winner_cache_foreign_write_drops_total", {}),
    "grows": ("evolu_winner_cache_grows_total", {}),
    "noncanonical_seeds": ("evolu_winner_cache_noncanonical_seeds_total", {}),
    "seeded_cells": ("evolu_winner_cache_seeded_cells_total", {}),
    "evictions": ("evolu_winner_cache_evictions_total", {}),
    "invalidated_cells": ("evolu_winner_cache_invalidated_cells_total", {}),
    "resets": ("evolu_winner_cache_resets_total", {}),
    "switches_to_cached": ("evolu_winner_cache_mode_switches_total", {"to": "cached"}),
    "switches_to_stream": ("evolu_winner_cache_mode_switches_total", {"to": "stream"}),
    "hits": ("evolu_winner_cache_hits_total", {}),
    "misses": ("evolu_winner_cache_misses_total", {}),
    "streamed_cells": ("evolu_winner_cache_streamed_cells_total", {}),
    "host_fallbacks": ("evolu_winner_cache_host_fallbacks_total", {}),
}


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
        # The evolu_winner_cache_* events (`_tally` records both), the
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
            if self._has_slot_state():
                self._tally("foreign_write_drops")
                self.reset()

    def _has_slot_state(self) -> bool:
        return bool(self._slots or self._free)

    # -- slot management --

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap != self.capacity:
            self._w1 = grow_slots(self._w1, new_cap)
            self._w2 = grow_slots(self._w2, new_cap)
            self.capacity = new_cap
            self._tally("grows")

    def _seed_new_cells(self, new_cells: List[Cell]) -> bool:
        """Assign slots to first-seen cells (freed slots first) and load
        their winners from SQLite in one batched read. Every assigned
        slot is written, winner keys or zeros. Returns False when a seed
        winner is non-canonical (the caller takes the host path; the
        cells stay unassigned)."""
        winners = fetch_existing_winners(self._db, new_cells)
        v1, v2, canonical = winner_key_columns(new_cells, winners)
        if not canonical:
            self._tally("noncanonical_seeds")
            return False
        self._tally("seeded_cells", len(new_cells))
        self._assign_and_write_seeds(new_cells, v1, v2)
        return True

    def _assign_and_write_seeds(self, new_cells: List[Cell], v1: np.ndarray, v2: np.ndarray) -> None:
        """Give each new cell a slot (freed slots first) and write its
        seed winner keys there."""
        n = len(new_cells)
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
        self._tally("evictions")
        self.reset()
        if len(cells) > self.max_slots:
            return None
        return list(cells)

    def invalidate(self, cells) -> None:
        for c in cells:
            slot = self._slots.pop(c, None)
            if slot is not None:
                self._free.append(slot)
                self._tally("invalidated_cells")

    def reset(self) -> None:
        self._tally("resets")
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
            self._tally("switches_to_cached")
            return "cached", [c for c in cells if c not in self._slots]
        if self._seed_ewma > self.seed_hi:
            # Seeding dominates: drop the cache (it stops being
            # maintained) and stream until the EWMA decays under seed_lo.
            self._streaming = True
            self._known = set(self._slots)
            self._known.update(cells)
            self.reset()  # arms no EWMA skip: _streaming is set
            self._tally("switches_to_stream")
            return "stream", new_cells
        return "cached", new_cells

    def _tally(self, key: str, n: int = 1) -> None:
        """Count an event in `counts` and in its `evolu_winner_cache_*`
        metric family (the reference's names)."""
        self.counts[key] += n
        name, labels = _TALLY_METRICS[key]
        metrics.inc(name, n, **labels)
        if key == "grows":
            metrics.set_gauge("evolu_winner_cache_capacity_slots", self.capacity)

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
        self._tally("hits", len(cells) - len(new_cells))
        self._tally("misses", len(new_cells))
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
                self._tally("streamed_cells", len(cells))
                self._took("stream")
            return plan
        if new_cells and not self._seed_new_cells(new_cells):
            self._skip_ewma_once = True
            return None  # non-canonical stored winner: the object path
        self._tally("hits", len(cells) - len(new_cells))
        self._tally("misses", len(new_cells))
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
        self._tally("streamed_cells", len(cells))
        self._took("stream")
        cols = (cell_ids, pack_ts_key_host(millis, counter), node, ex1_u[cell_ids],
                ex2_u[cell_ids], millis, counter, node, True)
        return plan_batch_device_full(messages, {}, cols=cols, device=self.device)

    def _host_fallback(self, messages, cells):
        """Non-canonical hex case: invalidate every touched cell (their
        SQLite winners may now be non-canonical, which the numeric cache
        cannot hold), then plan on the host."""
        self._tally("host_fallbacks")
        self._took("host")
        self.invalidate(cells)
        existing = fetch_existing_winners(self._db, cells)
        return _host_fallback(messages, existing, with_deltas=True)

    # -- the invariant audit --

    def _gather_slot_values(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The keys of `slots`, gathered on the card and pulled in one
        wave, as np.uint64."""
        idx = torch.from_numpy(slots).to(self.device)
        w1, w2 = to_host_many(self._w1[idx], self._w2[idx])
        return w1.view(np.uint64), w2.view(np.uint64)

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
        w1, w2 = self._gather_slot_values(np.fromiter((self._slots[c] for c in cells), np.int64, len(cells)))
        bad = []
        for j, c in enumerate(cells):
            if w1[j] != v1[j] or w2[j] != v2[j]:
                bad.append((c, int(w1[j]), int(v1[j])))
                if len(bad) >= 5:
                    break
        if bad:
            raise AssertionError(f"winner cache != MAX(timestamp) for {len(bad)}+ cells: {bad}")
        return len(cells)


class MeshShardedWinnerCache(DeviceWinnerCache):
    """The winner store sharded over a mesh (`parallel.mesh.MeshContext`):
    one pair of slot tensors a shard, each on its shard's device, each
    `capacity` slots plus its own dump row. A cell lives on a stable shard
    (`owner_shard` of its interned key), and a batch's plan runs on every
    shard at once: each shard gathers, plans, hashes, folds and scatters
    the cells it owns from its own slots (kernel L twice, H and X a
    shard), and the per-shard (minute, xor) partials XOR-merge in the
    host decoder, the cross-shard reduction of the Merkle deltas.

    Coherence is the base contract, per shard: every live slot equals
    SQLite's MAX(timestamp) for its cell (`verify_against_db` audits
    through per-shard gathers), and the invalidation, reset and
    foreign-write hooks are the base's. Slot ids are `local * n_shards +
    shard`, so growing the per-shard capacity never rewrites an assigned
    id. Pad rows target each shard's dump row. `device` defaults to the
    mesh's first shard (the streamed route and host fallbacks run there)."""

    def __init__(
        self,
        db,
        mesh_ctx=None,
        capacity: int = 1 << 12,
        adaptive: bool = True,
        max_slots: "int | None" = 1 << 22,
        device=None,
    ):
        from evolu_tpu_torch.parallel.mesh import MeshContext

        self.ctx = mesh_ctx if mesh_ctx is not None else MeshContext()
        self.n_shards = self.ctx.n_shards
        self._free_by_shard: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._next_by_shard: List[int] = [0] * self.n_shards
        super().__init__(db, capacity=capacity, adaptive=adaptive, max_slots=max_slots,
                         device=self.ctx.mesh.devices[0] if device is None else device)

    # -- placement --

    def _cell_shard(self, cell: Cell) -> int:
        from evolu_tpu_torch.parallel.mesh import owner_shard

        return owner_shard("\x00".join(cell), self.n_shards)

    def shard_slot_counts(self) -> List[int]:
        """Live slots a shard."""
        counts = [0] * self.n_shards
        for slot in self._slots.values():
            counts[slot % self.n_shards] += 1
        return counts

    # -- slot arrays --

    def _alloc_slot_arrays(self) -> None:
        devices = self.ctx.mesh.devices
        self._w1 = [torch.zeros(self.capacity + 1, dtype=torch.int64, device=d) for d in devices]
        self._w2 = [torch.zeros(self.capacity + 1, dtype=torch.int64, device=d) for d in devices]

    def slot_values(self) -> Tuple[np.ndarray, np.ndarray]:
        """Both slot arrays on the host as (n_shards, capacity) np.uint64,
        the dump rows cut."""
        cap = self.capacity
        flat = to_host_many(*(w[:cap] for w in self._w1), *(w[:cap] for w in self._w2))
        ns = self.n_shards
        return (np.stack(flat[:ns]).view(np.uint64), np.stack(flat[ns:]).view(np.uint64))

    def _has_slot_state(self) -> bool:
        return bool(self._slots) or any(self._free_by_shard)

    def _grow_to(self, needed: int) -> None:
        """Grow the per-shard capacity by doubling."""
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap != self.capacity:
            self._w1 = [grow_slots(w, new_cap) for w in self._w1]
            self._w2 = [grow_slots(w, new_cap) for w in self._w2]
            self.capacity = new_cap
            self._tally("grows")

    def _assign_and_write_seeds(self, new_cells: List[Cell], v1: np.ndarray, v2: np.ndarray) -> None:
        """Per-shard slots: each new cell takes a freed slot of its shard,
        else the shard's next one, and each shard writes its seeds into its
        own slot tensors."""
        ns = self.n_shards
        by_shard: List[List[int]] = [[] for _ in range(ns)]
        for j, c in enumerate(new_cells):
            by_shard[self._cell_shard(c)].append(j)
        need = self.capacity
        for si, js in enumerate(by_shard):
            need = max(need, self._next_by_shard[si] + max(len(js) - len(self._free_by_shard[si]), 0))
        self._grow_to(need)
        for si, js in enumerate(by_shard):
            if not js:
                continue
            idx = np.empty(len(js), np.int64)
            for k, j in enumerate(js):
                if self._free_by_shard[si]:
                    local = self._free_by_shard[si].pop()
                else:
                    local = self._next_by_shard[si]
                    self._next_by_shard[si] += 1
                self._slots[new_cells[j]] = local * ns + si
                idx[k] = local
            cols = columns_to_device({"idx": idx, "k1": v1[js], "k2": v2[js]}, self.ctx.mesh.devices[si])
            seed_slots(self._w1[si], self._w2[si], cols["idx"], cols["k1"], cols["k2"])

    def invalidate(self, cells) -> None:
        for c in cells:
            slot = self._slots.pop(c, None)
            if slot is not None:
                self._free_by_shard[slot % self.n_shards].append(slot // self.n_shards)
                self._tally("invalidated_cells")

    def reset(self) -> None:
        super().reset()
        self._free_by_shard = [[] for _ in range(self.n_shards)]
        self._next_by_shard = [0] * self.n_shards

    # -- the sharded plan pass --

    def _run_cached_plan(self, cell_ids, slots, millis, counter, node, n):
        """Route each row to the shard holding its cell's slot (same-cell
        rows co-locate, and the stable routing keeps them in batch order
        within a shard: the planner's idx tiebreak), pad every shard to
        one power-of-two bucket, run `cached_plan` on every shard, pull
        all shards in one wave, unpermute per shard block and map back
        through the routing. → (xor_mask, upsert_mask, deltas) in batch
        order, equal to the one-device cache's."""
        k1 = pack_ts_key_host(millis, counter)
        ns = self.n_shards
        shard = (slots % ns).astype(np.int64)
        local = (slots // ns).astype(np.int64)
        loads = np.bincount(shard, minlength=ns)
        size = bucket_size(max(int(loads.max(initial=0)), 1))
        total = ns * size
        cell_p = np.full(total, int(_PAD_CELL), np.int32)
        slots_p = np.zeros(total, np.int64)
        k1_p = np.zeros(total, np.uint64)
        k2_p = np.zeros(total, np.uint64)
        order = np.argsort(shard, kind="stable")
        offs = np.zeros(ns + 1, np.int64)
        offs[1:] = np.cumsum(loads)
        pos_in_shard = np.empty(n, np.int64)
        pos_in_shard[order] = np.arange(n, dtype=np.int64) - offs[shard[order]]
        dest = shard * size + pos_in_shard
        cell_p[dest] = cell_ids
        slots_p[dest] = local
        k1_p[dest] = k1
        k2_p[dest] = node
        self.ctx.record_occupancy(loads.tolist(), size)
        self.ctx.record_xdev_reduce("winner_minute_partials")
        outs = []
        with device_work("a sharded winner-cache plan"):
            for si, dev in enumerate(self.ctx.mesh.devices):
                sl = slice(si * size, (si + 1) * size)
                cols = columns_to_device({"cell_id": cell_p[sl], "slots": slots_p[sl], "k1": k1_p[sl],
                                          "k2": k2_p[sl]}, dev)
                outs.append(cached_plan(self._w1[si], self._w2[si], cols["slots"], cols["cell_id"],
                                        cols["k1"], cols["k2"]))
            flat = to_host_many(*(x for o in outs for x in o))
        xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid = (
            np.concatenate(flat[k::7]) for k in range(7))
        xor_flat, upsert_flat = unpermute_masks(xor_s, upsert_s, i_s, block_size=size)
        deltas = decode_owner_minute_deltas(
            np.zeros(total, np.int32), minute_sorted, seg_end, seg_xor, valid
        ).get(0, {})
        return xor_flat[dest], upsert_flat[dest], deltas

    def _gather_slot_values(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The base audit's gather, shard by shard (slot id = local *
        n_shards + shard), pulled in one wave."""
        ns = self.n_shards
        rows = [np.nonzero(slots % ns == si)[0] for si in range(ns)]
        gathers = []
        for si, dev in enumerate(self.ctx.mesh.devices):
            idx = torch.from_numpy(slots[rows[si]] // ns).to(dev)
            gathers += [self._w1[si][idx], self._w2[si][idx]]
        pulled = to_host_many(*gathers)
        w1, w2 = np.empty(len(slots), np.uint64), np.empty(len(slots), np.uint64)
        for si in range(ns):
            w1[rows[si]] = pulled[2 * si].view(np.uint64)
            w2[rows[si]] = pulled[2 * si + 1].view(np.uint64)
        return w1, w2
