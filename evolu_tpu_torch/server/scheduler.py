"""Continuous-batching sync scheduler: live relay traffic fused into single
engine passes.

The port's copy of `evolu_tpu.server.scheduler`. Handler threads enqueue
decoded `SyncRequest`s onto a bounded queue and block on per-request
futures; one dispatcher thread closes a micro-batch on whichever comes
first of `max_batch` requests or the `max_wait_s` deadline, and runs ONE
engine pass (`BatchReconciler.run_batch_wire`: `start_batch` /
`finish_batch` on packed stores, kernels H and X on the card) whose wire
responses resolve the futures.

Why coalescing is sound (Merkle-CRDTs, arXiv 2004.00107): a response
depends only on the store's state and that one request, and owners are
independent, so a batch of DISTINCT-owner requests served in one pass
gives the same bytes as any sequential order of them. Same-owner
requests are not independent, so a batch never holds two requests of one
owner: the later one stays queued, FIFO within the owner, and rides the
next pass.

Robustness contract:
- queue full, or the scheduler stopping → `SchedulerQueueFull` (the relay
  answers 503 with `Retry-After`).
- a request with a non-canonical timestamp width never enters a batch
  (`_pack_rows` would refuse the whole batch): it dispatches alone
  through the per-request `serve_single_request`, still on the
  dispatcher thread, so every store write runs on one thread.
- a poisoned batch (an engine-pass failure; every shard transaction
  rolled back, nothing committed) is retried ONCE as singletons, so one
  bad request cannot fail its batchmates.
- a `KernelError` (a kernel that did not build or launch, or device work
  that failed) is no poison: it fails every member of the batch, with no
  singleton retry, so a fault of the card never hides behind the
  per-request path's host hashing. So does a failure to build the
  engine, which is not remembered: the next batch tries again.
- with a write-behind queue (`write_behind=`), a `WriteBehindFull` from the
  engine pass (raised before the log ACK, so nothing was served or
  persisted) is flow control, not poison: every member of the batch gets
  `SchedulerQueueFull` (503 + Retry-After), with no singleton retry; and
  the per-request path runs behind the queue's `drain_barrier()`, so it
  reads and writes committed state.
- `stop()` serves everything already queued in full-size batches, then
  rejects new submits.

Observability as the reference's: the `evolu_sched_*` metrics, a
`sched.queue` span a request under its own trace, `sched.single` for a
singleton dispatch, and one fan-in `engine.batch` span a pass that links
its requests' traces (the engine's `kernel:*` spans nest under it), and
the conservation ledger's `bounce.non_canonical` tally for a singleton
dispatch. Plain `counts` (batches, coalesced, singles, poison_retries,
poisoned_batches, rejected) are kept beside them.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from evolu_tpu_torch.obs import ledger, metrics, trace
from evolu_tpu_torch.ops import resolve_device
from evolu_tpu_torch.ops.cuda_lib import KernelError
from evolu_tpu_torch.sync import aead, protocol
from evolu_tpu_torch.sync.wire_scan import PackedMessages
from evolu_tpu_torch.utils.log import log


class SchedulerQueueFull(Exception):
    """Admission queue at capacity (or the scheduler stopping): the caller
    should answer 503 with `retry_after` seconds."""

    def __init__(self, retry_after: float):
        super().__init__(f"sync scheduler queue full; retry after {retry_after}s")
        self.retry_after = retry_after


def _write_behind_full_type():
    """The write-behind backpressure exception, imported when an except
    clause evaluates it: the scheduler imports no storage module up front."""
    from evolu_tpu_torch.storage.write_behind import WriteBehindFull

    return WriteBehindFull


class _Pending:
    """One enqueued request and its future. `single=True` marks a request
    the engine cannot batch: it dispatches alone, still on the dispatcher
    thread, so it can never join an engine transaction left open on the
    shared connection."""

    __slots__ = ("request", "single", "t_enqueue", "t_wall", "ctx",
                 "done", "response", "error")

    def __init__(self, request: protocol.SyncRequest, single: bool = False):
        self.request = request
        self.single = single
        self.t_enqueue = time.monotonic()
        self.t_wall = time.time()
        # The submitting handler thread's trace context: the dispatcher
        # records this request's queue-wait span under it and links it
        # from the batch span.
        self.ctx = trace.current()
        self.done = threading.Event()
        self.response: Optional[bytes] = None
        self.error: Optional[BaseException] = None

    def resolve(self, response: bytes) -> None:
        self.response = response
        self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.done.set()


def _batchable(request: protocol.SyncRequest) -> bool:
    """Only canonical 46-character timestamps may enter a packed engine
    batch; anything else takes the per-request path, whose host oracle is
    the error surface. Hex-case anomalies at canonical width stay
    batchable (the engine sends those owners to the host fold). Contents
    never count: the relay is E2EE-blind, and an `aead-batch-v1` record
    batches like an OpenPGP one. Packed messages are 46 wide by
    construction."""
    if isinstance(request.messages, PackedMessages):
        return True
    return all(len(m.timestamp) == 46 for m in request.messages)


class SyncScheduler:
    """Admission and dispatch between relay handler threads and one
    `BatchReconciler` on `device` (None = the card; raises here without
    one; "cpu" runs the plain versions of the kernels). `mesh_ctx` (a
    `parallel.mesh.MeshContext`) makes it the mesh-sharded engine;
    `mesh_engine=True` without one resolves the process-wide context
    (`get_mesh_context(default_config.mesh_devices)`: every visible card,
    or for a CPU scheduler one CPU shard) at the first batch.

    `submit(request)` blocks the calling thread until its wire response
    (the encoded SyncResponse, byte-identical to `serve_single_request`)
    is ready, and raises `SchedulerQueueFull` when the queue is full."""

    def __init__(
        self,
        store,
        engine=None,
        max_batch: int = 32,
        max_wait_s: float = 0.005,
        max_queue: int = 256,
        retry_after_s: float = 1.0,
        submit_timeout_s: float = 120.0,
        device=None,
        write_behind=None,
        mesh_ctx=None,
        mesh_engine: bool = False,
    ):
        # The mesh-sharded engine: an explicit MeshContext, or mesh_engine
        # to resolve the process-wide one lazily on the dispatcher thread
        # (`_ensure_engine`), so every scheduler of the process shares one
        # placement.
        self._mesh_ctx = mesh_ctx
        self._mesh_engine = bool(mesh_engine) or mesh_ctx is not None
        self.store = store
        self.device = engine.device if engine is not None else resolve_device(device)
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.retry_after_s = float(retry_after_s)
        self.submit_timeout_s = float(submit_timeout_s)
        self._engine = engine
        self._own_engine = engine is None
        self._write_behind = write_behind
        self.counts = dict.fromkeys(
            ("batches", "coalesced", "singles", "poison_retries", "poisoned_batches", "rejected"), 0)
        self._cv = threading.Condition()
        self._queue: List[_Pending] = []
        self._stopping = False
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True, name="evolu-sched")
        self._thread.start()

    def _count(self, key: str, n: int = 1) -> None:
        with self._cv:
            self.counts[key] += n

    # -- admission (handler threads) --

    def depth(self) -> int:
        """Current admission-queue occupancy (0..max_queue)."""
        with self._cv:
            return len(self._queue)

    def submit(self, request: protocol.SyncRequest) -> bytes:
        """Serve one request: coalesced into the next engine pass, or alone
        for shapes the engine cannot batch; either way on the dispatcher
        thread."""
        p = _Pending(request, single=not _batchable(request))
        with self._cv:
            if self._stopping or len(self._queue) >= self.max_queue:
                self.counts["rejected"] += 1
                metrics.inc("evolu_sched_rejected_total")
                raise SchedulerQueueFull(self.retry_after_s)
            self._queue.append(p)
            metrics.set_gauge("evolu_sched_queue_depth", len(self._queue))
            self._cv.notify()
        if not p.done.wait(self.submit_timeout_s):
            raise TimeoutError(
                f"sync scheduler did not serve the request within {self.submit_timeout_s}s")
        if p.error is not None:
            raise p.error
        return p.response  # type: ignore[return-value]

    # -- dispatch (one background thread) --

    def _dispatch_loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._queue and not self._stopping:
                        self._cv.wait()
                    if not self._queue:
                        return  # stopping and drained
                    # The deadline runs from the OLDEST pending request:
                    # requests that piled up during the previous pass close
                    # a batch at once (the pass is the coalescing window
                    # under load); max_wait_s only holds a lone request on
                    # an idle queue. stop() waives the wait.
                    deadline = self._queue[0].t_enqueue + self.max_wait_s
                    while len(self._queue) < self.max_batch and not self._stopping:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    batch = self._close_batch()
                    metrics.set_gauge("evolu_sched_queue_depth", len(self._queue))
                try:
                    self._run_batch(batch)
                except BaseException:
                    for p in batch:  # already popped: fail, don't hang
                        if not p.done.is_set():
                            p.fail(RuntimeError("sync scheduler dispatcher exited"))
                    raise
        finally:
            # If the loop died abnormally, blocked submitters must not hang
            # until their timeout.
            with self._cv:
                dead, self._queue = self._queue, []
                self._stopping = True
            for p in dead:
                p.fail(RuntimeError("sync scheduler dispatcher exited"))
            self._stopped.set()

    def _close_batch(self) -> List[_Pending]:
        """Pop the next dispatch, FIFO, under the lock. A `single` at the
        head dispatches alone; otherwise up to max_batch DISTINCT-owner
        batchable requests. Once anything of an owner is kept back (a
        second request of it, a single, or capacity), every later request
        of that owner is kept too: per-owner FIFO is never reordered."""
        if self._queue[0].single:
            return [self._queue.pop(0)]
        batch: List[_Pending] = []
        owners: set = set()
        keep: List[_Pending] = []
        blocked: set = set()
        for p in self._queue:
            uid = p.request.user_id
            if p.single or uid in owners or uid in blocked or len(batch) >= self.max_batch:
                blocked.add(uid)
                keep.append(p)
            else:
                owners.add(uid)
                batch.append(p)
        self._queue = keep
        return batch

    def _record_queue_waits(self, batch: List[_Pending]) -> float:
        """Per-request queue-wait spans (enqueue → batch close), under each
        request's own trace. Returns the dispatch instant (monotonic) the
        waits were measured against."""
        t_dispatch = time.monotonic()
        for p in batch:
            if p.ctx is not None:
                trace.record_span("sched.queue", p.ctx, p.t_wall,
                                  (t_dispatch - p.t_enqueue) * 1e3)
        return t_dispatch

    def _run_batch(self, batch: List[_Pending]) -> None:
        if not batch:
            return
        if batch[0].single:
            p = batch[0]
            self._count("singles")
            metrics.inc("evolu_sched_fallback_total", reason="non_canonical")
            # A ledger tally outside the flow equations: the request's
            # messages still end through the store path below.
            ledger.count(ledger.BOUNCE_NON_CANONICAL, len(p.request.messages), owner=p.request.user_id)
            self._record_queue_waits(batch)
            sspan = trace.start_span("sched.single", parent=p.ctx,
                                     attrs={"owner": p.request.user_id})
            try:
                with sspan, trace.use(sspan.context):
                    p.resolve(self._serve_single(p.request))
            except Exception as e:  # noqa: BLE001 - a per-request error
                p.fail(e)
            return
        t0 = time.perf_counter()
        self._count("batches")
        metrics.inc("evolu_sched_batches_total")
        metrics.observe("evolu_sched_batch_requests", len(batch),
                        buckets=metrics.COUNT_BUCKETS)
        self._record_queue_waits(batch)
        # The fan-in span: one engine pass serves N requests of N traces,
        # so the batch span LINKS them (a span has one trace). It is
        # recorded whenever any linked request is sampled, and GET
        # /trace/<request-id> finds it through the link index.
        links = [p.ctx for p in batch if p.ctx is not None]
        bspan = trace.start_span("engine.batch", links=links, attrs={
            "requests": len(batch),
            "owners": len({p.request.user_id for p in batch}),
        })
        try:
            engine = self._ensure_engine()
        except Exception as e:  # noqa: BLE001 - fails this batch, not remembered
            bspan.set_attr("error", repr(e))
            bspan.end()
            for p in batch:
                p.fail(e)
            return
        try:
            with trace.use(bspan.context):
                outs = engine.run_batch_wire([p.request for p in batch])
            bspan.end()
        except _write_behind_full_type() as e:
            # Write-behind backpressure: nothing was served or persisted.
            # Flow control, not poison: every member answers 503.
            bspan.set_attr("backpressure", True)
            bspan.end()
            for p in batch:
                p.fail(SchedulerQueueFull(e.retry_after))
            return
        except KernelError as e:
            # A fault of the card or a kernel, not of a request: every
            # member fails (the handler answers 500); a singleton retry on
            # the host path would hide it.
            bspan.set_attr("error", repr(e))
            bspan.end()
            for p in batch:
                p.fail(e)
            return
        except Exception as e:  # noqa: BLE001 - poison isolation
            # (BaseException propagates, and the loop fails what is still
            # queued.) Every shard transaction rolled back, so the
            # singleton retry is exact and isolates the poison to the
            # request that carries it.
            bspan.set_attr("poisoned", True)
            bspan.set_attr("error", repr(e))
            bspan.end()
            self._count("poisoned_batches")
            metrics.inc("evolu_sched_poisoned_batches_total")
            log("server", "scheduler batch poisoned; retrying as singletons",
                error=repr(e), requests=len(batch))
            for p in batch:
                try:
                    response = self._serve_single(p.request)
                except Exception as pe:  # noqa: BLE001
                    p.fail(pe)
                else:
                    self._count("poison_retries")
                    metrics.inc("evolu_sched_fallback_total", reason="poison_retry")
                    p.resolve(response)
            self._observe_jit_caches(batch)
            metrics.observe("evolu_sched_batch_ms", (time.perf_counter() - t0) * 1e3,
                            exemplar=bspan.trace_id)
            return
        self._count("coalesced", len(batch))
        metrics.inc("evolu_sched_coalesced_requests_total", len(batch))
        n_v2 = sum(aead.count_v2(p.request.messages) for p in batch)
        if n_v2:
            metrics.inc("evolu_crypto_v2_batched_messages_total", n_v2)
        for p, out in zip(batch, outs):
            p.resolve(out)
        self._observe_jit_caches(batch)
        metrics.observe("evolu_sched_batch_ms", (time.perf_counter() - t0) * 1e3,
                        exemplar=bspan.trace_id)

    def _observe_jit_caches(self, batch) -> None:
        """Recompile sentinel, after each engine pass: the engine's
        per-launch-shape state into gauges and a counter, a flight event
        on growth (`engine.observe_jit_caches`). Skipped until an engine
        exists. Never raises."""
        if self._engine is None:
            return
        try:
            from evolu_tpu_torch.server import engine as eng_mod

            eng_mod.observe_jit_caches(sum(len(p.request.messages) for p in batch))
        except Exception:  # noqa: BLE001,S110 - the sentinel must not fail a batch
            pass

    def _ensure_engine(self):
        """The BatchReconciler on the scheduler's device, made on the
        dispatcher thread at the first batch. A failure to make it fails
        that batch and is not remembered."""
        if self._engine is None:
            from evolu_tpu_torch.server.engine import BatchReconciler

            if self._mesh_engine and self._mesh_ctx is None:
                from evolu_tpu_torch.parallel.mesh import get_mesh_context
                from evolu_tpu_torch.utils.config import default_config

                self._mesh_ctx = get_mesh_context(default_config.mesh_devices, device=self.device)
            self._engine = BatchReconciler(self.store, device=self.device,
                                           write_behind=self._write_behind, mesh_ctx=self._mesh_ctx)
        return self._engine

    @property
    def mesh_ctx(self):
        """The engine's MeshContext (None until a mesh engine's first batch
        resolves the process-wide one, and without the mesh engine)."""
        return self._mesh_ctx

    def _serve_single(self, request: protocol.SyncRequest) -> bytes:
        """The per-request path, the recipe the non-batching relay runs:
        the fused wire serve, or the object path (where non-canonical
        shapes reach the host oracle before any side effect). Only ever
        called on the dispatcher thread. With write-behind on it runs
        behind the drain barrier: every ACKed row is committed first, and
        the drains wait until it is done."""
        from evolu_tpu_torch.server import relay

        if self._write_behind is not None:
            with self._write_behind.drain_barrier():
                return relay.serve_single_request(self.store, request, device=self.device)
        return relay.serve_single_request(self.store, request, device=self.device)

    def stop(self) -> None:
        """Drain, then shut down (idempotent): everything already queued
        is served in full-size batches with no deadline waits; new
        submits raise `SchedulerQueueFull`."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._stopped.wait(timeout=max(30.0, self.submit_timeout_s))
        self._thread.join(timeout=5.0)
        if self._own_engine:
            with self._cv:
                engine, self._engine = self._engine, None
            if engine is not None:
                engine.close()


def format_retry_after(seconds: float) -> str:
    """RFC 7231 Retry-After is integer delay-seconds: the integer form when
    integral, else the bare float (the port's client parses either)."""
    f = float(seconds)
    return str(int(f)) if f.is_integer() else repr(f)
