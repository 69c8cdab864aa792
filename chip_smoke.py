#!/usr/bin/env python3
"""On-card smoke run of evolu_tpu_torch, the PyTorch/CUDA port of the
LWW reconcile pass, the typed-CRDT apply, the client worker, the relay
engine, the client handle with its encrypted sync, and the packed/native
receive, the relay as a live HTTP server, the relay tier's replication
half, push subscriptions on the event-loop connection tier, the
write-behind storage inversion, scoped sync (partial replication), the
sort-free scatter-argmax merge plan with its router, the owner mesh
(the sharded reconcile, engine and winner cache, the hot-owner split and
the multi-process pod pass) on shards sharing the card, and the public
surface with the system's entry points.
Needs one
NVIDIA Hopper card, g++, libsqlite3.so.0
and libcrypto; run from the repo root:

    python3 chip_smoke.py

The first line names the host compiler and the soname each native
library links (the run fails here if one cannot link). Phases (any
failure ends the run with a traceback and a nonzero code):

1. build    — g++ builds the two native host libraries from the unchanged
              native/*.cpp into evolu_tpu_torch/_build/native/ in a thread
              while nvcc builds the kernels from evolu_tpu_torch/csrc/ and,
              beside them, a one-row probe of H's `timestamp_hash`;
              prints ptxas' registers and spills, H's grid, and H's
              integer instructions a hashed row, counted in the probe's
              SASS (the count behind H's bound).
2. kernels  — kernels L (segmented lex-max scan), X (segmented XOR scan),
              H (timestamp hash + digest) and S (segmented u64 sum,
              wrapping values) against their plain PyTorch versions on
              the card, bit for bit (H on dates up to the int32 day
              wrap); then L, X and S on inputs that stress their
              decoupled look-back (one segment over 2^23+5 rows, every
              row flagged, sizes around the tile, unaligned views,
              back-to-back calls and a second stream), and H's digest
              and sizes (n = 1, 255, 257, 2^24+3; all-false masks;
              back-to-back calls, the empty call, a second stream).
3. path A   — `reconcile_owner_batches` on 1M CrdtMessages across 1k
              owners (~4 messages per cell, 60% of cells with a stored
              winner, one owner in non-canonical hex case), every
              owner's result and the digest against the host oracle
              (`plan_batch` + `minute_deltas_host`, owner by owner in a
              pool of spawned processes); each kernel must have launched.
4. path B   — SQLite apply (`PySqliteDatabase`, as in paths C2, D and E):
              100k messages over todo/todoCategory in
              batches, then 64 replicas editing the same 100 rows,
              through `apply_messages(planner=plan_batch_device_full)`;
              every table and the Merkle tree string byte-identical to
              `apply_messages_sequential` on a second database, run in a
              process of the spawned pool while the card runs paths M1 to
              B (`b_oracle`, held by digest).
5. path C1 — the typed folds at the repo's benchmark sizes, each against
              the port's host oracle: `pn_counter_sums` (2^20 ops, 2^18
              cells), `rga_order` (2^20-2 elements, 2^12 cells),
              `tensor_cell_folds` (2^20 ops x width 8, 2^15 cells) for
              sum, mean and max, `counter_shard_sums_core` and
              `tensor_shard_sums` (1M ops, 1k owners); S and L must
              have launched.
6. path C2 — SQLite typed apply: 4 batches of 31k messages (5k per typed
              column of board(title, votes:counter, tags:awset,
              body:list, w/avg/peak tensors of width 8) + 1k titles)
              and a 10k re-delivery, through `apply_messages` with the
              device planner and device folds; every table and the
              Merkle tree byte-identical to `apply_messages_sequential`
              with host folds on a second database, run in the pool while
              the card runs paths M1 to C2 (`c2_oracle`, held by digest).
              Every call of a
              kernel's dispatcher is recorded (for the timing phase)
              and must match its launch count.
7. path D   — the client `DbWorker(device=None)` with `backend="auto"` and
              the device-resident winner cache, on the config-2 todo shape
              (todo, todoCategory, todoNote): D1 one Receive of 2^19
              messages over ~2^17 cells in 4 chunks of 2^17; D2 3 Receives
              of 100k over a steady 5k-row population; D3 1 Receive of 50k
              over fresh rows (the gate streams), then 1 over the
              steady rows; D4 a Send of 1k, a sweep of 10
              subscribed queries, a Sync and a Receive whose server tree
              differs. A `backend="cpu"` worker gets the same commands:
              outputs, pushes and every table byte-identical; the cache
              audit after every Receive; any OnError fails. L, H and X
              must launch per device-planned chunk or batch, S never. The
              oracle worker runs in a process of the spawned pool
              (`d_oracle`) while the card runs paths B to D, and is held
              by digest (`d_state`). (Its timing phase, D1 and D2's first
              batch again with `winner_cache=False`, was cut when path P
              was added; the card tests drive that route.)
8. path E   — the relay's batched sync pass at BASELINE config 3:
              `BatchReconciler(RelayStore(backend="python")).run_batch_wire`
              (the generic ingest) on the card against
              `serve_single_request` request by request on a second Python
              `RelayStore` (host hashing). E1 1M messages over 1k owners
              (benchmarks/config3_server_reconcile.py's shape, 116-byte
              contents), each request with its post-apply tree; E2 100k new
              + 50k stored + 10k in-batch duplicates, half the owners with
              their tree from before E2; E3 cold sync of 25 owners; E4, on
              fresh stores with 16,384 rows each, a millis span of 2^32 ms (the 20-B upload), every
              row its own minute (cap overflow, full-width rerun), one owner
              in upper-case hex (the host fold). After every step the
              responses' bytes, the `message` table and the `merkleTree`
              table equal the oracle's (E1-E3's by digest: their oracle,
              `e_oracle`, runs in a process of the pool while the card
              runs paths B to D); the engine's stage times (host clock,
              device leg synchronized) and route counts are printed; H and X
              launch once a device dispatch, L and S never.
9. path F   — the client handle with end-to-end encrypted sync: clients
              made by `Evolu`/`create_hooks(device=None)` with the
              reference's defaults (storage and planner `backend="auto"`:
              the native C++ SQLite layer, the device planner and winner
              cache) sync through `SyncTransport`s on the native crypto leg
              (fused push bodies; every response decoded to a
              PackedReceive, or the step fails) whose `http_post` answers
              with `BatchReconciler(RelayStore()).run_batch_wire` on the
              card over a native store (OpenPGP contents both ways). F1
              config 1: the todo table, 2 replicas, 930 messages in
              `batching()` groups under live
              QueryViews, B's reset_owner / restore_owner and re-sync (host
              route); F2 config 2: A's 6 Sends of 10k (10 until the cut
              for path Q), B pulls after each, a third device C restores
              A's mnemonic after the 3rd and pulls the 30k history in one
              round, then pulls with B; F3 the typed
              calls on path C2's board schema, 4 groups of 2,048. An oracle
              set (`backend="cpu"` clients on `device="cpu"` over
              `PySqliteDatabase`, the pure crypto loops,
              `serve_single_request` on a Python store) gets the same
              commands with the same ids and clock: every client's tables,
              OnQuery patches and query rows, the relays' trees and stored
              (timestamp, owner) columns equal, every client's tree equal to
              its relay's. Each step prints both sets' msgs/s, the card set's
              wall split into encrypt (the push body), relay answer, decrypt
              (the response decode), the workers' apply and the rest, the
              responses by decode route, the apply routes and the
              transports' counts.
10. path G  — the packed/native receive. G1: path D's D1 and D2's first
              batch (the 2^19-message initial sync in 4 chunks, then a
              steady Receive of 100k; 3 of them until the cut for path Q)
              sealed with the native `encrypt_batch`,
              pushed into a native `RelayStore` and served back by
              `serve_single_request`; the card side decodes each response
              with `decrypt_response_columns` into a `DbWorker(device=None)`
              on `CppSqliteDatabase` with the winner cache; the same bytes
              through the pure loops must give exactly what path D's
              `backend="cpu"` worker on `PySqliteDatabase` received, and
              that worker's state after D2 is the oracle: outputs, pushes,
              tables and tree equal,
              every chunk and batch planned and applied packed (no bounce),
              both native libraries loaded from the port's build. G2: path
              E's E1 and E2 requests through `BatchReconciler` on a native
              `RelayStore` (the packed ingest), E1 also on 4 native shards:
              responses equal path E's, tables equal path E's store. Each
              prints msgs/s and its wall split, and H and X's launches.
11. path H  — the relay as a live server. H1: path E's E1 and E2
              requests of owners 0-499 (half of them since the cut for
              path Q) POSTed over HTTP by `sync.client._http_post` from 32
              client threads (disjoint owners, path E's order an owner) to
              `RelayServer(RelayStore(<file>, backend="native"),
              batching=True)` on the card: the continuous-batching
              `SyncScheduler` runs each batch through `start_batch` /
              `finish_batch`; responses equal path E's, tables path E's
              store's rows of those owners; msgs/s, requests/s, client
              p50/p99 latency, engine passes and their sizes, the
              scheduler's counts and the streaming split. H2: those owners'
              E1 requests in 4 batches of 125 owners, then their E2,
              through `reconcile_stream` and through `run_batch_wire` batch
              by batch on fresh native stores: equal to path E and to each
              other, with the pull thread's wait beside the host leg per
              batch. H3: path F's F2 handles (5 Sends of 10k) over real
              HTTP, the card set at a batching card relay, the oracle set at
              a per-request relay on the CPU: round 1 stores OpenPGP only,
              `aead-batch-v1` negotiated after it, every later Send stored
              as v2 records; everything equals the oracle set's; the crypto
              share beside F2's v1 share.
12. path I  — the relay tier's replication half, every relay a
              `RelayServer(RelayStore(<file>, backend="native"),
              batching=True)` on the card serving real HTTP. I1: a fresh
              relay B with `peers=[A]`, A being H1's relay (550,522 rows,
              500 owners), converges on its own gossip loop (default caps);
              B's trees and rows an owner equal A's, the pulled keys are
              exactly A's rows (re-pulled messages counted apart; the
              full-table compare was cut when path M was added), H = X =
              B's engine passes. I2: a donor D of
              64,000 rows (each owner's first 64 of E1, by
              `run_batch_wire`) bootstraps a fresh relay C
              (`bootstrap_lag_owners=1`) from its snapshot in 4 MiB chunks,
              verified on the host with no engine pass; 10,000 new messages
              POSTed to D reach C by gossip; `write_checkpoint(D)` restores
              into 4 native shards with every tree equal. I3: 3 relays,
              each in a process of its own (`i3_member`, as
              benchmarks/fleet_scaling.py runs them; one interpreter until
              path P was added), under one `FleetConfig` (R 2) take 8,000
              messages (32,000 until path O was added, 16,000 until path
              Q was) over 1k
              owners (Zipf 1.1, batches of 64, 8 client threads following
              one 307 each), then a 4th relay joins by `/fleet/reload`
              under a writer; at each scoped-gossip fixpoint every owner's
              rows on every placed relay equal a per-request oracle relay's
              on a Python store; quiet moved owners equal the losing
              relay; at least one watermark cutover. No failed round,
              rebalance, poisoned batch, single or reject; H = X = engine
              passes, L = S = 0.
13. path J  — push subscriptions and the event-loop connection tier, every
              relay `RelayServer(RelayStore(<file>, backend="native"),
              batching=True, connection_tier="eventloop")` on the card
              (benchmarks/push_subscriptions.py's shape). J1: 10^4 idle
              long-polls parked by a child process (one owner each; fewer
              only where the descriptor limit forces it), the relay's
              subscriptions, threads and RSS at 0, 5,000 and 10,000
              (threads flat, under 64); 12 rounds of 8 probes parked on a
              hot owner, a writer's POST and each woken probe's
              confirmation sync round, against 3 rounds of a 1.0 s
              polling baseline (push p50 at least 5x better). J4, on J1's relay: two
              `create_evolu` handles with `push_subscribe=True` and no
              timer; a mutation on one becomes visible on the other
              through a push wake alone. (J2, H1's bodies at a fresh
              event-tier relay, was cut when path M was added; J3 and the
              card tests drive the event tier's engine passes.) J3: one
              mutation stream with a woken subscriber at an
              event-tier and a threaded card relay: every raw response
              equal with Date masked, both stores and `/stats` push
              sections equal. H = X = engine passes in every step, L = S
              = 0.
14. path K  — the write-behind storage inversion: serve from in-memory
              trees, ACK into an fsync'd log, drain to SQLite later. K1:
              the bodies of H1's first 128 owners (256 of its 1,000,
              cut when path N was added) from its 32 lanes to a batching
              card relay with `write_behind=True` at the Config's
              defaults (503 + Retry-After when the queue is full, retried
              by `_http_post`): serve and end-to-end msgs/s, p50/p99,
              passes, 503 answers, the largest backlog and the log's
              append time, beside H1's; responses equal path E's, tables
              path E's store's rows of those owners after the flush,
              /health 200 and an empty log after `stop()`. K2: H2's
              batches through `run_batch_wire` with a queue over 4 native
              shards and 4 drain workers, serve ms a batch beside H2's,
              the flush, responses and drained tables equal path E's. K3:
              crash and replay through `tests/_torch_write_behind_worker.py`
              (12 seeded batches of ~4,000 messages served on the card,
              SIGKILL at a seeded ACK, replay in a fresh process), on 3
              shards with 3 workers, batches with no redelivered
              rows so the kill finds a backlog: the replayed state equals
              a synchronous card twin, the replay finds rows and launches
              nothing, and its rows/s; K3's counts are the serving
              children's. H = X = engine dispatches in every step, L = S
              = 0.
14b. path O — observability on the main path (`evolu_tpu_torch.obs`, the
              logger's spans, the relay's /metrics, /stats, /trace and
              /profile), right after path K. O1: path A's columns pass at
              config 3, 1M messages (2^20 rows), through the port's entry
              (`shard_kernel_for`, `dispatch_columns_sharded`,
              `pull_shards` under a `kernel:reconcile` span and a sampled
              root span), after a warm-up, eight times, obs off and on in
              turns ("on": metrics, the stage anatomy, tracing at 100% and
              record_function annotations): masks, the (owner, minute)
              segments the deltas decode from and the digest equal (the
              decode itself, 2.5 s a run, is path A's and the columns
              pass's), the same launches of L, X and H and the same pull
              waves; each stage's CUDA-events ms and the overhead (on - off
              over off) by stage and for the pass; then the bare key sort,
              the compact-delta encode and the pull rate that price
              `COST_LAWS["cuda"]`. O2: K1's 256 requests (H1's first 128
              owners' bodies) from its 32 lanes to a batching card relay on
              a native file store with every plane on (no write-behind),
              one request carrying a known traceparent, while GET
              /profile?ms=1000 captures the traffic (the device profiler
              prepared first on the main thread): responses equal path
              E's; /metrics parses as Prometheus 0.0.4 and its request,
              message and coalesced counters equal the traffic; /stats has
              one latency observation a request and the device_dispatch,
              pull_wave and host_apply stages; /trace/<id> has the relay's
              span and the engine.batch span that links it, with a
              kernel:merkle span under that; the profile's device lane holds
              CUDA kernel events of `lookback_scan` (seg_scan.cu) and
              `ts_hash_kernel` (ts_hash.cu), and a document without a device
              lane fails. H = X = O2's passes and O1's 8, L = O1's 16.
15. path P  — scoped sync (partial replication), every relay a batching card
              `RelayServer` on a native file store advertising
              sync-scope-v1. P1: 16 owners x 65,536 rows (E1's contents)
              ingested by the one-shot packed ingest, lanes recorded by
              `record_push_lanes` (10 an owner, 1/64 untagged, one owner in
              upper-case hex), a native file store made in the pool
              (`p_seed`); 8 fresh scoped pullers of 8 of the owners (half
              the history, one lane; 16 until the cut for path Q) and 2
              fresh full pullers converge over HTTP: each
              crc carry equals its owed set's (a plain statement of the
              membership rule), 2 answers equal `scoped_response` on the
              CPU, and the scoped serve's split, rounds, bytes and rows/s
              are printed. P2: three `create_evolu`-shaped handles of one
              owner on the card set (W scoped to both tables, R to `todo`
              from W's 5th Send, F unscoped; 25,300 messages), held by
              digest against an oracle set run in the pool: R's `todo`
              rows equal its slice, its deferred frontier is F's 1,000
              untagged `todoCategory` rows and 300 untagged `note` rows, a
              `note` query on R answers `ScopeDeferred` with exactly those
              300 rows, and after `WidenSyncScope(full=True)` R equals F. P3: a scoped `/replicate/snapshot` of 4 of P1's
              owners installs exactly their owed slices with host-fold
              trees, beside an unscoped capture; no launch. P4: the fold
              on 2^20 canonical stamps with a 10% mask (parse, upload, H
              and X by profiler, pull, dict) beside H's and X's bound, and
              the host fold at 2^17 rows. H = X = the device scoped folds
              in P1.
16. path M  — the sort-free scatter-argmax LWW plan (ops/scatter_merge.py)
              and its router, spread over the run to reuse other paths'
              inputs. M1, right after path A: path A's owners through
              `reconcile_owner_batches` with the plan pinned to "scatter"
              (one scatter shard kernel: H and X once, L never); every
              owner's masks, upserts and deltas and the digest equal path
              A's sort results. M3, after G1: a card `DbWorker` with
              `backend="cuda"`, no winner cache and `merge_plan="scatter"`
              replays D1 (D2 was cut when path N was added); outputs,
              pushes, tables and tree equal path D's oracle after D1, every
              chunk a scatter plan (H and X once each, L never). M2, after the columns pass, on its 2^20
              config-3 rows: `scatter_plan_masks` against the sort plan's
              `plan_merge_sorted_flags`, and `_shard_kernel_scatter` against
              `_shard_kernel` (each pair checked equal first), CUDA events in
              turns and profiler device time, beside the scatter plan's byte
              bound. M4: the router's edges on the card against the host
              `plan_batch` and the CPU port: a repeated (cell, timestamp) row
              routes to sort, a cell id of 2^25 or more to sort (full plan)
              and wide (shard router), millis ≥ 2^47 with nodes ≥ 2^63 to
              scatter, and `plan_batch_device` on both routes. Routes are
              read from `scatter_merge.counts`.
17. path N  — the owner mesh: MeshContexts of 8 shards sharing cuda:0
              (the analog of the reference's 8-device virtual mesh), each
              step held against a result an earlier path checked. N2,
              after M1: path A's owners through `reconcile_owner_batches`
              on 8 shards equal path A's. N4, after M3: a card `DbWorker`
              with `mesh_engine` and `hot_owner_min_batch` = 2^17 replays D1
              (each chunk `reconcile_hot_owner`) and D2's first batch (the
              `MeshShardedWinnerCache`, its gate off, audited after the
              Receive; D2's other two batches were cut when path O was
              added) to path D's oracle state after that Receive. N3, after G2: E1
              and E2 through the mesh engine's `run_batch_wire` on a 4-shard
              native file store, bytes, trees and row counts equal path E's; a batch
              whose one owner holds over half the rows (the row split) and
              E4's cap-overflow shape, each equal to a 1-shard engine's. N6:
              E2's first 256 requests at a mesh relay (`mesh_engine`) and one
              `EVOLU_MESH_ENGINE` turns on, each answering the bytes of a
              relay without a mesh, `/stats` `mesh` with 8 devices and a
              dispatch a pass. N1, after N5: config 5's layout (2^22 messages,
              cut from 10M; 1k owners, owner % 8) through `reconcile_columns_sharded`
              against one 1-shard pass (masks at the rows' original
              positions, digest), each shard's rows and padding, device ms
              (profiler) and CUDA-events ms in turns, the card to itself.
              N5, after M4: config 5's pod (500 owners x 400, wire; the
              requests built in the oracle pool) across two processes
              spawned before M4 in one gloo group (`file://` store), 4
              shards each, against a 1-process `reconcile_pod` run after
              they end: equal digests, the union of the
              answers byte-equal, each store holding its own owners. L, H
              and X launch once a shard a pass (L twice); the pod's launches
              are its processes'.
18. columns — the reconcile pass from device-resident columns at 1M
              messages (1k owners; the 10M pass was cut when path J was
              added), per-stage times with CUDA events, rows/s and peak
              device memory; outputs equal to the same pass with every
              kernel swapped for its plain version.
19. timing  — L, X, H and their plain versions timed on the inputs the
              1M columns pass handed them; S on the inputs path C1's
              counter and tensor-sum folds handed it, beside
              `torch.cumsum` on the same column; then every kernel on
              every input path C2 handed it (checked against its plain
              version), summed to ms, device ms and bound per C2 run.
              `ms` is CUDA events around 10 back-to-back wrapper calls
              (host cost included wherever the host is the slower);
              `device_ms` is the kernels' own duration from
              torch.profiler, each session a warm-up step and then the
              active step read, counted only if it caught every kernel
              record (null, with `device_ms_events` from CUDA events
              beside it, where none of three sessions did); `host_us` is the wrapper's host time per
              call over 1000 calls with no synchronize, on the smallest
              input path C2 gave the kernel (`host_us_rows`). The relay
              engine's three kernel functions on E1's columns: bytes up and
              down, upload, device and pull times; and H and X on the inputs
              E1 gave them, against their plain versions.
20. path O3 — the conservation ledger on the relay tier, after the
              timing phase, where it cannot touch that phase's profiler
              sessions.
              O3a three times on fresh relays, the ledger off, on, off:
              K1's 256 requests from its 32 lanes at a write-behind
              batching card relay R (4 native file shards, a drain worker
              a shard), 8 exact redeliveries, an upper-case-hex node (the
              host-owner route), an 8-digit node (the singleton's 500) and
              a forced 503: responses equal K1's, one X, one H and one pull
              wave an engine dispatch; in the on run a second card relay
              pulls every row, its round armed by a traced write's
              `hint(origin=)`: every station of both relays equals the
              script's own count, GET /ledger has no violation, /stats has
              its ledger section and a convergence lag, /trace/<id> on the
              peer holds repl.round; the on run's msgs/s is printed beside
              the off runs' spread. O3b: 32 requests sent to the wrong
              member of a two-relay forward fleet: egress.forward =
              ingress.forward = the messages sent, the forward leg in the
              request's trace. O3c: one Receive of 16,384 config-2 todo
              messages into a card DbWorker with the ledger off and on:
              equal end states, the apply plane's equations, route.packed
              > 0, L twice and H and X once.
21. path Q  — the public surface, every step through `from evolu_tpu_torch
              import ...` and `evolu_tpu_torch.examples`, on the card. Q1:
              a `RelayServer(RelayStore(file))`; client A (`create_evolu`
              with todo_cli's schema, `connect`) creates 20 categories and
              2,000 todos, toggles 500, renames 500, assigns 1,000 and
              soft-deletes 200 (about 12,500 messages), and syncs; client B
              restores A's mnemonic on an empty database and syncs once:
              its first receive holds all of A's messages (at least 8,192,
              above `min_device_batch`, so the card plans it), and a twin of
              B with backend="cpu" does the same. B's `ls` rows equal A's,
              B's tree equals A's and the relay's, B's app tables and
              `__message` equal the twin's; L, X and H launch. Q2: the web
              demo's episode over HTTP (CRUD, a long-poll woken by a
              toggle, a soft delete, a reset), then two demos of one owner
              converging through Q1's relay. Q3 (the processes started
              before Q1): `python -m evolu_tpu_torch.examples.relay_server`
              answers /ping and a push and a pull with an in-process
              RelayServer's bytes; `python -m evolu_tpu_torch.examples.pod_server`
              prints JAX's line for its demo batch (pod digest 0x9eac93cd).

Every path sets every kernel's launch count to 0 just before it runs
and reads all four just after (G1 and G2 each, summed as path G). In
the kernels JSON, `launches` is the sum of those counts and
`launches_path_{a,b,c1,c2,d,e,f,g,h,i,j,k,o,p,m,n,q}` are the counts themselves (H1,
H2 and H3 each, summed as path H; I1, I2 and I3 as path I; J1, J3 and J4 as path
J; K2 and K3's serving children as path K; O1, O2 and O3's five steps as path O; P1-P4 as path P; M1, M3 and
M4 as path M, M2 being timing; N1-N6 as path N, N5's from its two pod
processes, each step's mesh runs only; Q1 and Q2 as path Q, Q3's
processes uncounted); `ms`, `device_ms`,
`plain_ms`, `bound_ms` and `max_abs_err` are at the input named by
`timed_on`; `path_c2_{ms,device_ms,bound_ms}`
are summed over every call path C2 made; `ported` and `redesigned` are
the numbered changes that ported and redesigned each kernel, as
PERF.md's kernel table lists them, and `design` names the design; X's
and H's `at_path_e` the same numbers on path E's E1, and H's
`ops_per_hashed_row` the count from the probe's SASS.

The last two lines are the card's `nvidia-smi` name and power limit
and then {"ok": true, "device": {...}}; the line before them is the
kernel table as JSON.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import itertools
import json
import multiprocessing
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

BASE_MILLIS = 1_700_000_000_000
# Processes of the spawned pool that runs path A's host oracle, path D's
# and E's oracles (beside paths B-D) and G1's pure decode, off the paths
# that are timed.
ORACLE_PROCESSES = 6
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
# 132 SMs x 128 32-bit integer instructions a clock x 1.98 GHz: 4 schedulers
# an SM each issue one 32-lane instruction a clock, and integer work fills
# them from two 64-lane pipes (IMAD on the FMA pipe, logic, shift and add
# on the integer ALU). The 64-lane figure alone (16.7e12) is no peak:
# kernel H runs above it (PERF.md).
INT32_OPS_PER_S = 33.4e12
# Timestamps whose canonical strings the kernels must render like the JAX
# package: leap days, end of 9999, pre-1970, 2^47, and the ends of the
# days window [2^31 - 719468, 2^31 - 1] where `days + 719468` wraps in int32.
EDGE_MILLIS = [0, 951_782_400_000, 4_107_542_399_000, 253_402_300_799_999, -1, -999, -1000,
               -86_400_001, -62_135_596_800_000, 2**47, 185_480_425_152_000_000, 185_542_587_187_199_999]


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str, gpu: str):
    t0 = time.perf_counter()
    print(f"[{name}] start | {gpu}", flush=True)
    yield
    print(f"[{name}] ok {time.perf_counter() - t0:.3f}s | {gpu}", flush=True)


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    CUDA events around each run, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fns, reps: int = 10, per: int = 1, records: int | None = None) -> dict:
    """Device time of the kernels that one call of each of `fns` launches,
    summed over `fns`, averaged over `reps` rounds and divided by `per`,
    from torch.profiler (CUPTI kernel records): {"device_ms": t}. The
    session runs on the profiler's schedule, a warm-up step (its records
    dropped) and then the active step that is read. `records` is the count
    of device records one round of `fns` leaves (each port kernel's wrapper
    launches one kernel and nothing else, so 1 a call); None where a call
    launches library kernels too, and then every kernel name's count must be
    a multiple of `reps`. A session that caught another count is not
    recorded (on the H100 some sessions catch a part of the kernels, or
    none) and is run again, up to three in all; after that the row says so:
    {"device_ms": None, "device_ms_events": t}, t from CUDA events around the
    same calls, an upper bound that includes the launch gaps."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def rounds():
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()

    rounds()
    seen = []
    for _ in range(3):
        got = {}
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.update(events=p.events())) as prof:
            for _step in range(2):
                rounds()
                prof.step()
        # Device records of the calls only: a user annotation (the
        # schedule's ProfilerStep range) may show on the device lane too.
        kernels = [e for e in got.get("events", ()) if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False) and not e.name.startswith("ProfilerStep")]
        names = collections.Counter(e.name for e in kernels)
        whole = (len(kernels) == reps * records if records is not None
                 else bool(names) and all(c % reps == 0 for c in names.values()))
        if whole:
            return {"device_ms": round(sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3 / per, 5)}
        seen.append(len(kernels))
        time.sleep(0.2)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for fn in fns:
            fn()
    end.record()
    end.synchronize()
    want = reps * records if records is not None else f"a multiple of {reps} a kernel"
    print(f"  device_ms: torch.profiler caught {seen} device records in 3 sessions, {want} expected; not measured, "
          "the row carries device_ms_events instead", flush=True)
    return {"device_ms": None, "device_ms_events": round(start.elapsed_time(end) / reps / per, 5)}


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host time of one call of `fn`, over `calls` calls with no
    synchronize between them (the device is drained after the clock
    stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def reset(kernels):
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for k in kernels:
        k["fn"].launches = 0


def read(kernels):
    """Every kernel's launch count (just after a path ran)."""
    return {k["name"]: k["fn"].launches for k in kernels}


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output, as integers (the
    outputs are integer bit patterns, so anything but 0 is a fault)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def same(got, want, what):
    for g, w in zip(got, want):
        if not (g.dtype == w.dtype and g.shape == w.shape and bool((g == w).all())):
            raise AssertionError(f"{what}: kernel differs from its plain version")


# ---- data ---------------------------------------------------------------------------


def build_columns(n, owners=1000, seed=7):
    """bench.build_columns(stored_winners=True): ~4 messages per cell,
    cells owned by one of `owners`, minutes clustered in one day, ~60% of
    cells with a stored winner from the same window. Padded to the
    power-of-two bucket with the planner's padding cell."""
    from evolu_tpu_torch.ops import bucket_size

    rng = np.random.default_rng(seed)
    cells = max(n // 4, 1)
    cell_id = rng.integers(0, cells, n).astype(np.int32)
    owner_ix = rng.integers(0, owners, cells).astype(np.int64)[cell_id]
    millis = BASE_MILLIS + rng.integers(0, 86_400_000, n).astype(np.int64)
    counter = rng.integers(0, 256, n).astype(np.int32)
    node = rng.integers(1, 2**63, n).astype(np.uint64)
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    has = rng.random(cells) < 0.6
    w_millis = (BASE_MILLIS + rng.integers(0, 86_400_000, cells)).astype(np.uint64)
    w_k1 = (w_millis << np.uint64(16)) | rng.integers(0, 256, cells).astype(np.uint64)
    w_k2 = rng.integers(1, 2**63, cells).astype(np.uint64)
    size = bucket_size(n)
    pad = size - n
    return {
        "cell_id": np.concatenate([cell_id, np.full(pad, 0x7FFFFFFF, np.int32)]),
        "k1": np.concatenate([k1, np.zeros(pad, np.uint64)]),
        "k2": np.concatenate([node, np.zeros(pad, np.uint64)]),
        "ex_k1": np.concatenate([np.where(has, w_k1, 0)[cell_id].astype(np.uint64), np.zeros(pad, np.uint64)]),
        "ex_k2": np.concatenate([np.where(has, w_k2, 0)[cell_id].astype(np.uint64), np.zeros(pad, np.uint64)]),
        "owner_ix": np.concatenate([owner_ix, np.zeros(pad, np.int64)]),
    }


def ts_strings(millis, counter, node, upper=False):
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    out = []
    for m, c, d in zip(millis.tolist(), counter.tolist(), node.tolist()):
        h = f"{d:016x}"
        out.append(timestamp_to_string(Timestamp(m, c, h.upper() if upper else h)))
    return out


def owner_batches(n_owners=1000, per_owner=1000, seed=11, non_canonical=(0,)):
    """Config 3 as messages: per owner ~4 messages per cell over 2
    columns, 60% of cells with a stored winner from the same day."""
    from evolu_tpu_torch.core.types import CrdtMessage

    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    n_cells = per_owner // 4
    for o in range(n_owners):
        owner = f"owner{o:04d}"
        cell = rng.integers(0, n_cells, per_owner)
        ts = ts_strings(BASE_MILLIS + rng.integers(0, 86_400_000, per_owner),
                        rng.integers(0, 256, per_owner), rng.integers(1, 2**63, per_owner),
                        upper=o in non_canonical)
        cols = ("title", "isCompleted")
        batches[owner] = [
            CrdtMessage(s, "todo", f"{owner}-row{c >> 1:06d}", cols[c & 1], f"v{i}")
            for i, (s, c) in enumerate(zip(ts, cell.tolist()))
        ]
        has = np.nonzero(rng.random(n_cells) < 0.6)[0]
        w_ts = ts_strings(BASE_MILLIS + rng.integers(0, 86_400_000, len(has)),
                          rng.integers(0, 256, len(has)), rng.integers(1, 2**63, len(has)))
        winners[owner] = {("todo", f"{owner}-row{c >> 1:06d}", cols[c & 1]): s
                          for c, s in zip(has.tolist(), w_ts)}
    return batches, winners


# ---- phases -------------------------------------------------------------------------


def kernels_vs_plain(torch, dev):
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan

    rng = np.random.default_rng(5)
    for n in (1, 127, 4096, 70000, (1 << 20) + 3):
        flags = rng.random(n) < 0.03
        flags[0] = True
        k1 = rng.integers(0, 2**64, n, dtype=np.uint64)
        k2 = rng.integers(0, 2**64, n, dtype=np.uint64)
        k1[rng.random(n) < 0.3] = np.uint64(42) << np.uint64(32)   # ties
        k1[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)    # ≥ 2^63
        k2[rng.random(n) < 0.1] = 0
        f = torch.from_numpy(flags).to(dev)
        a = torch.from_numpy(k1.view(np.int64)).to(dev)
        b = torch.from_numpy(k2.view(np.int64)).to(dev)
        for reverse in (False, True):
            same(cuda_scan.segmented_max_scan(f, a, b, reverse=reverse),
                 cuda_scan.segmented_max_scan_plain(f, a, b, reverse=reverse), f"L n={n} reverse={reverse}")
        v = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)).to(dev)
        same([cuda_scan.segmented_xor_scan(f, v)], [cuda_scan.segmented_xor_scan_plain(f, v)], f"X n={n}")
        w = rng.integers(0, 2**64, n, dtype=np.uint64)
        w[rng.random(n) < 0.2] = np.uint64(2**64 - 1)  # every add wraps
        w[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)
        w = torch.from_numpy(w.view(np.int64)).to(dev)
        same([cuda_scan.segmented_sum_scan(f, w)], [cuda_scan.segmented_sum_scan_plain(f, w)], f"S n={n}")
    m, c, d, k1 = hash_inputs(torch, dev, rng, 70003)
    same([cuda_hash.timestamp_hashes_cuda(m, c, d)], [cuda_hash.timestamp_hashes_plain(m, c, d)], "H columns")
    mask = torch.from_numpy(rng.random(70003) < 0.6).to(dev)
    same(cuda_hash.masked_key_hashes_cuda(k1, d, mask),
         cuda_hash.masked_key_hashes_plain(k1, d, mask), "H keys + digest")
    torch.cuda.synchronize()


def hash_inputs(torch, dev, rng, n):
    """H's columns (millis with EDGE_MILLIS first, counter, node) on the
    card, and the reconcile form's keys k1 from them."""
    edge = EDGE_MILLIS[:n]
    millis = np.concatenate([edge, BASE_MILLIS + rng.integers(0, 10**12, n - len(edge))]).astype(np.int64)
    counter = rng.integers(0, 65536, n).astype(np.int32)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    node[:2] = [0, 2**64 - 1][:n]
    m, c, d = (torch.from_numpy(x).to(dev) for x in (millis, counter, node.view(np.int64)))
    return m, c, d, (m.clamp(min=0) << 16) | c.to(torch.int64)


def hash_stress(torch, dev):
    """H, both forms, against its plain version: sizes around the block and
    past 2^24 rows (the grid strides), masks random, all false (digest 0)
    and all true; then the digest's block counter across calls back to
    back on one stream, the empty call and calls on a second stream.
    Returns the number of cases."""
    from evolu_tpu_torch.ops import cuda_hash

    rng = np.random.default_rng(19)
    cases = 0
    for n in (1, 255, 257, (1 << 24) + 3):
        m, c, d, k1 = hash_inputs(torch, dev, rng, n)
        same([cuda_hash.timestamp_hashes_cuda(m, c, d)], [cuda_hash.timestamp_hashes_plain(m, c, d)],
             f"H columns n={n}")
        for kind, mask in (("random", torch.from_numpy(rng.random(n) < 0.6).to(dev)),
                           ("all false", torch.zeros(n, dtype=torch.bool, device=dev)),
                           ("all true", torch.ones(n, dtype=torch.bool, device=dev))):
            got = cuda_hash.masked_key_hashes_cuda(k1, d, mask)
            same(got, cuda_hash.masked_key_hashes_plain(k1, d, mask), f"H keys n={n} mask {kind}")
            if kind == "all false" and int(got[1]) != 0:
                raise AssertionError(f"H n={n}: digest of an all-false mask is not 0")
        cases += 4
        del m, c, d, k1
    inputs = [hash_inputs(torch, dev, rng, n)[2:] for n in (70001, 257, 1 << 20)]
    masks = [torch.from_numpy(rng.random(d.shape[0]) < 0.5).to(dev) for d, _ in inputs]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    got = [x for (d, k1), mask in zip(inputs, masks) for x in cuda_hash.masked_key_hashes_cuda(k1, d, mask)]
    got += cuda_hash.masked_key_hashes_cuda(empty, empty, empty.bool())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [x for (d, k1), mask in zip(inputs, masks) for x in cuda_hash.masked_key_hashes_cuda(k1, d, mask)]
    torch.cuda.current_stream().wait_stream(side)
    want = [x for (d, k1), mask in zip(inputs, masks) for x in cuda_hash.masked_key_hashes_plain(k1, d, mask)]
    want = want + [empty.int(), torch.zeros(1, dtype=torch.int32, device=dev)] + want
    same(got, want, "H back to back on one stream, the empty call, then a second stream")
    torch.cuda.synchronize()
    return cases + 1


# One row of kernel H's hash and nothing else (no row index, no loop, no
# mask, no digest), for counting the hash's own instructions in its SASS.
H_PROBE = r"""#include "{source}"
extern "C" __global__ void hash_one_row(const int64_t* millis, const uint32_t* counter,
                                        const uint64_t* node, uint32_t* out) {{
  *out = timestamp_hash(*millis, *counter, *node);
}}
"""


def start_hash_probe(tmp):
    """Start nvcc on H_PROBE, which includes csrc/ts_hash.cu, with the
    library's flags, beside the library's own build. → (process, cubin)."""
    from evolu_tpu_torch.ops import cuda_lib

    src, cubin = os.path.join(tmp, "hash_probe.cu"), os.path.join(tmp, "hash_probe.cubin")
    with open(src, "w") as f:
        f.write(H_PROBE.format(source=cuda_lib.CSRC / "ts_hash.cu"))
    cmd = [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-cubin", src, "-o", cubin]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), cubin


_REG = re.compile(r"\b(U?R|U?P)(\d+)\b")


def _regs(operand, width=1):
    """Registers an operand names, `width` consecutive ones from each
    general register it names (a 64-bit operand `R2.64` names two)."""
    width = max(width, 2 if ".64" in operand else 1)
    return {f"{kind}{int(num) + k}" for kind, num in _REG.findall(operand)
            for k in range(width if kind.endswith("R") else 1)}


def data_instructions(sass):
    """The instructions of straight-line SASS that compute on loaded data:
    a global load's destination is data, and so is every destination of an
    instruction that reads data (its guard predicate included). Loads,
    stores and control flow are not counted; nor is what computes on
    parameters and constants alone (addressing, constants a loop would
    hoist). → opcodes, in order."""
    data, ops = set(), []
    for ins in sass:
        guard = re.match(r"@!?(U?P\d+)\s+", ins)
        if guard:
            ins = ins[guard.end():]
        op, _, rest = ins.partition(" ")
        operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
        # A second destination is a predicate (carry out, or ISETP's PT).
        ndest = 2 if len(operands) > 1 and re.fullmatch(r"U?P(T|\d+)", operands[1]) else 1
        width = 4 if ".128" in op else 2 if (".WIDE" in op or ".64" in op) else 1
        written = set().union(*(_regs(d, width) for d in operands[:ndest]))
        if op.startswith(("LDG", "LD.")):
            data |= written
            continue
        if op.startswith(("LD", "ULD", "ST", "BRA", "EXIT", "RET", "NOP", "BSSY", "BSYNC", "BAR")):
            continue
        src = operands[ndest:]
        # IMAD.WIDE's addend, its last operand, is a register pair.
        read = set().union(set(guard.groups()) if guard else set(),
                           *(_regs(o, 2 if ".WIDE" in op and i == len(src) - 1 else 1)
                             for i, o in enumerate(src)))
        if read & data:
            data |= written
            ops.append(op.split(".")[0])
        else:
            data -= written
    return ops


def sass_ops_per_hashed_row(proc, cubin):
    """Integer instructions one hashed row of kernel H issues: the SASS
    (`cuobjdump -sass`) of H_PROBE's `hash_one_row`, counted by
    `data_instructions`. Raises if the probe or the tool fails. → (count,
    opcode counts)."""
    import collections

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for the hash probe\n" + log)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    fn, body = None, []
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn == "hash_one_row":
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                body.append(m.group(1))
    ops = data_instructions(body)
    if not ops:
        raise AssertionError("no data instructions found in hash_one_row's SASS")
    return len(ops), dict(collections.Counter(ops).most_common())


def lookback_stress(torch, dev):
    """L (both directions), X and S against their plain versions on inputs
    that stress the look-back: one segment over the whole array (the
    longest chain of tiles waiting on their predecessors), no flag at all,
    every row a segment start, sizes around the tile, views whose data
    start past a 16-byte boundary (8 bytes for L and S, 4, 8 and 12 for
    X), calls of all three back to back on one stream, which they share,
    and on a second stream. Returns the number of cases."""
    from evolu_tpu_torch.ops import cuda_lib, cuda_scan

    tile = cuda_lib.load().evolu_seg_scan_tile_rows()
    rng = np.random.default_rng(17)

    def inputs(n, kind):
        f = np.zeros(n, bool) if kind != "every row" else np.ones(n, bool)
        if kind in ("one segment", "random"):
            f[0] = True
        if kind == "random":
            f |= rng.random(n) < 0.03
        k = [rng.integers(0, 2**64, n, dtype=np.uint64) for _ in range(3)]
        k[0][rng.random(n) < 0.3] = np.uint64(42) << np.uint64(32)
        k[2][rng.random(n) < 0.2] = np.uint64(2**64 - 1)
        x = rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)
        return ([torch.from_numpy(f).to(dev)] + [torch.from_numpy(v.view(np.int64)).to(dev) for v in k]
                + [torch.from_numpy(x).to(dev)])

    def check_x(f, x, what):
        same([cuda_scan.segmented_xor_scan(f, x)], [cuda_scan.segmented_xor_scan_plain(f, x)], f"X {what}")

    def check(f, a, b, w, x, what):
        for reverse in (False, True):
            same(cuda_scan.segmented_max_scan(f, a, b, reverse=reverse),
                 cuda_scan.segmented_max_scan_plain(f, a, b, reverse=reverse), f"L {what} reverse={reverse}")
        same([cuda_scan.segmented_sum_scan(f, w)], [cuda_scan.segmented_sum_scan_plain(f, w)], f"S {what}")
        check_x(f, x, what)

    cases = [("one segment", (1 << 20) + 3), ("one segment", (1 << 23) + 5), ("no flag", 3 * tile + 5),
             ("every row", tile + 1), ("every row", (1 << 20) + 3)]
    xtile = 2 * tile  # X's tile (seg_scan.cu kXorRows)
    cases += [("random", m) for m in (tile - 1, tile, tile + 1, 3 * tile + 5, xtile - 1, xtile + 1)]
    for kind, n in cases:
        check(*inputs(n, kind), f"{kind} n={n}")
    for kind, n in (("random", 70001), ("one segment", 3 * tile + 6)):
        f, a, b, w, x = (v[1:] for v in inputs(n, kind))
        if a.data_ptr() % 16 != 8 or w.data_ptr() % 16 != 8:
            raise AssertionError("the offset views start on a 16-byte boundary")
        check(f, a, b, w, x, f"{kind} view at offset 1, n={n - 1}")
    views = 0
    for start in (2, 3):  # X's int32 rows 8 and 12 bytes past a 16-byte boundary (4 is above)
        for kind, n in (("random", 70001), ("one segment", 3 * tile + 6)):
            f, _, _, _, x = inputs(n, kind)
            if x[start:].data_ptr() % 16 != 4 * start:
                raise AssertionError("X's offset view is not where it should be")
            check_x(f[start:], x[start:], f"{kind} view at row {start}, n={n - start}")
            views += 1
    first, second = inputs(3 * tile + 5, "random"), inputs(3 * tile + 5, "one segment")
    got = [cuda_scan.segmented_sum_scan(first[0], first[3]), cuda_scan.segmented_xor_scan(second[0], second[4]),
           cuda_scan.segmented_sum_scan(second[0], second[3]), cuda_scan.segmented_xor_scan(first[0], first[4]),
           *cuda_scan.segmented_max_scan(first[0], first[1], first[2]),
           *cuda_scan.segmented_max_scan(second[0], second[1], second[2])]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [cuda_scan.segmented_sum_scan(second[0], second[3]), cuda_scan.segmented_xor_scan(second[0], second[4]),
                *cuda_scan.segmented_max_scan(second[0], second[1], second[2], reverse=True)]
    torch.cuda.current_stream().wait_stream(side)
    want = [cuda_scan.segmented_sum_scan_plain(first[0], first[3]),
            cuda_scan.segmented_xor_scan_plain(second[0], second[4]),
            cuda_scan.segmented_sum_scan_plain(second[0], second[3]),
            cuda_scan.segmented_xor_scan_plain(first[0], first[4]),
            *cuda_scan.segmented_max_scan_plain(first[0], first[1], first[2]),
            *cuda_scan.segmented_max_scan_plain(second[0], second[1], second[2]),
            cuda_scan.segmented_sum_scan_plain(second[0], second[3]),
            cuda_scan.segmented_xor_scan_plain(second[0], second[4]),
            *cuda_scan.segmented_max_scan_plain(second[0], second[1], second[2], reverse=True)]
    same(got, want, "L, X and S back to back on one stream, then on a second stream")
    torch.cuda.synchronize()
    return len(cases) + 2 + views + 1


def owner_oracle(msgs, winners):
    """Path A's host oracle for one owner: `plan_batch` and the host
    Merkle fold. → (xor mask, upserts, deltas, digest)."""
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.storage.apply import plan_batch

    exp_xor, exp_upserts = plan_batch(msgs, winners)
    exp_deltas, digest = minute_deltas_host(m.timestamp for f, m in zip(exp_xor, msgs) if f)
    return exp_xor, exp_upserts, exp_deltas, digest


def path_a(torch, kernels, need, pool):
    """`reconcile_owner_batches` on config 3 against the host oracle,
    owner by owner in the processes of `pool`. → (launches, what path M1
    replays: the batches, winners, results, digest, wall and routes)."""
    from evolu_tpu_torch.parallel import reconcile_owner_batches

    t0 = time.perf_counter()
    batches, winners = owner_batches()
    n_msgs = sum(len(v) for v in batches.values())
    print(f"  path A: {n_msgs} messages, {len(batches)} owners built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    before = route_counts()
    reset(kernels)
    t0 = time.perf_counter()
    results, digest = reconcile_owner_batches(batches, winners)
    wall = time.perf_counter() - t0
    launches, routes = read(kernels), routes_since(before)
    print(f"  path A: reconcile_owner_batches {wall:.3f}s ({n_msgs / wall:,.0f} msgs/s "
          f"end to end incl. host columnarization); launches {launches}; routes {json.dumps(routes)}", flush=True)
    check_launched("path A", launches, need)
    t0 = time.perf_counter()
    want_digest = 0
    owners = list(batches)
    expected = pool.starmap(owner_oracle, [(batches[o], winners[o]) for o in owners], chunksize=25)
    for owner, (exp_xor, exp_upserts, exp_deltas, owner_digest) in zip(owners, expected):
        xor_mask, upserts, deltas = results[owner]
        want_digest ^= owner_digest
        if xor_mask != exp_xor or set(upserts) != set(exp_upserts) or deltas != exp_deltas:
            raise AssertionError(f"path A: owner {owner} differs from the host oracle")
    if digest != want_digest:
        raise AssertionError(f"path A: digest {digest:#x} != oracle {want_digest:#x}")
    print(f"  path A: every owner and digest {digest:#010x} equal the host oracle "
          f"({time.perf_counter() - t0:.1f}s in {ORACLE_PROCESSES} processes)", flush=True)
    return launches, {"batches": batches, "winners": winners, "results": results, "digest": digest,
                      "wall": wall, "messages": n_msgs, "routes": routes}


B_TABLES = {"todo": ("title", "isCompleted", "categoryId"), "todoCategory": ("name",)}


def b_db():
    from evolu_tpu_torch.core.types import TableDefinition
    from evolu_tpu_torch.storage import PySqliteDatabase, init_db_model, update_db_schema

    db = PySqliteDatabase()
    init_db_model(db, MNEMONIC)
    update_db_schema(db, [TableDefinition.of(t, c) for t, c in B_TABLES.items()])
    return db


def b_batches():
    """Path B's batches from seed 13 (the same in the card's process and in
    the oracle's): 100k messages in batches of 10k, a 5k re-delivery, then
    config 4's 64 replicas editing the same 100 rows."""
    from evolu_tpu_torch.core.types import CrdtMessage

    tables = B_TABLES
    rng = np.random.default_rng(13)
    n = 100_000
    table = np.where(rng.random(n) < 0.8, "todo", "todoCategory")
    row = rng.integers(0, 8000, n)
    col = rng.integers(0, 3, n)
    # Timestamps are unique per message, as HLC stamps are: __message
    # keys on the timestamp, so two cells sharing one would be a
    # different (and unrealistic) workload. Millis are shuffled so cells
    # still see out-of-order and concurrent writes.
    ts = ts_strings(BASE_MILLIS + rng.permutation(n) * 36, rng.integers(0, 4, n),
                    rng.integers(0, 64, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
    msgs = [
        CrdtMessage(s, t, f"{t}{r:08d}", tables[t][c % len(tables[t])], f"value{i % 977}")
        for i, (s, t, r, c) in enumerate(zip(ts, table.tolist(), row.tolist(), col.tolist()))
    ]
    batches = [msgs[i:i + 10_000] for i in range(0, n, 10_000)]
    batches.append(msgs[:5000])  # re-delivery: duplicates against stored winners
    # Config 4: 64 replicas edit the same 100 rows in the same
    # millisecond per row; counter and node break the ties.
    nodes = [f"{(r * 0x9E3779B97F4A7C15) % 2**64:016x}" for r in range(64)]
    hot = []
    for r in range(64):
        t_ms = BASE_MILLIS + 7_200_000 + np.arange(100)
        hot += [CrdtMessage(s, "todo", f"hot{k:03d}", "title", f"replica{r}")
                for k, s in enumerate(ts_strings(t_ms, rng.integers(0, 3, 100),
                                                 np.full(100, int(nodes[r], 16), dtype=np.uint64)))]
    batches.append(hot)
    return batches


def b_state(db, tree):
    """Every table of path B (digests of their rows in key order) and the tree."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string

    return ({t: digest(db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2')) for t in ("__message", *B_TABLES)},
            merkle_tree_to_string(tree))


def b_oracle():
    """Path B's sequential oracle, run in a process of the spawned pool
    while the card runs paths M1 to B (it ran after B's card side, 10 s,
    until the cut for path Q). → (`b_state`, its wall)."""
    from evolu_tpu_torch.storage import apply_messages_sequential

    db, tree = b_db(), {}
    t0 = time.perf_counter()
    for b in b_batches():
        tree = apply_messages_sequential(db, tree, b)
    return b_state(db, tree), time.perf_counter() - t0


def path_b(torch, kernels, need, oracle_job):
    """SQLite apply through the device planner against the sequential
    oracle of the pool (`b_oracle`): every table (by digest) and the tree
    equal. → launches."""
    from evolu_tpu_torch.ops.merge import plan_batch_device_full
    from evolu_tpu_torch.storage import apply_messages

    batches = b_batches()
    db, tree = b_db(), {}
    reset(kernels)
    t0 = time.perf_counter()
    for b in batches:
        tree = apply_messages(db, tree, b, planner=plan_batch_device_full)
    wall = time.perf_counter() - t0
    launches = read(kernels)
    total = sum(len(b) for b in batches)
    print(f"  path B: {total} messages in {len(batches)} batches applied in {wall:.3f}s "
          f"({total / wall:,.0f} msgs/s incl. SQLite); launches {launches}", flush=True)
    check_launched("path B", launches, need)
    t0 = time.perf_counter()
    (want_tables, want_tree), oracle_wall = oracle_job.get()
    waited = time.perf_counter() - t0
    got_tables, got_tree = b_state(db, tree)
    bad = [t for t in want_tables if got_tables[t] != want_tables[t]]
    if bad:
        raise AssertionError(f"path B: tables {bad} differ from the sequential oracle")
    if got_tree != want_tree:
        raise AssertionError("path B: Merkle tree differs from the sequential oracle")
    print(f"  path B: every table and the Merkle tree byte-identical to the sequential oracle of the pool "
          f"({oracle_wall:.1f}s there; waited {waited:.1f}s for it)", flush=True)
    return launches


def record_calls(orig, slot, calls):
    """Wrap a dispatcher in its calling module: append every call's
    arguments to `calls[slot]`, then run it."""
    def run(*a, **kw):
        calls.setdefault(slot, []).append((a, kw))
        return orig(*a, **kw)
    return run


def check_launched(what, launches, names):
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} never launched: {launches}")


def list_forest(rng, n, n_cells):
    """RGA elements in the device layout (ascending (cell, tag), parents
    below their children): per cell, 30% head inserts, 60% anchored on a
    random earlier element, 10% dangling origins (orphans at the head);
    20% tombstoned. → (cell_id, parent_ix, alive, origin_kind)."""
    per = -(-n // n_cells)
    j = np.arange(n) % per
    cell_id = (np.arange(n) // per).astype(np.int32)
    roll = rng.random(n)
    earlier = (rng.random(n) * j).astype(np.int64)
    anchored = (roll >= 0.3) & (roll < 0.9) & (j > 0)
    parent = np.where(anchored, np.arange(n) - j + earlier, -1).astype(np.int32)
    alive = (rng.random(n) < 0.8).astype(np.int32)
    return cell_id, parent, alive, roll >= 0.9


def list_oracle(cell_id, parent, alive, dangling):
    """Positions from the host oracle `crdt_list.linearize`, cell by
    cell, and the alive slots they imply."""
    from evolu_tpu_torch.core.crdt_list import linearize

    n = len(cell_id)
    pos = np.empty(n, np.int32)
    bounds = np.flatnonzero(np.diff(cell_id)) + 1
    for lo, hi in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [n]])):
        tags = [f"{i:07d}" for i in range(lo, hi)]
        origins = [tags[p - lo] if p >= 0 else ("zzzz-dangling" if d else "")
                   for p, d in zip(parent[lo:hi].tolist(), dangling[lo:hi].tolist())]
        pos[lo:hi] = linearize(tags, origins)
    order = np.lexsort((pos, cell_id))
    a = alive[order].astype(np.int64)
    run = np.cumsum(a)
    starts = np.r_[True, cell_id[order][1:] != cell_id[order][:-1]]
    base = np.maximum.accumulate(np.where(starts, run - a, 0))
    slot = np.empty(n, np.int32)
    slot[order] = np.where(a > 0, run - base - 1, -1)
    return pos, slot


def tensor_inputs(rng, n, width, monoid):
    """Masked contributions as `crdt_tensor._materialize_device` builds
    them, vectorized: quantized values × count (sum, mean) or monotone
    keys (max). → (contrib u64 (n, width), f32 values, counts)."""
    vals = (rng.random((n, width)) * 64.0 - 32.0).astype(np.float32)
    counts = rng.integers(1, 9, n) if monoid == "mean" else np.ones(n, np.int64)
    if monoid == "max":
        b = vals.view(np.uint32)
        keys = np.where(b >> 31 != 0, ~b, b | np.uint32(0x80000000)).astype(np.uint32)
        return keys.astype(np.uint64), vals, counts
    q = np.rint(vals.astype(np.float64) * 65536.0).astype(np.int64).view(np.uint64)
    return q * counts.astype(np.uint64)[:, None], vals, counts


def path_c1(torch, kernels, captured):
    """The typed folds at the repo's benchmark sizes against the port's
    host oracles. Returns (launches, report)."""
    from evolu_tpu_torch.core import crdt_tensor as tz
    from evolu_tpu_torch.core.crdt_types import fold_counter_ops
    from evolu_tpu_torch.ops import crdt_merge as cm
    from evolu_tpu_torch.ops import crdt_list_merge as lm
    from evolu_tpu_torch.ops import crdt_tensor_merge as tm
    from evolu_tpu_torch.ops import to_host_many

    rng = np.random.default_rng(21)
    t0 = time.perf_counter()
    n_c, cells_c = 1 << 20, 1 << 18
    c_cell = rng.integers(0, cells_c, n_c).astype(np.int32)
    c_delta = rng.integers(-(2**31) + 1, 2**31, n_c).astype(np.int64)
    n_l, cells_l = (1 << 20) - 2, 1 << 12
    l_cell, l_parent, l_alive, l_dangling = list_forest(rng, n_l, cells_l)
    n_t, width, cells_t = 1 << 20, 8, 1 << 15
    t_cell = rng.integers(0, cells_t, n_t).astype(np.int32)
    t_in = {m: tensor_inputs(rng, n_t, width, m) for m in ("sum", "mean", "max")}
    n_s, owners, per_owner = 1_000_000, 1000, 256
    s_owner = rng.integers(0, owners, n_s).astype(np.int32)
    s_cell = (s_owner.astype(np.int64) * per_owner + rng.integers(0, per_owner, n_s)).astype(np.int32)
    s_delta = rng.integers(-(2**31) + 1, 2**31, n_s).astype(np.int64)
    s_contrib = rng.integers(0, 2**64, (n_s, width), dtype=np.uint64)
    print(f"  path C1: inputs built in {time.perf_counter() - t0:.1f}s", flush=True)

    walls, out = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t

    def counter_shard():
        dev = [torch.from_numpy(a).cuda() for a in (s_owner, s_cell, s_delta)]
        return to_host_many(*cm.counter_shard_sums_core(*dev))

    reset(kernels)
    with patched(cm, "segmented_sum_scan", record_calls(cm.segmented_sum_scan, "S_counter", captured)), \
         patched(tm, "segmented_sum_scan", record_calls(tm.segmented_sum_scan, "S_tensor_sum", captured)):
        timed("pn_counter_sums", lambda: cm.pn_counter_sums(c_cell, c_delta, cells_c))
        timed("rga_order", lambda: lm.rga_order(l_cell, l_parent, l_alive))
        for m in ("sum", "mean", "max"):
            timed(f"tensor_cell_folds_{m}", lambda m=m: tm.tensor_cell_folds(t_cell, t_in[m][0], cells_t, m))
        timed("counter_shard_sums_core", counter_shard)
        timed("tensor_shard_sums", lambda: tm.tensor_shard_sums(s_owner, s_cell, s_contrib))
    launches = read(kernels)
    print(f"  path C1: walls {json.dumps({k: round(v, 4) for k, v in walls.items()})}; "
          f"launches {launches}", flush=True)
    check_launched("path C1", launches, ["seg_sum_scan", "seg_lex_max_scan"])

    t0 = time.perf_counter()
    # Counter: fold_counter_ops per cell, the host fold.
    order = np.argsort(c_cell, kind="stable")
    bounds = np.flatnonzero(np.diff(c_cell[order])) + 1
    pos_w, neg_w = np.zeros(cells_c, np.int64), np.zeros(cells_c, np.int64)
    for idx in np.split(order, bounds):
        pos_w[c_cell[idx[0]]], neg_w[c_cell[idx[0]]] = fold_counter_ops(c_delta[idx].tolist())
    pos, neg = out["pn_counter_sums"]
    if not (np.array_equal(pos, pos_w) and np.array_equal(neg, neg_w)):
        raise AssertionError("path C1: pn_counter_sums differs from the host fold")
    # List: linearize cell by cell.
    want_pos, want_slot = list_oracle(l_cell, l_parent, l_alive, l_dangling)
    if not (np.array_equal(out["rga_order"][0], want_pos) and np.array_equal(out["rga_order"][1], want_slot)):
        raise AssertionError("path C1: rga_order differs from crdt_list.linearize")
    # Tensor: the accumulators (modular add / integer max), and the
    # finalized bytes of sampled cells against `_fold_contributions`.
    for m in ("sum", "mean", "max"):
        contrib, vals, counts = t_in[m]
        acc = np.zeros((cells_t, width), np.uint64)
        (np.maximum if m == "max" else np.add).at(acc, t_cell, contrib)
        got = out[f"tensor_cell_folds_{m}"]
        if not np.array_equal(got, acc):
            raise AssertionError(f"path C1: tensor_cell_folds {m} differs from the host accumulator")
        cfg = tz.parse_tensor_type(f"tensor:{m}:f32:{width}")
        for c in rng.choice(cells_t, 64, replace=False):
            rows = np.flatnonzero(t_cell == c)
            contribs = [("d", int(counts[i]), vals[i].tobytes()) for i in rows]
            den = int(counts[rows].sum()) if m == "mean" else 1
            if tz._finalize(cfg, got[c], den) != tz._fold_contributions(cfg, contribs):
                raise AssertionError(f"path C1: tensor {m} cell {c} differs from _fold_contributions")
    # Shard folds: per (owner, cell) totals against numpy.
    grp, seg_end, pos_sum, neg_sum = out["counter_shard_sums_core"]
    want_p, want_n = np.zeros(owners * per_owner, np.int64), np.zeros(owners * per_owner, np.int64)
    np.add.at(want_p, s_cell, np.maximum(s_delta, 0))
    np.add.at(want_n, s_cell, np.maximum(-s_delta, 0))
    ends = np.flatnonzero(seg_end)
    g = grp[ends]
    touched = np.unique(s_cell)
    if not (np.array_equal(g & ((1 << 25) - 1), touched) and np.array_equal(g >> 25, touched // per_owner)
            and np.array_equal(pos_sum[ends], want_p[touched]) and np.array_equal(neg_sum[ends], want_n[touched])):
        raise AssertionError("path C1: counter_shard_sums_core differs from numpy")
    sums = out["tensor_shard_sums"]
    want_t = np.zeros((owners * per_owner, width), np.uint64)
    np.add.at(want_t, s_cell, s_contrib)
    if sorted(sums) != [(int(c) // per_owner, int(c)) for c in touched] or not all(
            np.array_equal(v.view(np.uint64), want_t[c]) for (_o, c), v in sums.items()):
        raise AssertionError("path C1: tensor_shard_sums differs from numpy")
    print(f"  path C1: every fold equals its host oracle ({time.perf_counter() - t0:.1f}s)", flush=True)
    report = {"rows": {"pn_counter_sums": n_c, "rga_order": n_l, "tensor_cell_folds": n_t * width,
                       "counter_shard_sums_core": n_s, "tensor_shard_sums": n_s * width},
              "wall_s": {k: round(v, 5) for k, v in walls.items()}}
    return launches, report


TYPED_COLUMNS = ("title", "votes:counter", "tags:awset", "body:list", "w:tensor:sum:f32:8",
                 "avg:tensor:mean:bf16:8", "peak:tensor:max:f32:8")


# C2's batches cut from 8 to 4 when path G was added, to keep the whole
# script inside its time limit.
def typed_traffic(rng, batches=4, per_column=5000, titles=1000, rows=2000, redeliver=10_000):
    """Typed ops in logical time order (unique timestamps), then shuffled
    across batches, so removes reach kills before their adds, list
    inserts land on deleted anchors and deletes precede inserts. 1% of
    typed ops are malformed. A last batch re-delivers `redeliver`
    messages."""
    import base64

    from evolu_tpu_torch.core.crdt_tensor import bf16_bits
    from evolu_tpu_torch.core.types import CrdtMessage

    cols = ["votes", "tags", "body", "w", "avg", "peak"] * per_column + ["title"] * titles
    cols = [cols[i] for i in rng.permutation(len(cols) * batches) % len(cols)]
    n = len(cols)
    ts = ts_strings(BASE_MILLIS + np.arange(n) * 3, rng.integers(0, 4, n),
                    rng.integers(0, 64, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
    row_ix = rng.integers(0, rows, n)
    vals = (rng.random((n, 8)) * 64 - 32).astype(np.float32)
    adds, inserts, msgs = {}, {}, []
    for i, (col, t, r) in enumerate(zip(cols, ts, row_ix.tolist())):
        row, roll = f"row{r:05d}", rng.random()
        if col != "title" and roll < 0.01:
            value = ("garbage", '["x"]', 2**40)[i % 3]
        elif col == "title":
            value = f"title{i}"
        elif col == "votes":
            value = int(rng.integers(-1000, 1000))
        elif col == "tags":
            seen = adds.setdefault(row, [])
            if seen and roll < 0.3:
                obs = sorted({seen[int(k)] for k in rng.integers(0, len(seen), 2)})
                value = json.dumps(["r", f"e{i % 16}", obs], separators=(",", ":"))
            else:
                value = json.dumps(["a", f"e{i % 16}"], separators=(",", ":"))
                seen.append(t)
        elif col == "body":
            seen = inserts.setdefault(row, [])
            if seen and roll < 0.25:
                value = json.dumps(["d", seen[int(rng.integers(0, len(seen)))]], separators=(",", ":"))
            else:
                origin = ("" if roll < 0.35 or not seen else "zzzz-dangling" if roll < 0.4
                          else seen[int(rng.integers(0, len(seen)))])
                value = json.dumps(["i", origin, f"v{i}"], separators=(",", ":"))
                seen.append(t)
        else:
            kind = "s" if roll < 0.1 else "d"
            if col == "avg":
                b64 = base64.b64encode(bf16_bits(vals[i]).astype("<u2").tobytes()).decode()
                value = json.dumps([kind, b64, int(rng.integers(1, 8))], separators=(",", ":"))
            else:
                b64 = base64.b64encode(vals[i].astype("<f4").tobytes()).decode()
                value = json.dumps([kind, b64], separators=(",", ":"))
        msgs.append(CrdtMessage(t, "board", row, col, value))
    msgs = [msgs[i] for i in rng.permutation(n)]
    size = n // batches
    out = [msgs[i * size:(i + 1) * size] for i in range(batches)]
    out.append([msgs[int(i)] for i in rng.integers(0, n, redeliver)])
    return out


# Every dispatcher of a kernel that path C2 reaches, in its calling module.
C2_DISPATCHERS = (
    ("merge", "segmented_max_scan", "L"), ("merge", "masked_key_hashes", "H"),
    ("merkle_ops", "segmented_xor_scan", "X"), ("crdt_merge", "segmented_sum_scan", "S"),
    ("crdt_list_merge", "segmented_sum_scan", "S"), ("crdt_tensor_merge", "segmented_sum_scan", "S"),
    ("crdt_tensor_merge", "segmented_max_scan", "L"),
)


# Path C2's tables, each with the key order its rows are compared in.
C2_ORDER = {"__message": "1", "board": "1", "__crdt_schema": "1, 2", "__crdt_counter": "1, 2, 3",
            "__crdt_set": "1", "__crdt_kill": "1", "__crdt_list": "1", "__crdt_list_kill": "1",
            "__crdt_tensor": "1"}


def c2_db():
    from evolu_tpu_torch.core.types import TableDefinition
    from evolu_tpu_torch.storage import PySqliteDatabase, init_db_model, update_db_schema

    db = PySqliteDatabase()
    init_db_model(db, MNEMONIC)
    update_db_schema(db, [TableDefinition.of("board", TYPED_COLUMNS)])
    return db


def c2_state(db, tree):
    """Every table of path C2 (digests of their rows in key order, and row
    counts) and the tree."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string

    rows = {t: db.exec(f'SELECT * FROM "{t}" ORDER BY {by}') for t, by in C2_ORDER.items()}
    return {t: (digest(r), len(r)) for t, r in rows.items()}, merkle_tree_to_string(tree)


def c2_oracle():
    """Path C2's sequential oracle with host folds (an independent oracle),
    run in a process of the spawned pool while the card runs paths M1 to
    C2 (it ran after C2's card side, 17 s, until the cut for path Q).
    → (`c2_state`, its wall)."""
    from evolu_tpu_torch.core import crdt_types
    from evolu_tpu_torch.storage import apply_messages_sequential

    db, tree = c2_db(), {}
    t0 = time.perf_counter()
    with patched(crdt_types, "DEVICE_FOLD_MIN", 10**12):  # host folds
        for b in typed_traffic(np.random.default_rng(29)):
            tree = apply_messages_sequential(db, tree, b)
    return c2_state(db, tree), time.perf_counter() - t0


def path_c2(torch, kernels, calls, oracle_job):
    """SQLite typed apply through the device planner and device folds,
    against the sequential oracle with host folds of the pool
    (`c2_oracle`). Every dispatcher call is appended to `calls[slot]`.
    Returns (launches, report)."""
    from evolu_tpu_torch.ops.merge import plan_batch_device_full
    from evolu_tpu_torch.storage import apply_messages

    t0 = time.perf_counter()
    batches = typed_traffic(np.random.default_rng(29))
    total = sum(len(b) for b in batches)
    print(f"  path C2: {total} messages in {len(batches)} batches built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    db, tree = c2_db(), {}
    with contextlib.ExitStack() as stack:
        for mod, name, slot in C2_DISPATCHERS:
            m = importlib.import_module(f"evolu_tpu_torch.ops.{mod}")
            stack.enter_context(patched(m, name, record_calls(getattr(m, name), slot, calls)))
        reset(kernels)
        t0 = time.perf_counter()
        for b in batches:
            tree = apply_messages(db, tree, b, planner=plan_batch_device_full)
        wall = time.perf_counter() - t0
        launches = read(kernels)
    print(f"  path C2: applied in {wall:.3f}s ({total / wall:,.0f} msgs/s incl. SQLite); "
          f"launches {launches}", flush=True)
    check_launched("path C2", launches, list(launches))
    for k in kernels:
        if len(calls.get(k["slot"], [])) != launches[k["name"]]:
            raise AssertionError(f"path C2: {len(calls.get(k['slot'], []))} recorded calls of "
                                 f"{k['name']}, {launches[k['name']]} launches")
    t0 = time.perf_counter()
    (want_tables, want_tree), oracle_wall = oracle_job.get()
    waited = time.perf_counter() - t0
    got_tables, got_tree = c2_state(db, tree)
    bad = [t for t in want_tables if got_tables[t] != want_tables[t]]
    if bad:
        raise AssertionError(f"path C2: tables {bad} differ from the sequential oracle")
    if got_tree != want_tree:
        raise AssertionError("path C2: Merkle tree differs from the sequential oracle")
    sizes = {t: n for t, (_d, n) in got_tables.items()}
    print(f"  path C2: every table ({json.dumps(sizes)} rows) and the Merkle tree byte-identical "
          f"to the sequential oracle of the pool ({oracle_wall:.1f}s there; waited {waited:.1f}s for it)",
          flush=True)
    return launches, {"messages": total, "batches": len(batches), "wall_s": round(wall, 4),
                      "msgs_per_s": round(total / wall), "oracle_wall_s": round(oracle_wall, 4),
                      "rows": sizes}


# Receives of D2 and D3, cut from 8 and 4 + 2 to keep the whole script well
# inside its time limit once path F was added.
# D2 cut from 5 to 3 Receives, D3's churn from 2 to 1 and its steady
# Receives from 2 to 1 when path G was added, to keep the whole script
# inside its time limit.
D2_BATCHES, D3_CHURN, D3_STEADY = 3, 1, 1
D4_SEND, D4_REMOTE = 1000, 200  # D4's local mutations and received messages
D_TABLES = {"todo": ("title", "isCompleted", "categoryId"), "todoCategory": ("name",),
            "todoNote": ("text",)}
D1_BASE = BASE_MILLIS - 1_000_000_000  # a restored device's history, before the live traffic


def config2_batch(batch_no, n, rotate=False, seed=2):
    """`benchmarks/winner_cache.build_batch` as port messages: the config-2
    todo shape over one persistent 5k-row population, or with `rotate` a
    fresh row namespace every batch; 8 nodes; timestamps unique (millis
    step every 4 messages, counter 0..3)."""
    import random

    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, Timestamp

    rng = random.Random(seed + batch_no)
    tables = list(D_TABLES.items())
    nodes = [f"{rng.getrandbits(64):016x}" for _ in range(8)]
    base = BASE_MILLIS + batch_no * 40_000_000
    prefix = f"b{batch_no}_" if rotate else ""
    out = []
    for i in range(n):
        table, cols = rng.choice(tables)
        out.append(CrdtMessage(timestamp_to_string(Timestamp(base + i // 4, i % 4, rng.choice(nodes))),
                               table, f"{prefix}row{rng.randrange(5000)}", rng.choice(cols), f"v{i}"))
    return base, out


def d1_history(n=1 << 19, rows=26_843, seed=3):
    """A restored device's initial sync: n messages over ~2^17 cells of the
    config-2 shape (5 cells a row), 16 messages a millisecond so the
    history spans 32.8 s, inside the 60 s drift bound of one receive."""
    import random

    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, Timestamp

    rng = random.Random(seed)
    tables = list(D_TABLES.items())
    nodes = [f"{rng.getrandbits(64):016x}" for _ in range(8)]
    return [CrdtMessage(timestamp_to_string(Timestamp(D1_BASE + i // 16, i % 16, rng.choice(nodes))),
                        t, f"row{rng.randrange(rows)}", rng.choice(cols), f"h{i}")
            for i in range(n) for t, cols in [rng.choice(tables)]]


D_QUERIES = (
    ('SELECT * FROM "todo" ORDER BY "id" LIMIT 100', ()),
    ('SELECT COUNT(*) AS "n" FROM "todo"', ()),
    ('SELECT * FROM "todo" WHERE "id" = ?', ("row7",)),
    ('SELECT "id", "title" FROM "todo" WHERE "id" IN (?, ?, ?)', ("row1", "row2", "local3")),
    ('SELECT * FROM "todo" WHERE "isCompleted" = ? ORDER BY "id" LIMIT 20', ("v3",)),
    ('SELECT * FROM "todoCategory" ORDER BY "id" LIMIT 50', ()),
    ('SELECT "name" FROM "todoCategory" WHERE "id" = ?', ("row11",)),
    ('SELECT COUNT(*) AS "n", MAX("id") AS "m" FROM "todoCategory"', ()),
    ('SELECT * FROM "todoNote" ORDER BY "id" DESC LIMIT 10', ()),
    ('SELECT COUNT(*) AS "n" FROM "todoNote" WHERE "text" IS NOT NULL', ()),
)


class DWorker:
    """One port `DbWorker` of path D with its outputs, pushes and a
    scripted wall clock that both workers read the same way."""

    def __init__(self, name, config, clock, device=None, db=None, mesh_ctx=None):
        from evolu_tpu_torch.core import timestamp as ts_mod
        from evolu_tpu_torch.core.types import TableDefinition
        from evolu_tpu_torch.runtime import messages as msg
        from evolu_tpu_torch.runtime.worker import DbWorker
        from evolu_tpu_torch.storage import PySqliteDatabase

        self.name, self.outputs, self.pushes, self.walls = name, [], [], {}
        self.worker = DbWorker(db or PySqliteDatabase(), config, on_output=self.outputs.append,
                               post_sync=self.pushes.append, now=lambda: clock["now"], device=device,
                               mesh_ctx=mesh_ctx)
        # init_db_model seeds __clock with a random node id: one for all.
        with patched(ts_mod, "create_node_id", lambda: "0f1e2d3c4b5a6978"):
            self.worker.start(MNEMONIC)
        self.run("setup", msg.UpdateDbSchema(tuple(TableDefinition.of(t, c) for t, c in D_TABLES.items())))

    @property
    def cache(self):
        return getattr(self.worker._planner, "cache", None)

    def run(self, phase, command):
        """Post one command, wait for it, add its wall time to `phase`
        and return it; any OnError fails the run."""
        from evolu_tpu_torch.runtime import messages as msg

        n_out = len(self.outputs)
        t0 = time.perf_counter()
        self.worker.post(command)
        self.worker.flush()
        wall = time.perf_counter() - t0
        self.walls[phase] = self.walls.get(phase, 0.0) + wall
        errors = [o.error for o in self.outputs[n_out:] if isinstance(o, msg.OnError)]
        if errors:
            raise AssertionError(f"path D: {self.name} worker answered OnError: {errors!r}") from errors[0]
        return wall

    def receive(self, phase, messages, tree="{}", previous_diff=None):
        """A Receive (a message sequence, or a PackedReceive as it is); on a
        worker with a cache, then the audit of every live slot against
        SQLite. → the route and the cache's counts."""
        from evolu_tpu_torch.core.packed import PackedReceive
        from evolu_tpu_torch.runtime import messages as msg

        cache = self.cache
        before = dict(cache.counts) if cache is not None else {}
        if not isinstance(messages, PackedReceive):
            messages = tuple(messages)
        wall = self.run(phase, msg.Receive(messages, tree, previous_diff))
        if cache is None:
            return {"wall_s": wall}
        checked = self.worker.verify_winner_cache()
        if checked != len(cache._slots):
            raise AssertionError(f"path D: verify_winner_cache checked {checked} of {len(cache._slots)} slots")
        plans = {k[:-6]: v - before.get(k, 0) for k, v in cache.counts.items()
                 if k.endswith("_plans") and v != before.get(k, 0)}
        return {"wall_s": wall, "plans": plans, "slots": len(cache._slots), "ewma": round(cache._seed_ewma, 4)}

    def stop(self):
        self.worker.stop()


def server_trees(batches):
    """The relay's Merkle tree string after each batch: the previous one
    with the batch's per-minute hash deltas XORed in. Every message of
    path D has a timestamp of its own and arrives once, so every one
    XORs; the deltas come from the port's planner with no stored winners,
    folded by `e_trees` (the plain hash on the CPU, no kernel launch). A
    Receive that carries the tree its client will hold after applying the
    batch leaves no diff, so no resend: what a relay answers after a full
    sync."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.ops.host_parse import parse_timestamp_strings

    trees, out = {}, []
    for batch in batches:
        millis, counter, node = parse_timestamp_strings([m.timestamp for m in batch])
        e_trees(trees, np.zeros(len(batch), np.int64), millis, counter, node)
        out.append(merkle_tree_to_string(trees[0]))
    return out


@contextlib.contextmanager
def bulk_reader(db):
    """`db` for bulk reads. A database on the C++ layer is copied first
    with `VACUUM INTO` to a temporary file and read through the stdlib
    module: the copy holds the same rows and values, and its one-call
    fetch costs a fraction of the C++ layer's per-cell ctypes reads at a
    million rows."""
    from evolu_tpu_torch.storage.native import CppSqliteDatabase
    from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

    if not isinstance(db, CppSqliteDatabase):
        yield db
        return
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "copy.db")
        db.exec(f"VACUUM INTO '{path}'")
        copy = PySqliteDatabase(path)
        try:
            yield copy
        finally:
            copy.close()


def d_dump(db):
    """Every table of a client, rows in key order."""
    out = {}
    with bulk_reader(db) as r:
        for (t,) in r.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name"):
            cols = len(r.exec(f'PRAGMA table_info("{t}")'))
            out[t] = r.exec(f'SELECT * FROM "{t}" ORDER BY {"1, 2" if cols > 1 else "1"}')
    return out


def d_outputs(worker):
    out = []
    for o in worker.outputs:
        name = type(o).__name__
        out.append((name, o.queries_patches, o.on_complete_ids) if name == "OnQuery"
                   else (name, o.owner) if name == "OnInit" else (name,))
    return out


def d_pushes(worker):
    return [(r.messages, r.clock_timestamp, r.merkle_tree, r.owner, r.previous_diff) for r in worker.pushes]


def d_inputs():
    """Path D's receives: D1 (2^19 messages), D2_BATCHES of 100k over a
    steady population, D3_CHURN of 50k over fresh rows and D3_STEADY over
    the steady rows, as (base millis, messages), and the relay's tree after
    each (`server_trees`). The same in the card's process and the oracle's."""
    d1 = d1_history()
    d2 = [config2_batch(b, 100_000) for b in range(D2_BATCHES)]
    # Batch numbers keep rising, so each batch's millis (and the clock) do.
    d3 = [config2_batch(8 + b, 50_000, rotate=True) for b in range(D3_CHURN)]
    d3 += [config2_batch(12 + b, 50_000) for b in range(D3_STEADY)]
    trees = server_trees([d1] + [b for _, b in d2 + d3])
    return d1, d2, d3, trees


def d_script(w, clock, d1, d2, d3, trees, after_d1=None, after_d2_first=None):
    """Drive one DWorker through path D: D1, D2 and D3's Receives, each with
    the relay's tree after it; then D4: a Send of 1k, a Query of 10
    subscribed queries, a Sync, a Receive of 200 whose server tree holds
    one hash the client lacks (in a minute after all of its history), and a
    Query. `after_d1(w)` runs between D1 and D2, `after_d2_first(w)` after
    D2's first Receive. → each phase's Receive routes."""
    from evolu_tpu_torch.core.merkle import insert_into_merkle_tree, merkle_tree_to_string
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, NewCrdtMessage, Timestamp
    from evolu_tpu_torch.runtime import messages as msg
    from evolu_tpu_torch.storage.clock import read_clock

    routes = {"d1": [], "d2": [], "d3": []}
    # The device's wall clock as each batch arrives: its oldest stamp (a
    # receive of more than 65,535 messages older than `now` overflows the
    # HLC counter, one `now` a command and +1 a message, in the reference
    # too).
    clock["now"] = D1_BASE
    routes["d1"].append(w.receive("d1", d1, trees[0]))
    if after_d1 is not None:
        after_d1(w)
    for i, ((base, batch), tree) in enumerate(zip(d2, trees[1:])):
        clock["now"] = base
        routes["d2"].append(w.receive("d2", batch, tree))
        if i == 0 and after_d2_first is not None:
            after_d2_first(w)
    for (base, batch), tree in zip(d3, trees[1 + len(d2):]):
        clock["now"] = base
        routes["d3"].append(w.receive("d3", batch, tree))
    clock["now"] = BASE_MILLIS + 5_000_000_000
    queries = tuple(msg.serialize_query(q, p) for q, p in D_QUERIES)
    local = tuple(NewCrdtMessage(*(("todo", f"local{i}", "title", f"mine{i}") if i % 2 else
                                   ("todoNote", f"local{i}", "text", f"note{i}"))) for i in range(D4_SEND))
    remote = [CrdtMessage(timestamp_to_string(Timestamp(clock["now"] - 30_000 + i, 0, "00000000000000d4")),
                          "todoCategory", f"row{i}", "name", f"cat{i}") for i in range(D4_REMOTE)]
    w.run("d4", msg.Send(local, ("sent",), queries))
    w.run("d4", msg.Query(queries))
    w.run("d4", msg.Sync(queries))
    server = merkle_tree_to_string(insert_into_merkle_tree(
        Timestamp(clock["now"] + 120_000, 0, "00000000000000e5"), read_clock(w.worker.db).merkle_tree))
    w.receive("d4", remote, server)
    w.run("d4", msg.Query(queries))
    return routes


def d_state(w):
    """A worker's outputs, pushes, each table's digest and row count, and
    its Merkle tree: what path D and G1 hold the card worker to."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.storage.clock import read_clock

    return {"outputs": d_outputs(w), "pushes": d_pushes(w),
            "tables": {t: (digest(rows), len(rows)) for t, rows in d_dump(w.worker.db).items()},
            "tree": merkle_tree_to_string(read_clock(w.worker.db).merkle_tree)}


def d_oracle():
    """Path D's oracle, run in a process of the spawned pool while the card
    runs paths B to D: a `backend="cpu"` worker through `d_script`. → its
    `d_state` after D1 (path M3's oracle), after D2's first Receive (paths
    G1's and N4's) and at the end, and its walls."""
    from evolu_tpu_torch.utils.config import Config

    d1, d2, d3, trees = d_inputs()
    clock = {"now": D1_BASE}
    cpu = DWorker("cpu oracle", Config(backend="cpu", receive_chunk_size=1 << 17), clock)
    after_d1, after_d2_first = {}, {}
    d_script(cpu, clock, d1, d2, d3, trees, after_d1=lambda w: after_d1.update(d_state(w)),
             after_d2_first=lambda w: after_d2_first.update(d_state(w)))
    out = {"after_d1": after_d1, "after_d2_first": after_d2_first, "end": d_state(cpu), "walls": dict(cpu.walls)}
    cpu.stop()
    return out


def path_d(torch, kernels, oracle_job):
    """The client DbWorker on the card (`backend="auto"`, the winner cache,
    `device=None`) through `d_script`, against a `backend="cpu"` worker fed
    the same commands in a process of the pool (`oracle_job`, `d_oracle`):
    outputs, pushes, every table (by digest) and the tree equal. Returns
    (launches, report, the relay's trees after D1 and D2's first batch, D1
    and that batch as (base, messages), and the oracle's states after D1
    and after D2's first Receive: path M3 replays D1 against the first,
    paths G1 and N4 D1 and D2's first batch against the second)."""
    from evolu_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    d1, d2, d3, trees = d_inputs()
    print(f"  path D: {len(d1) + sum(len(b) for _, b in d2 + d3)} messages and the relay's trees "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    clock = {"now": D1_BASE}
    gpu = DWorker("gpu", Config(backend="auto", winner_cache=True, receive_chunk_size=1 << 17), clock)
    reset(kernels)
    routes = d_script(gpu, clock, d1, d2, d3, trees)
    launches = read(kernels)
    counts = dict(gpu.cache.counts)
    device_plans = counts.get("cached_plans", 0) + counts.get("stream_plans", 0)
    print(f"  path D: launches {launches}; device-planned chunks and batches {device_plans}; "
          f"cache counts {json.dumps(counts)}", flush=True)
    pushes = d_pushes(gpu)
    if [p[4] is not None for p in pushes] != [False] * (len(pushes) - 1) + [True]:
        raise AssertionError("path D: a request with previous_diff should be the last push, and the only one")
    t0 = time.perf_counter()
    oracle = oracle_job.get()
    waited = time.perf_counter() - t0
    t0 = time.perf_counter()
    mine, want = d_state(gpu), oracle["end"]
    if mine["outputs"] != want["outputs"]:
        raise AssertionError("path D: outputs differ from the backend='cpu' oracle")
    if mine["pushes"] != want["pushes"]:
        raise AssertionError("path D: sync pushes differ from the backend='cpu' oracle")
    bad = sorted(t for t in set(mine["tables"]) | set(want["tables"]) if mine["tables"].get(t) != want["tables"].get(t))
    if bad or mine["tree"] != want["tree"]:
        raise AssertionError(f"path D: tables {bad} or the Merkle tree differ from the backend='cpu' oracle")
    sizes = {t: n for t, (_d, n) in want["tables"].items()}
    print(f"  path D: outputs ({len(gpu.outputs)}), pushes ({len(pushes)}), every table "
          f"({json.dumps(sizes)} rows) and the tree byte-identical to the backend='cpu' oracle of the pool "
          f"(waited {waited:.1f}s for it; compared in {time.perf_counter() - t0:.1f}s)", flush=True)
    n = {"d1": len(d1), "d2": sum(len(b) for _, b in d2), "d3": sum(len(b) for _, b in d3), "d4": D4_SEND + D4_REMOTE}
    owalls = oracle["walls"]
    report = {p: {"messages": n[p], "wall_s": round(gpu.walls[p], 4), "msgs_per_s": round(n[p] / gpu.walls[p]),
                  "oracle_wall_s": round(owalls[p], 4), "oracle_msgs_per_s": round(n[p] / owalls[p])}
              for p in n}
    for p in routes:
        for key in ("plans", "slots", "ewma", "wall_s"):
            report[p][key + "_per_receive"] = [r[key] if key != "wall_s" else round(r[key], 4)
                                               for r in routes[p]]
    short = {k["name"]: launches[k["name"]] for k in kernels if k["slot"] in "LHX"
             and launches[k["name"]] < device_plans * (2 if k["slot"] == "L" else 1)}
    if device_plans == 0 or short:
        raise AssertionError(f"path D: kernels launched fewer times than device plans ({device_plans}): {short}")
    if launches["seg_sum_scan"]:
        raise AssertionError(f"path D: kernel S launched {launches['seg_sum_scan']} times on the LWW path")
    report["d4"]["commands"] = "Send 1k, Query x10, Sync, Receive 200 with a differing server tree, Query"
    report["cache_counts"] = counts
    report["rows"] = sizes
    report["oracle_in_pool_process"] = True
    gpu.stop()
    return (launches, report, trees[:2], [(D1_BASE, d1), d2[0]], (oracle["after_d1"], oracle["after_d2_first"]))


E_MESSAGES = 1_000_000  # BASELINE config 3: 1M messages over 1k owners
E_OWNERS = 1000
E4_ROWS = 1 << 14  # cut from 2^16 when path G was added; every route still taken
E_POOL = 8192
E_CONTENT_BYTES = 116  # the reference bench's v1 OpenPGP ciphertexts measure 115-116 B


def e_stamps(start, n, owners, rng):
    """benchmarks/config3_server_reconcile.py:67-90's stamps: message i
    goes to a random owner, at millis BASE + i // 16, counter i % 16,
    node f"{owner:015x}{r:x}". → (owner, millis, counter, node as
    np.uint64, timestamp strings), one entry a message."""
    from evolu_tpu_torch.core.timestamp import millis_to_iso

    i = np.arange(start, start + n, dtype=np.int64)
    owner = rng.integers(0, owners, n)
    node = owner.astype(np.uint64) * np.uint64(16) + rng.integers(0, 16, n).astype(np.uint64)
    millis, counter = BASE_MILLIS + i // 16, (i % 16).astype(np.int32)
    iso = {}
    stamps = []
    for m, c, d in zip(millis.tolist(), counter.tolist(), node.tolist()):
        s = iso.get(m)
        if s is None:
            s = iso[m] = millis_to_iso(m)
        stamps.append(f"{s}-{c:04X}-{d:016x}")
    return owner, millis, counter, node, stamps


def e_trees(trees, owner, millis, counter, node):
    """Each owner's tree in `trees` (a dict of tree dicts, updated) with its
    rows folded in, as its client holds it after applying its own
    messages: hashes by the plain version of kernel H on the CPU (the
    node hex is lower case), one XOR a (owner, minute) by numpy."""
    import torch

    from evolu_tpu_torch.core.merkle import apply_prefix_xors, minutes_base3
    from evolu_tpu_torch.core.murmur import to_int32
    from evolu_tpu_torch.ops.cuda_hash import timestamp_hashes_plain

    h = timestamp_hashes_plain(torch.from_numpy(millis), torch.from_numpy(counter),
                               torch.from_numpy(node.view(np.int64))).numpy().view(np.uint32)
    minute = millis // 60000
    order = np.lexsort((minute, owner))
    o_s, m_s = owner[order], minute[order]
    starts = np.flatnonzero(np.r_[True, (o_s[1:] != o_s[:-1]) | (m_s[1:] != m_s[:-1])])
    xors = np.bitwise_xor.reduceat(h[order], starts)
    deltas = {}
    for o, m, x in zip(o_s[starts].tolist(), m_s[starts].tolist(), xors.tolist()):
        deltas.setdefault(o, {})[minutes_base3(m * 60000)] = to_int32(x)
    for o, d in deltas.items():
        trees[o] = apply_prefix_xors(trees.get(o, {}), d)
    return trees


def e_tree(tree, stamps):
    """`tree` (a dict) with `stamps` folded in on the host, each hashed as
    its string reads (node case verbatim)."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, minute_deltas_host

    deltas, _ = minute_deltas_host(stamps)
    return apply_prefix_xors(tree, deltas)


def e_request(user, stamps, contents, tree, node="f" * 16):
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.sync import protocol

    msgs = tuple(protocol.EncryptedCrdtMessage(t, c) for t, c in zip(stamps, contents))
    return protocol.SyncRequest(msgs, user, node, tree if isinstance(tree, str) else merkle_tree_to_string(tree))


def ts_one(millis, counter, node):
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    return timestamp_to_string(Timestamp(millis, counter, node))


def protocol_messages(data):
    from evolu_tpu_torch.sync import protocol

    return protocol.decode_sync_response(data).messages


def e_dump(store):
    with bulk_reader(store.db) as r:
        return (r.exec('SELECT "userId", "timestamp", "content" FROM "message" ORDER BY 1, 2'),
                r.exec('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1'))


class Timed:
    """Host-clock time of named calls, swapped in on their owners (a
    class, a module or an instance) for the length of `on()`; a call with
    `sync` set is bracketed by torch.cuda.synchronize()."""

    def __init__(self, torch, swaps):
        self.torch, self.swaps, self.s = torch, swaps, {}

    def _timed(self, fn, name, sync):
        def run(*a, **kw):
            if sync:
                self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if sync:
                    self.torch.cuda.synchronize()
                self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
        return run

    @contextlib.contextmanager
    def on(self):
        self.s = {}
        with contextlib.ExitStack() as stack:
            for obj, attr, name, sync in self.swaps:
                stack.enter_context(patched(obj, attr, self._timed(getattr(obj, attr), name, sync)))
            yield self.s


def e_requests():
    """Path E's content pool and its E1, E2 and E3 requests, from seed 17
    (the same in the card's process and in the oracle's). E1 steady state,
    1M messages over 1k owners, each request with its post-apply tree; E2
    re-delivery, 100k new + 50k stored + 10k in-batch duplicates, half the
    owners with their tree from before E2; E3 cold sync of 25 owners."""
    rng = np.random.default_rng(17)
    pool = [bytes(b) for b in rng.integers(0, 256, (E_POOL, E_CONTENT_BYTES), dtype=np.uint8)]
    owner, millis, counter, node, stamps = e_stamps(0, E_MESSAGES, E_OWNERS, rng)
    by_owner = {}
    for i, o in enumerate(owner.tolist()):
        by_owner.setdefault(o, []).append(i)
    users = {o: f"owner{o:04d}" for o in range(E_OWNERS)}
    trees1 = e_trees({}, owner, millis, counter, node)
    e1 = [e_request(users[o], [stamps[i] for i in ix], [pool[i % E_POOL] for i in ix], trees1[o])
          for o, ix in by_owner.items()]
    # E2: new messages continuing E1's stamps, messages E1 stored, and
    # duplicates inside the batch, one request an owner.
    owner2, millis2, counter2, node2, stamps2 = e_stamps(E_MESSAGES, E_MESSAGES // 10, E_OWNERS, rng)
    new2 = {}
    for i, o in enumerate(owner2.tolist()):
        new2.setdefault(o, []).append((stamps2[i], pool[(E_MESSAGES + i) % E_POOL]))
    old_ix = rng.choice(len(stamps), E_MESSAGES // 20, replace=False)
    old2 = {}
    for i in old_ix.tolist():
        old2.setdefault(int(owner[i]), []).append((stamps[i], pool[i % E_POOL]))
    dup_ix = rng.choice(len(stamps2), E_MESSAGES // 100, replace=False)
    dups = {}
    for i in dup_ix.tolist():
        dups.setdefault(int(owner2[i]), []).append((stamps2[i], pool[(E_MESSAGES + i) % E_POOL]))
    trees2 = e_trees(dict(trees1), owner2, millis2, counter2, node2)
    e2 = []
    for o in sorted(set(new2) | set(old2)):
        rows = new2.get(o, []) + old2.get(o, []) + dups.get(o, [])
        tree = trees1.get(o, {}) if o % 2 == 0 else trees2.get(o, {})  # half: their tree from before E2
        e2.append(e_request(users[o], [t for t, _ in rows], [c for _, c in rows], tree))
    # E3: restored devices with empty trees pull their owner's whole history.
    e3 = [e_request(users[o], [], [], "{}", node="e" * 16) for o in range(25)]
    return pool, e1, e2, e3


def digest(obj) -> str:
    """sha256 of `obj` pickled: equal for equal lists of responses or rows
    (the same types on both sides)."""
    import hashlib
    import pickle

    return hashlib.sha256(pickle.dumps(obj, protocol=4)).hexdigest()


def e_oracle():
    """Path E's per-request oracle for E1, E2 and E3, run in a process of
    the spawned pool while the card runs paths B to D: `serve_single_request`
    request by request on a Python `RelayStore` (host hashing). → {step:
    (responses digest, message table digest, merkleTree table digest,
    rows, serve wall s)}."""
    from evolu_tpu_torch.server.relay import RelayStore, serve_single_request

    _pool, e1, e2, e3 = e_requests()
    store = RelayStore(backend="python")
    out = {}
    for name, requests in (("e1", e1), ("e2", e2), ("e3", e3)):
        t0 = time.perf_counter()
        responses = [serve_single_request(store, r) for r in requests]
        wall = time.perf_counter() - t0
        msgs, trees = e_dump(store)
        out[name] = (digest(responses), digest(msgs), digest(trees), len(msgs), wall)
    store.close()
    return out


def path_e(torch, kernels, captured, keep, oracle_job):
    """The relay's batched sync pass at config 3 on the card:
    `BatchReconciler(RelayStore(backend="python"), device=None).run_batch_wire`
    (the generic ingest) against `serve_single_request` request by request
    on a second Python `RelayStore` (host hashing). E1, E2 and E3 as
    `e_requests` makes them, their oracle run by `e_oracle` in a process of
    the pool (`oracle_job`, started after path A) and held by digest; E4, on
    fresh stores with a local oracle, a span of 2^32 ms (the 20-B upload), a
    batch whose every row has its own minute (cap overflow and the
    full-width rerun), one owner in upper-case hex (the host fold). After
    every step the responses, the `message` table and the `merkleTree` table
    equal the oracle's. `captured` gets E1's engine kernel inputs and its
    calls of H and X; `keep` E1's and E2's requests and responses, the store
    after E3 and its dump, which paths G2, H and I replay. Returns
    (launches, report)."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.ops import merkle_ops
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayStore, serve_single_request

    t0 = time.perf_counter()
    pool, e1, e2, e3 = e_requests()
    print(f"  path E: E1 {sum(len(r.messages) for r in e1)} messages over {len(e1)} owners, E2 and E3 "
          f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    oracle_steps = oracle_job.get()
    print(f"  path E: waited {time.perf_counter() - t0:.1f}s for the E1-E3 oracle of the pool", flush=True)

    store, oracle = RelayStore(backend="python"), None
    rec = eng.BatchReconciler(store)
    stages = Timed(torch, [(eng, "parse_timestamp_strings", "parse", False),
                           (eng, "columns_to_device", "upload", True),
                           (eng, "_merkle_shard_kernel_compact_delta", "device", True),
                           (eng, "_merkle_shard_kernel_compact", "device", True),
                           (eng, "_merkle_shard_kernel", "device", True),
                           (eng, "to_host_many", "pull", False),
                           (eng, "_decode_compact", "decode", False),
                           (eng, "decode_owner_minute_deltas", "decode", False),
                           (eng, "minute_deltas_host", "host_fold", False),
                           (rec, "_new_messages", "new_messages", False),
                           (rec, "_insert_new", "insert", False),
                           (rec, "_store_trees", "tree_updates", False),
                           (rec, "_respond_wire", "respond", False)])
    report, n_steps = {}, {}

    def keep_state(dispatch):
        def run(*a, **kw):
            state = dispatch(*a, **kw)
            captured.setdefault("path_e_state", state)
            return state
        return run

    def step(name, requests, timed=False, record=False):
        n = sum(len(r.messages) for r in requests)
        calls = {}
        with contextlib.ExitStack() as stack:
            if timed:
                s = stack.enter_context(stages.on())
            if record:
                stack.enter_context(patched(eng, "masked_key_hashes", record_calls(eng.masked_key_hashes, "H", calls)))
                stack.enter_context(patched(merkle_ops, "segmented_xor_scan",
                                            record_calls(merkle_ops.segmented_xor_scan, "X", calls)))
                stack.enter_context(patched(eng, "deltas_dispatch", keep_state(eng.deltas_dispatch)))
            t1 = time.perf_counter()
            got = rec.run_batch_wire(requests)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        if name in oracle_steps:  # held by digest against the pool's oracle
            want_responses, want_msgs, want_trees, _rows, oracle_wall = oracle_steps[name]
            t1 = time.perf_counter()
            mine = e_dump(store)
            theirs = (want_msgs, want_trees)
            if digest(got) != want_responses:
                raise AssertionError(f"path E {name}: the responses differ from the oracle's")
            ours = (digest(mine[0]), digest(mine[1]))
        else:
            t1 = time.perf_counter()
            want = [serve_single_request(oracle, r) for r in requests]
            oracle_wall = time.perf_counter() - t1
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
                raise AssertionError(f"path E {name}: response {bad} ({requests[bad].user_id}) differs from "
                                     "the oracle")
            t1 = time.perf_counter()
            mine, theirs = e_dump(store), e_dump(oracle)
            ours = mine
        if ours[0] != theirs[0]:
            raise AssertionError(f"path E {name}: the message table differs from the oracle")
        if ours[1] != theirs[1]:
            raise AssertionError(f"path E {name}: the merkleTree table differs from the oracle")
        rows = len(mine[0])
        if name == "e3":
            keep["store_dump"] = mine  # the store after E3, which paths H and I compare with
        del mine, theirs, ours
        out = {"requests": len(requests), "messages": n, "wall_s": round(wall, 4),
               "msgs_per_s": round(n / wall) if n else None, "oracle_wall_s": round(oracle_wall, 4),
               "oracle_msgs_per_s": round(n / oracle_wall) if n else None,
               "response_messages": sum(len(protocol_messages(b)) for b in got),
               "stored_rows": rows, "compare_s": round(time.perf_counter() - t1, 3)}
        if name in oracle_steps:
            out["oracle_in_pool_process"] = True
        if timed:
            out["stages_s"] = {k: round(v, 4) for k, v in s.items()}
            out["stages_s"]["other"] = round(wall - sum(s.values()), 4)
        if record:
            captured["path_e"] = calls
        if name in ("e1", "e2"):
            keep[name] = (requests, got)
        report[name] = out
        print(f"  path E {name}: {json.dumps(out)}", flush=True)

    reset(kernels)
    routes0 = dict(eng.counts)
    step("e1", e1, timed=True, record=True)
    step("e2", e2, timed=True)
    step("e3", e3)

    # E4: the other routes, about 64k rows each, on a fresh pair of stores
    # (their dumps then cost ~0.2 s, not ~5 s).
    keep["store"] = store
    store, oracle = RelayStore(backend="python"), RelayStore(backend="python")
    rec = eng.BatchReconciler(store)
    def e4(tag, millis, node_of):
        n = len(millis)
        per = {}
        for i, m in enumerate(millis):
            o = i % 64
            per.setdefault(o, []).append(ts_one(int(m), i % 16, node_of(o)))
        return [e_request(f"{tag}{o:02d}", s, [pool[i % E_POOL] for i in range(len(s))], e_tree({}, s))
                for o, s in per.items()]

    base4 = BASE_MILLIS + 10**9
    wide = base4 + np.arange(E4_ROWS) // 16
    wide[-E4_ROWS // 64:] += 1 << 32  # the last rows 2^32 ms later: the 20-B upload
    step("e4_span_2_32", e4("span", wide, lambda o: f"{o:016x}"))
    step("e4_cap_overflow", e4("minute", base4 + 2 * 10**9 + np.arange(E4_ROWS) * 60_000,
                                lambda o: f"{o:016x}"))
    step("e4_upper_case_hex", e4("hex", base4 + 3 * 10**9 + np.arange(E4_ROWS) // 16,
                                  lambda o: (f"{o:016x}" if o else "ABCDEF0123456789")))
    launches = read(kernels)
    carried = {k: v["response_messages"] for k, v in report.items()}
    if any(carried[k] for k in ("e1", "e4_span_2_32", "e4_cap_overflow", "e4_upper_case_hex")) \
            or not (carried["e2"] and carried["e3"]):
        raise AssertionError(f"path E: response messages {carried}: only E2's stale trees and E3 should carry any")
    routes = {k: eng.counts[k] - routes0[k] for k in ROUTES}
    report["route_counts"] = routes
    dispatches = routes["delta"] + routes["full"] + routes["overflow"]
    print(f"  path E: launches {launches}; route counts {json.dumps(routes)}", flush=True)
    want_routes = {"delta": 4, "full": 1, "overflow": 1, "host_owners": 1}
    if routes != want_routes:
        raise AssertionError(f"path E: routes {routes}, expected {want_routes}")
    for k in kernels:
        expect = dispatches if k["slot"] in "HX" else 0
        if launches[k["name"]] != expect:
            raise AssertionError(f"path E: {k['name']} launched {launches[k['name']]} times, expected {expect}")
    return launches, report


# ---- path F: the client handle with end-to-end encrypted sync -----------------------

F_TODO = {"todo": ("title", "isCompleted", "categoryId"), "todoCategory": ("name",)}
F_BOARD = {"board": ("title", "votes:counter", "tags:awset", "body:list", "w:tensor:sum:f32:8",
                     "avg:tensor:mean:f32:8", "peak:tensor:max:f32:8")}
F_BASE = BASE_MILLIS + 9_000_000_000  # after every stamp of paths A-E
F_MNEMONIC2 = "letter advice cage absurd amount doctor acoustic avoid letter advice cage above"
F_PARTS = ("encrypt", "relay", "decrypt", "apply")
# The scripted clock moves a minute between rounds. A pull answers every
# message since the first differing Merkle minute, so rounds inside one
# minute re-deliver older messages, and a re-delivered message that lost
# its cell to a later one is XORed into the client's tree again: the
# trees then never agree. That is an open fault of the reference that
# the port keeps, ROADMAP queue 3 item 2, pinned by
# tests/test_torch_apply.py::test_redelivered_loser_is_xored_again_as_in_jax.
F_ROUND_MS = 60_000
# F2: Sends of F2_CATS * 3 + F2_TODOS * 5 + F2_UPDATES * 2 = 10,000 messages.
# F2's Sends of 10k: 6 (10 until the cut for path Q; C restores after half of them).
F2_SENDS, F2_CATS, F2_TODOS, F2_UPDATES = 6, 200, 1600, 700
# F3's groups cut from 8 to 4 when path G was added.
F3_ROWS, F3_GROUPS, F3_CALLS = 256, 4, 2048


def pure_transport():
    """A `SyncTransport` class on the pure per-message loops alone: the
    oracle set's, independent of the native crypto leg."""
    from evolu_tpu_torch.sync import client as sync_client
    from evolu_tpu_torch.sync import protocol

    class PureTransport(sync_client.SyncTransport):
        def _encode_push(self, request, node_id, caps, use_v2, scope_clause=None):
            encrypted = sync_client.encrypt_messages_pure(request.messages, request.owner.mnemonic)
            body = protocol.encode_sync_request(
                protocol.SyncRequest(encrypted, request.owner.id, node_id, request.merkle_tree))
            body = body + protocol.encode_request_capabilities(caps) if caps else body
            return body + protocol.encode_request_scope(scope_clause)

        def _decode_response(self, response_bytes, mnemonic):
            response = protocol.decode_sync_response(response_bytes)
            return sync_client.decrypt_messages_pure(response.messages, mnemonic), response.merkle_tree

    return PureTransport


class FSet:
    """One set of path F's clients and its relay. The card's set runs the
    reference's defaults: clients `Evolu(..., device=None)` with storage
    `backend="auto"` (the native C++ SQLite layer), planner `backend="auto"`
    and the winner cache, the native crypto leg (fused push bodies, the
    columnar `PackedReceive` decode), and the relay
    `BatchReconciler(RelayStore()).run_batch_wire` on the card over the
    native store (the packed ingest). The oracle set: `backend="cpu"`
    clients on `device="cpu"` (host plans, host-side typed folds) over
    `PySqliteDatabase`, the pure crypto loops (`pure_transport`), and
    `serve_single_request` on a Python `RelayStore`. Each client syncs
    through a transport whose `http_post` answers in process; row ids,
    node ids, `now` and `now_iso` come from this set's own counters and
    scripted clock."""

    def __init__(self, name, on_card, http=False, path=":memory:"):
        from evolu_tpu_torch.server.engine import BatchReconciler
        from evolu_tpu_torch.server.relay import RelayServer, RelayStore, serve_single_request
        from evolu_tpu_torch.sync import protocol

        self.name, self.on_card = name, on_card
        self.device = None if on_card else "cpu"
        self.backend = "auto" if on_card else "python"
        self.server = self.url = self.engine = None
        if http:
            # Path H3: the clients POST over HTTP to a port relay, a batching
            # one on the card for the card set.
            self.server = RelayServer(RelayStore(path, backend=self.backend), batching=on_card,
                                      device=self.device).start()
            self.store, self.url = self.server.store, self.server.url + "/"
        else:
            self.store = RelayStore(backend=self.backend)
            self.engine = engine = BatchReconciler(self.store, device=self.device) if on_card else None
            self._answer = ((lambda r: engine.run_batch_wire([r])[0]) if on_card
                            else (lambda r: serve_single_request(self.store, r)))
            self._decode = protocol.decode_sync_request
        self.clock = {"now": F_BASE}
        self._ids, self._nodes = itertools.count(), itertools.count(1)
        self.clients, self.outputs, self.errors, self.faults = {}, {}, [], []
        self.parts = dict.fromkeys(F_PARTS, 0.0)
        self.decoded = {"packed": 0, "object": 0}  # responses by decode route
        self.walls = {}

    def post(self, url, body):
        """The transport's `http_post`. A relay fault becomes an HTTP 500,
        so the transport reports it through `on_error` and stays alive
        (any other exception would end its thread, and `flush` would then
        wait forever); `check` raises it with its own traceback."""
        t0 = time.perf_counter()
        try:
            return self._answer(self._decode(body))
        except Exception as e:  # noqa: BLE001 - kept in `faults`, raised by `check`
            self.faults.append(e)
            raise urllib.error.HTTPError(url, 500, f"relay fault: {e!r}", None, None) from e
        finally:
            self.parts["relay"] += time.perf_counter() - t0

    @contextlib.contextmanager
    def active(self):
        """Route id and node-id draws to this set's counters."""
        from evolu_tpu_torch.core import timestamp as ts_mod
        from evolu_tpu_torch.runtime import client as client_mod

        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(client_mod, "create_id", lambda: f"f{next(self._ids):020d}"))
            stack.enter_context(patched(ts_mod, "create_node_id", lambda: f"{next(self._nodes):016x}"))
            yield self

    def timed(self, fn, part):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.parts[part] += time.perf_counter() - t0
        return run

    def client(self, key, schema, mnemonic, hooks=False, scope=None):
        """A client on this set (create_hooks, or `Evolu` with the schema as
        create_evolu sets it), wired to the relay with a transport, its
        clock scripted, its outputs kept; `scope` is its `Config.sync_scope`. The transport's push encode and
        response decode are timed into `parts` ("encrypt", "decrypt"), and
        each response counted by its decode route in `decoded`."""
        from evolu_tpu_torch.api.hooks import create_hooks
        from evolu_tpu_torch.core.packed import PackedReceive
        from evolu_tpu_torch.core.timestamp import millis_to_iso
        from evolu_tpu_torch.runtime import messages as msg
        from evolu_tpu_torch.runtime.client import Evolu
        from evolu_tpu_torch.sync.client import SyncTransport, _http_post
        from evolu_tpu_torch.utils.config import Config

        cfg = Config(backend="auto" if self.on_card else "cpu", sync_scope=scope,
                     **({"sync_url": self.url} if self.url else {}))
        kw = dict(config=cfg, mnemonic=mnemonic, device=self.device, backend=self.backend)
        if hooks:
            made = create_hooks(schema, **kw)
        else:
            made = Evolu(**kw)
            made.update_db_schema(schema)
        evolu = made.evolu if hooks else made
        evolu.worker.now = lambda: self.clock["now"]
        evolu._now_iso = lambda: millis_to_iso(self.clock["now"])
        outputs = self.outputs.setdefault(key, [])
        dispatch, handle = evolu.worker.on_output, evolu.worker.handle

        def on_output(o):
            if isinstance(o, msg.OnQuery):
                outputs.append((o.queries_patches, o.on_complete_ids))
            dispatch(o)

        def timed_handle(command):
            t0 = time.perf_counter()
            try:
                handle(command)
            finally:
                if isinstance(command, (msg.Send, msg.Receive)):
                    self.parts["apply"] += time.perf_counter() - t0

        evolu.worker.on_output, evolu.worker.handle = on_output, timed_handle
        evolu.subscribe_error(self.errors.append)
        transport = (SyncTransport if self.on_card else pure_transport())(
            cfg, on_receive=evolu.receive, sync_lock=evolu.worker.sync_lock,
            on_error=lambda e: evolu._dispatch_output(msg.OnError(e)),
            http_post=self.timed(_http_post, "relay") if self.url else self.post)
        decode = transport._decode_response

        def counted(body, mnemonic):
            messages, tree = decode(body, mnemonic)
            self.decoded["packed" if isinstance(messages, PackedReceive) else "object"] += 1
            return messages, tree

        transport._encode_push = self.timed(transport._encode_push, "encrypt")
        transport._decode_response = self.timed(counted, "decrypt")
        evolu.attach_transport(transport)
        self.clients[key] = evolu
        return made

    def settle(self, evolu):
        """Drive rounds until quiet: worker, transport, worker again, until a
        pass moves no request (a Receive's resend queues one more round).
        Fails at once when a round reported an error."""
        t = evolu._transport
        while True:
            n = t.counts.get("requests", 0)
            evolu.worker.flush()
            t.flush()
            evolu.worker.flush()
            self.check("settle")
            if t.counts.get("requests", 0) == n:
                return

    def pull(self, evolu):
        evolu.sync()
        self.settle(evolu)

    def check(self, step):
        if self.faults:
            raise AssertionError(f"path F {step} ({self.name}): the relay failed") from self.faults[0]
        if self.errors:
            raise AssertionError(f"path F {step} ({self.name}): the error channel got {self.errors!r}") \
                from self.errors[0]

    def close(self):
        for e in self.clients.values():
            e.dispose()
        if self.server is not None:
            self.server.stop()
        if self.engine is not None:
            self.engine.close()  # its pull thread


def f1_todos(fs):
    """F1, BASELINE config 1: the examples/nextjs todo table, 2 replicas,
    ~1k messages. A (through create_hooks, with live QueryViews) makes 10
    batching() groups of creates and updates, B pulls after each; B edits,
    A pulls; then reset_owner and restore_owner on B (on_reload firing
    in-process) and B's re-sync of the whole history. Every batch is under
    `min_device_batch`: the worker plans on the host."""
    from evolu_tpu_torch.api.query import fn

    hooks = fs.client("A", F_TODO, MNEMONIC, hooks=True)
    a = hooks.evolu
    b = fs.client("B", F_TODO, MNEMONIC)
    views = [
        hooks.use_query(lambda t: t("todo").select("id", "title", "isCompleted", "categoryId")
                        .where_is_deleted(False).order_by("id")),
        hooks.use_query(lambda t: t("todo").select(("todo.title", "title"), ("todoCategory.name", "category"))
                        .inner_join("todoCategory", "todoCategory.id", "todo.categoryId").order_by("todo.title")),
        hooks.use_query(lambda t: t("todo").select("categoryId", fn.count("id").as_("n")).group_by("categoryId")
                        .order_by("categoryId")),
    ]
    fired = []
    views[0].subscribe(lambda: fired.append(1))
    for v in views:
        b.subscribe_query(v._query)
    todos, n = [], 0
    for g in range(10):
        fs.clock["now"] += F_ROUND_MS
        with a.batching():
            cats = [a.create("todoCategory", {"name": f"cat{g}-{j}"}) for j in range(2)]
            for i in range(14):
                todos.append(a.create("todo", {"title": f"todo{g}-{i}", "isCompleted": False,
                                                "categoryId": cats[i % 2]}))
            for i in range(8):
                a.update("todo", todos[(g * 11 + i * 5) % len(todos)], {"isCompleted": True})
        n += 2 * 3 + 14 * 5 + 8 * 2
        fs.settle(a)
        fs.pull(b)
    fs.clock["now"] += F_ROUND_MS
    with b.batching():
        for i in range(5):
            b.update("todo", todos[i * 7], {"title": f"edited by B {i}"})
    n += 5 * 2
    fs.settle(b)
    fs.pull(a)
    reloads = []
    b.on_reload(lambda: reloads.append(1))
    b.reset_owner()
    b.worker.flush()
    b.restore_owner(MNEMONIC)
    b.worker.flush()
    if reloads != [1, 1] or not fired:
        raise AssertionError(f"path F F1 ({fs.name}): on_reload fired {reloads}, the view {len(fired)} times")
    b.update_db_schema(F_TODO)
    fs.clock["now"] += F_ROUND_MS
    fs.pull(b)
    fs.pull(a)
    rows = [v.rows for v in views] + [b.get_query_rows(v._query) for v in views]
    return n, rows


def f2_config2(fs, sends=F2_SENDS, after_send=None):
    """F2, BASELINE config 2's todo/todoCategory shape: A makes F2_SENDS
    Sends of 10k (1,600 todo creates, 200 category creates and 700 updates
    a Send, in batching()); B pulls after each. After half of the Sends a
    third device C restores A's mnemonic on an empty database and pulls the
    history in one round, then pulls with B. Every batch is device-planned.
    `sends` cuts the Sends (C restores after half of them); `after_send(s)`
    runs once A's Send s has reached the relay."""
    from evolu_tpu_torch.api.query import fn, table

    a = fs.client("A", F_TODO, MNEMONIC)
    b = fs.client("B", F_TODO, MNEMONIC)
    queries = [table("todo").select("id", "title", "categoryId").order_by("id").limit(50),
               table("todo").select(fn.count("id").as_("n"), fn.max("title").as_("m")),
               table("todoCategory").select("id", "name").where("name", "like", "cat3-%").order_by("id")]
    for e in (a, b):
        for q in queries:
            e.subscribe_query(q)
    todos, n, c, restore_s = [], 0, None, None
    for s in range(sends):
        fs.clock["now"] += F_ROUND_MS
        with a.batching():
            cats = [a.create("todoCategory", {"name": f"cat{s}-{j}"}) for j in range(F2_CATS)]
            for i in range(F2_TODOS):
                todos.append(a.create("todo", {"title": f"todo{s}-{i}", "isCompleted": 0,
                                                "categoryId": cats[i % F2_CATS]}))
            for i in range(F2_UPDATES):
                a.update("todo", todos[(i * 7919 + s) % len(todos)], {"title": f"upd{s}-{i}"})
        n += F2_CATS * 3 + F2_TODOS * 5 + F2_UPDATES * 2
        fs.settle(a)
        if after_send is not None:
            after_send(s)
        fs.pull(b)
        if c is not None:
            fs.pull(c)
        if s == sends // 2 - 1:
            t0 = time.perf_counter()
            c = fs.client("C", F_TODO, F_MNEMONIC2)
            c.restore_owner(MNEMONIC)
            c.worker.flush()
            c.update_db_schema(F_TODO)
            for q in queries:
                c.subscribe_query(q)
            fs.pull(c)
            restore_s = time.perf_counter() - t0
    rows = [e.get_query_rows(q) for e in (a, b, c) for q in queries]
    return n, rows, restore_s


def f3_board(fs):
    """F3, the typed calls on path C2's board schema: A creates 256 rows,
    then 8 batching() groups of 2,048 typed calls over them (increment,
    set_add/set_remove, list_append/list_insert/list_delete, tensor_delta
    and tensor_set on the width-8 sum, mean and max tensors); B pulls
    after each group. The folds run on both the Send and the Receive side."""
    from evolu_tpu_torch.api.query import table

    a = fs.client("A", F_BOARD, MNEMONIC)
    b = fs.client("B", F_BOARD, MNEMONIC)
    q = table("board").select("id", "title", "votes", "tags", "body").order_by("id").limit(64)
    for e in (a, b):
        e.subscribe_query(q)
    fs.clock["now"] += F_ROUND_MS
    with a.batching():
        rows = [a.create("board", {"title": f"card{i}"}) for i in range(F3_ROWS)]
    n = F3_ROWS * 3
    fs.settle(a)
    fs.pull(b)
    for g in range(F3_GROUPS):
        fs.clock["now"] += F_ROUND_MS
        with a.batching():
            for i in range(F3_CALLS):
                # Each kind visits every row once a group.
                row, kind = rows[(i // 8 + g * 13) % F3_ROWS], i % 8
                vec = np.full(8, ((i + g) % 9 - 4) / 4, np.float32)
                vec[i % 8] += 1.0
                if kind == 0:
                    a.increment("board", row, "votes", (i % 11) - 5)
                elif kind == 1:
                    a.set_add("board", row, "tags", f"t{i % 17}")
                elif kind == 2:
                    a.set_remove("board", row, "tags", f"t{(i + 3) % 17}")
                elif kind == 3:
                    a.list_append("board", row, "body", f"g{g}i{i}")
                elif kind == 4:
                    a.list_insert("board", row, "body", f"h{g}i{i}")
                elif kind == 5:
                    elems = a.list_elements("board", row, "body")
                    if elems:
                        a.list_delete("board", row, "body", elems[(i // 8) % len(elems)][0])
                    else:
                        a.list_append("board", row, "body", f"d{g}i{i}")
                elif kind == 6 and (i // 8) % 64 == 5:
                    a.tensor_set("board", row, "w", vec)
                elif kind == 6:
                    a.tensor_delta("board", row, "w", vec)
                elif (i // 8) % 2 == 0:
                    a.tensor_delta("board", row, "avg", vec, count=1 + (i // 8) % 3)
                else:
                    a.tensor_delta("board", row, "peak", vec)
        n += F3_CALLS
        fs.settle(a)
        fs.pull(b)
    tensors = [(r, c, a.tensor_value("board", r, c).tolist(), b.tensor_value("board", r, c).tolist())
               for r in rows[:16] for c in ("w", "avg", "peak")]
    return n, [a.get_query_rows(q), b.get_query_rows(q), tensors]


def f_state(fs):
    """A set's state after a step: each client's tables (digest and rows
    a table), OnQuery patches and tree with its relay's tree for the
    client's owner, and the relay's Merkle trees and stored (timestamp,
    owner) columns (digests) and message count."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.storage.clock import read_clock

    clients = {key: {"tables": {t: (digest(rows), len(rows)) for t, rows in d_dump(e.db).items()},
                     "outputs": fs.outputs[key],
                     "tree": merkle_tree_to_string(read_clock(e.db).merkle_tree),
                     "relay_tree": fs.store.get_merkle_tree_string(e.owner.id)}
               for key, e in fs.clients.items()}
    relay = {what: digest(fs.store.db.exec(sql)) for sql, what in (
        ('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1', "Merkle trees"),
        ('SELECT "userId", "timestamp" FROM "message" ORDER BY 1, 2', "stored (timestamp, owner) columns"))}
    relay["messages"] = fs.store.db.exec('SELECT COUNT(*) FROM "message"')[0][0]
    return {"clients": clients, "relay": relay}


def f_compare(step, got, want):
    """The card set's `f_state` against the oracle set's: every client's
    tables, OnQuery patches and tree, every client's tree equal to its
    relay's, and the relays' trees and stored (timestamp, owner) columns.
    → table sizes."""
    sizes = {}
    for key, g in got["clients"].items():
        w = want["clients"][key]
        for t in sorted(set(g["tables"]) | set(w["tables"])):
            if g["tables"].get(t) != w["tables"].get(t):
                raise AssertionError(f"path F {step}: client {key}'s table {t} differs from the oracle set's")
        sizes[key] = {t: n for t, (_d, n) in w["tables"].items() if not t.startswith("__crdt_schema")}
        if g["outputs"] != w["outputs"]:
            raise AssertionError(f"path F {step}: client {key}'s OnQuery patches differ from the oracle set's")
        for name, state in (("card", g), ("oracle", w)):
            if state["tree"] != state["relay_tree"]:
                raise AssertionError(f"path F {step}: client {key}'s tree differs from its relay's ({name})")
    for what in ("Merkle trees", "stored (timestamp, owner) columns"):
        if got["relay"][what] != want["relay"][what]:
            raise AssertionError(f"path F {step}: the relays' {what} differ")
    sizes["relay_messages"] = want["relay"]["messages"]
    return sizes


F_STEPS = (("f1", lambda fs: f1_todos(fs)), ("f2", lambda fs: f2_config2(fs)), ("f3", lambda fs: f3_board(fs)),
           ("h3", lambda fs: f2_config2(fs, sends=H3_SENDS)))


def f_oracle():
    """Path F's and H3's oracle sets, run in a process of the spawned pool
    while the card runs paths B to E: each step's commands on a fresh
    `FSet("oracle", False)` (H3's on an HTTP relay). → {step: the drive's
    result, wall, parts, decode and apply routes, and `f_state`}."""
    from evolu_tpu_torch.storage import apply as papply

    out = {}
    for step, drive in F_STEPS:
        fs = FSet("oracle", False, http=step == "h3")
        try:
            applied = dict(papply.counts)
            with fs.active():
                t0 = time.perf_counter()
                result = drive(fs)
                wall = time.perf_counter() - t0
            fs.check(step)
            out[step] = {"result": result, "wall": wall, "parts": dict(fs.parts), "decoded": dict(fs.decoded),
                         "applied": {k: papply.counts[k] - applied[k] for k in applied
                                     if papply.counts[k] != applied[k]},
                         "state": f_state(fs)}
        finally:
            fs.close()
    return out


def path_f(torch, kernels, oracle_job, gpu=""):
    """The port's client handle with end-to-end encrypted sync on the card:
    F1 (config 1), F2 (config 2, with a restored third device) and F3 (the
    typed calls), each on a card set, compared after the step with an
    oracle set given the same commands in a process of the pool
    (`oracle_job`, `f_oracle`). The card set's wall is split into encrypt
    (push), the relay's answer, decrypt (pull), the workers' apply of Sends
    and Receives, and the rest. `gpu` (the card's nvidia-smi line) ends
    each printed line. Returns (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.storage import apply as papply

    report = {}
    t0 = time.perf_counter()
    oracle = oracle_job.get()
    print(f"  path F: waited {time.perf_counter() - t0:.1f}s for the oracle sets of the pool", flush=True)
    reset(kernels)
    for step, drive in F_STEPS[:3]:
        gset, o = FSet("card", True), oracle[step]
        before = read(kernels)
        routes = dict(eng.counts)
        try:
            applied = dict(papply.counts)
            with gset.active():
                t0 = time.perf_counter()
                result = drive(gset)
                gset.walls[step] = time.perf_counter() - t0
            gset.applied = {k: papply.counts[k] - applied[k] for k in applied if papply.counts[k] != applied[k]}
            gset.check(step)
            launched = {k: v - before[k] for k, v in read(kernels).items()}
            if result[1] != o["result"][1]:
                raise AssertionError(f"path F {step}: query rows differ from the oracle set's")
            t0 = time.perf_counter()
            sizes = f_compare(step, f_state(gset), o["state"])
            n = result[0]
            plans = sum(sum(v for k, v in getattr(e.worker._planner, "cache").counts.items()
                            if k in ("cached_plans", "stream_plans")) for e in gset.clients.values())
            relay = {k: eng.counts[k] - routes[k] for k in routes}
            parts = {k: round(v, 4) for k, v in gset.parts.items()}
            parts["rest"] = round(gset.walls[step] - sum(gset.parts.values()), 4)
            out = {"messages": n, "wall_s": round(gset.walls[step], 4), "msgs_per_s": round(n / gset.walls[step]),
                   "oracle_wall_s": round(o["wall"], 4), "oracle_msgs_per_s": round(n / o["wall"]),
                   "oracle_in_pool_process": True,
                   "split_s": parts, "crypto_share": round((gset.parts["encrypt"] + gset.parts["decrypt"])
                                                           / gset.walls[step], 4),
                   "oracle_split_s": {k: round(v, 4) for k, v in o["parts"].items()},
                   "launches": launched, "worker_device_plans": plans, "relay_routes": relay,
                   "responses_decoded": gset.decoded, "oracle_responses_decoded": o["decoded"],
                   "apply_routes": gset.applied, "oracle_apply_routes": o["applied"],
                   "transport_counts": {k: dict(e._transport.counts) for k, e in gset.clients.items()},
                   "rows": sizes, "compare_s": round(time.perf_counter() - t0, 3)}
            if step == "f2":
                out["c_restore_and_initial_sync_s"] = round(result[2], 4)
                out["oracle_c_restore_and_initial_sync_s"] = round(o["result"][2], 4)
            report[step] = out
            print(f"  path F {step}: {json.dumps(out)} | {gpu}", flush=True)
            # The relay's device pass launches H and X; the workers' device
            # plans launch L twice, H and X; the typed folds S (tensor sum,
            # mean) and L (tensor max, lists).
            if launched["timestamp_hash"] != launched["seg_xor_scan"] or launched["timestamp_hash"] < plans:
                raise AssertionError(f"path F {step}: H and X launched {launched}, {plans} device plans")
            if step == "f1" and (plans or launched["seg_lex_max_scan"] or launched["seg_sum_scan"]):
                raise AssertionError(f"path F f1: the host route launched {launched} ({plans} device plans)")
            if step != "f1" and (plans == 0 or launched["seg_lex_max_scan"] < 2 * plans):
                raise AssertionError(f"path F {step}: L launched {launched} for {plans} device plans")
            if (step == "f3") != (launched["seg_sum_scan"] > 0):
                raise AssertionError(f"path F {step}: S launched {launched['seg_sum_scan']} times")
            if gset.decoded["object"] or not gset.decoded["packed"] or o["decoded"]["packed"]:
                raise AssertionError(f"path F {step}: responses decoded {gset.decoded} on the card set "
                                     f"(every one through the columnar leg), {o['decoded']} on the oracle set")
        finally:
            gset.close()
    launches = read(kernels)
    print(f"  path F: launches {launches} | {gpu}", flush=True)
    return launches, report, oracle["h3"]


# ---- path G: the packed/native receive and the relay's packed ingest ---------------

def native_paths_in_port_build():
    """Both native libraries' paths, asserted to be the port's own builds
    under evolu_tpu_torch/_build/native/."""
    from evolu_tpu_torch.utils import native_loader

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "evolu_tpu_torch", "_build", "native")
    paths = {so: (native_loader.build_info.get(so) or {}).get("path")
             for so, target in native_loader.TARGETS.items() if target[0] == native_loader.NATIVE_DIR}
    for so, path in paths.items():
        if not path or os.path.commonpath([os.path.abspath(path), root]) != root:
            raise AssertionError(f"path G: {so} is not loaded from the port's build directory: {path}")
    return paths


def pure_decode_slice(body, part, mnemonic):
    """The pure decode of a sync response `body` (the protobuf decode, then
    the OpenPGP loop `decrypt_messages_pure`) for the `part`-th of
    ORACLE_PROCESSES contiguous slices of its messages. → (the response's
    tree, the slice's messages)."""
    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import decrypt_messages_pure

    response = protocol.decode_sync_response(body)
    size = -(-len(response.messages) // ORACLE_PROCESSES)
    return response.merkle_tree, decrypt_messages_pure(response.messages[part * size:(part + 1) * size], mnemonic)


def pure_decrypt(pool, body, mnemonic):
    """The G1 oracle's pure decode of one response, in the processes of
    `pool` (each decodes the protobuf and decrypts its slice), run while the
    card side is timed. → an AsyncResult of the slices' (tree, messages)."""
    return pool.starmap_async(pure_decode_slice, [(body, i, mnemonic) for i in range(ORACLE_PROCESSES)])


def path_g1(torch, kernels, trees, batches, report_d, oracle, pool):
    """G1, a client's packed receive on the card, at path D's config-2 todo
    shape: D1's initial sync (2^19 messages over ~2^17 cells, in 4 chunks
    of 2^17), then D2's first Receive of 100k over the 5k-row population
    (the cached case; D2's other two were cut to make room for path Q).
    Each batch is sealed with the native `encrypt_batch`,
    pushed into a native `RelayStore` (the packed ingest on the card), and
    served back to the client as a sync response by
    `serve_single_request`; these bytes are made before the counts are
    reset. The card side decodes each with `decrypt_response_columns` (one
    C call to a PackedReceive; None fails the run) and hands it to a
    `DbWorker(device=None)` on `CppSqliteDatabase` with the winner cache.
    The oracle decodes the same bytes with the pure loops (in the
    processes of `pool`, while the card side runs), which must give
    exactly the messages and trees
    path D's `backend="cpu"` worker on `PySqliteDatabase` received for D1
    and D2's first batch, with the same clock; that worker's outputs,
    pushes, tables and tree after them (`oracle`, taken in path D) are the
    oracle's. They
    must equal the card side's; every batch must plan and apply packed (no
    bounce); L twice, H and X once a plan, S never. `batches` are path D's
    D1 and D2's first batch as (base, messages) and `trees` the relay's
    trees after each. Returns (launches, report)."""
    from evolu_tpu_torch.core.packed import PackedReceive
    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache
    from evolu_tpu_torch.runtime import worker as worker_mod
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore, serve_single_request
    from evolu_tpu_torch.storage import apply as papply
    from evolu_tpu_torch.storage.clock import read_clock
    from evolu_tpu_torch.storage.native import CppSqliteDatabase
    from evolu_tpu_torch.sync import native_crypto, protocol
    from evolu_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    clock = {"now": D1_BASE}
    gpu = DWorker("g1", Config(backend="auto", winner_cache=True, receive_chunk_size=1 << 17), clock,
                  db=CppSqliteDatabase())
    owner = gpu.worker.owner.id
    node = read_clock(gpu.worker.db).timestamp.node
    store = RelayStore(backend="native")
    relay = BatchReconciler(store)
    bodies, prev = [], "{}"
    for (base, batch), tree in zip(batches, trees):
        sealed = native_crypto.encrypt_batch(batch, MNEMONIC)
        if sealed is None:
            raise AssertionError("path G1: the native encrypt_batch declined a canonical batch")
        pushed = protocol.decode_sync_response(
            relay.run_batch_wire([protocol.SyncRequest(sealed, owner, "f" * 16, tree)])[0])
        if pushed.messages or pushed.merkle_tree != tree:
            raise AssertionError("path G1: the relay's tree after the push differs from the client's")
        bodies.append(("d1" if not bodies else "d2", base, len(batch),
                       serve_single_request(store, protocol.SyncRequest((), owner, node, prev))))
        prev = tree
    relay.close()
    del sealed
    print(f"  path G1: {sum(b[2] for b in bodies)} messages sealed, pushed into a native relay and "
          f"served as {len(bodies)} responses ({sum(len(b[3]) for b in bodies)} bytes) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # The oracle's pure decode of every response starts in the pool now and
    # runs while the card side below is timed (it took 15-17 s after it
    # until path P was added; the protobuf decode ran here, 7 s, until the
    # cut for path Q).
    t1 = time.perf_counter()
    oracle_jobs = [(ph, pure_decrypt(pool, body, MNEMONIC)) for ph, _base, _n, body in bodies]
    oracle_submit_s = time.perf_counter() - t1

    split = Timed(torch, [(PackedReceive, "parse_timestamps", "hlc_fold", False),
                          (worker_mod, "receive_timestamps_batch_packed", "hlc_fold", False),
                          (DeviceWinnerCache, "plan_packed", "plan", False),
                          (CppSqliteDatabase, "apply_planned_cells", "sqlite_apply", False)])
    decrypt_s, routes = {"d1": 0.0, "d2": 0.0}, {"d1": [], "d2": []}
    applied = dict(papply.counts)
    reset(kernels)
    with split.on() as parts:
        for ph, base, n, body in bodies:
            clock["now"] = base
            t1 = time.perf_counter()
            decoded = native_crypto.decrypt_response_columns(body, MNEMONIC)
            decrypt_s[ph] += time.perf_counter() - t1
            if decoded is None or len(decoded[0]) != n:
                raise AssertionError(f"path G1: a response of {n} messages did not decode to columns")
            routes[ph].append(gpu.receive(ph, *decoded))
    launches = read(kernels)
    apply_routes = {k: papply.counts[k] - applied[k] for k in applied}
    parts = {k: round(v, 4) for k, v in parts.items()}
    oracle_wait = {"d1": 0.0, "d2": 0.0}
    for (ph, job), (_b, batch), tree in zip(oracle_jobs, batches, trees):
        t1 = time.perf_counter()
        slices = job.get()
        oracle_wait[ph] += time.perf_counter() - t1
        messages = tuple(itertools.chain.from_iterable(m for _t, m in slices))
        if messages != tuple(batch) or {t for t, _m in slices} != {tree}:
            raise AssertionError("path G1: the pure decode of a response differs from what path D's "
                                 "oracle worker received")
    del messages, oracle_jobs
    plans = sum(sum(r["plans"].values()) for ph in routes for r in routes[ph])
    print(f"  path G1: launches {launches}; device plans {plans}; apply routes {json.dumps(apply_routes)}",
          flush=True)
    if apply_routes["packed"] != plans or apply_routes["packed_bounces"] or apply_routes["object"]:
        raise AssertionError(f"path G1: apply routes {apply_routes} for {plans} device plans: every "
                             f"chunk and batch must plan and apply packed, with no bounce")
    want = {"seg_lex_max_scan": 2 * plans, "timestamp_hash": plans, "seg_xor_scan": plans, "seg_sum_scan": 0}
    if plans == 0 or launches != want:
        raise AssertionError(f"path G1: launches {launches}, expected {want}")
    t1 = time.perf_counter()
    got = d_state(gpu)
    if got["outputs"] != oracle["outputs"] or got["pushes"] != oracle["pushes"]:
        raise AssertionError("path G1: outputs or pushes differ from the pure oracle's")
    if got["tables"] != oracle["tables"]:
        raise AssertionError(f"path G1: tables {sorted(t for t in oracle['tables'] if got['tables'].get(t) != oracle['tables'][t])} "
                             f"differ from the pure oracle's")
    if got["tree"] != trees[-1] or got["tree"] != oracle["tree"]:
        raise AssertionError("path G1: the Merkle tree differs from the relay's or the oracle's")
    rows = {t: n for t, (_d, n) in oracle["tables"].items()}
    del got
    paths = native_paths_in_port_build()
    print(f"  path G1: outputs, pushes, every table ({json.dumps(rows)} rows) and the Merkle tree "
          f"byte-identical to the pure oracle ({time.perf_counter() - t1:.1f}s); native libraries "
          f"{json.dumps(paths)}", flush=True)
    report = {}
    for ph in ("d1", "d2"):
        n = sum(b[2] for b in bodies if b[0] == ph)
        wall = decrypt_s[ph] + gpu.walls[ph]
        report[ph] = {"messages": n, "decrypt_columns_s": round(decrypt_s[ph], 4),
                      "receive_wall_s": round(gpu.walls[ph], 4), "msgs_per_s": round(n / wall),
                      "receive_msgs_per_s": round(n / gpu.walls[ph]),
                      "path_d_object_route_msgs_per_s": report_d[ph]["msgs_per_s"],
                      f"oracle_decrypt_{ORACLE_PROCESSES}_processes_wait_s": round(oracle_wait[ph], 4),
                      "oracle_wall_s_in_path_d": report_d[ph]["oracle_wall_s"],
                      "plans_per_receive": [r["plans"] for r in routes[ph]]}
    total = sum(decrypt_s.values()) + sum(gpu.walls[ph] for ph in ("d1", "d2"))
    split_s = {"decrypt_columns": round(sum(decrypt_s.values()), 4), **parts}
    split_s["rest"] = round(total - sum(split_s.values()), 4)
    import sqlite3

    report.update({"split_s": split_s, "apply_routes": apply_routes, "launches": launches,
                   "oracle_decode_submit_s": round(oracle_submit_s, 4),
                   "cache_counts": dict(gpu.cache.counts), "rows": rows, "native_libraries": paths,
                   "sqlite_versions": {"native": gpu.worker.db.exec("SELECT sqlite_version()")[0][0],
                                       "python": sqlite3.sqlite_version}})
    gpu.stop()
    return launches, report


def shards_hold_the_same_rows(single, sharded):
    """Whether each shard of `sharded` holds exactly the rows of `single`
    (both on the C++ layer) for the owners it places, both tables, compared
    as the packed result bytes the C++ layer returns."""
    owners = [r[0] for r in single.db.exec('SELECT "userId" FROM "merkleTree"')]
    placed = {}
    for o in owners:
        placed.setdefault(sharded.shard_index(o), []).append(o)
    for i, shard in enumerate(sharded.shards):
        mine = tuple(placed.get(i, ()))
        where = f'WHERE "userId" IN ({",".join("?" * len(mine))})' if mine else "WHERE 0"
        for sql in ('SELECT "userId", "timestamp", "content" FROM "message" {} ORDER BY 1, 2',
                    'SELECT "userId", "merkleTree" FROM "merkleTree" {} ORDER BY 1'):
            if shard.db.exec_sql_query_packed_raw(sql.format("")) != \
                    single.db.exec_sql_query_packed_raw(sql.format(where), mine):
                return False
    return True


def path_g2(torch, kernels, keep):
    """G2, the relay's one-shot packed ingest on the card: path E's E1 (1M
    messages over 1k owners) and E2 (re-delivery) requests through
    `BatchReconciler(RelayStore(backend="native")).reconcile_wire` (its
    `_ingest_packed`: one native INSERT OR IGNORE a shard with was-new
    flags, one native parse, one device dispatch; `run_batch_wire` takes
    the streaming ingest there, which path H runs), and E1 also on a
    `ShardedRelayStore(backend="native", shards=4)`. Every response must
    equal path E's (the generic ingest on a Python store, itself equal to
    `serve_single_request`), the sharded store's tables after E1 the
    single store's, and the single store's tables after E2 those of path
    E's store. Stage times (host clock, the device leg synchronized) for
    the single store. H and X launch once a dispatch, L and S never.
    Returns (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayStore, ShardedRelayStore
    from evolu_tpu_torch.storage.native import CppSqliteDatabase

    (e1, e1_out), (e2, e2_out), generic = keep["e1"], keep["e2"], keep["store"]
    native, sharded = RelayStore(backend="native"), ShardedRelayStore(backend="native", shards=4)
    report = {}
    routes0 = dict(eng.counts)
    reset(kernels)

    def step(name, store, requests, want):
        rec = eng.BatchReconciler(store)
        stages = Timed(torch, [(CppSqliteDatabase, "relay_insert_packed", "native_insert", False),
                               (eng, "parse_packed_timestamps", "native_parse", False),
                               (eng, "_pack_rows", "pack", False),
                               (eng, "deltas_from_columns", "device", True),
                               (eng, "apply_prefix_xors", "trees", False),
                               (eng, "merkle_tree_to_string", "trees", False),
                               (rec, "_respond_wire", "respond", False)])
        n = sum(len(r.messages) for r in requests)
        try:
            with stages.on() as s:
                t0 = time.perf_counter()
                got = rec.reconcile_wire(requests)  # the one-shot ingest; path H runs the streaming one
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            rec.close()
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"path G2 {name}: response {bad} differs from path E's generic ingest")
        out = {"requests": len(requests), "messages": n, "wall_s": round(wall, 4), "msgs_per_s": round(n / wall),
               "response_messages": sum(len(protocol_messages(b)) for b in got)}
        if store is native:  # shard threads overlap their stages: timed on the single store only
            out["stages_s"] = {k: round(v, 4) for k, v in s.items()}
            out["stages_s"]["other"] = round(wall - sum(s.values()), 4)
        report[name] = out
        print(f"  path G2 {name}: {json.dumps(out)}", flush=True)

    step("e1", native, e1, e1_out)
    step("e1_sharded_4", sharded, e1, e1_out)
    t0 = time.perf_counter()
    if not shards_hold_the_same_rows(native, sharded):
        raise AssertionError("path G2: the 4-shard store's tables after E1 differ from the single store's")
    del e1, e1_out
    sharded.close()
    step("e2", native, e2, e2_out)
    if e_dump(native) != e_dump(generic):
        raise AssertionError("path G2: the native store's tables after E2 differ from path E's Python store")
    report["compare_s"] = round(time.perf_counter() - t0, 3)
    native.close()
    launches = read(kernels)
    routes = {k: eng.counts[k] - routes0[k] for k in ROUTES}
    report["route_counts"] = routes
    print(f"  path G2: launches {launches}; route counts {json.dumps(routes)}", flush=True)
    if routes != {"delta": 3, "full": 0, "overflow": 0, "host_owners": 0}:
        raise AssertionError(f"path G2: routes {routes}, expected one 16-B dispatch a step")
    want = {"seg_lex_max_scan": 0, "timestamp_hash": 3, "seg_xor_scan": 3, "seg_sum_scan": 0}
    if launches != want:
        raise AssertionError(f"path G2: launches {launches}, expected {want}")
    return launches, report


# ---- path H: the relay as a live server ----------------------------------------------

H_CLIENTS = 32  # H1's client threads, each with a disjoint slice of owners
H_OWNERS = 500  # H1, H2 and K2 drive path E's owners 0-499 (all 1,000 until the cut for path Q)
K1_OWNERS = 128  # path K1 replays these first owners of H1 (256 of its 1,000 bodies)
H2_BATCHES = 4  # H1's owners' E1 requests in batches of 125 owners for the pipeline
H3_SENDS = 5  # F2 cut to 5 Sends of 10k for the HTTP clients
F2_V1_CRYPTO_SHARE = "13.5-15.6%"  # path F's F2 on the v1 wire (PERF.md section 5)


def durations(obj, attr, out):
    """`obj.attr` swapped for a wrapper that appends each call's host-clock
    seconds to `out` (a context manager)."""
    orig = getattr(obj, attr)

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            out.append(time.perf_counter() - t0)
    return patched(obj, attr, run)


def h_stream_split(torch, eng):
    """The streaming engine's stages, host clock, nothing synchronized (the
    pipeline must run as it does): dispatch (`start_batch`), the pull
    thread's wait (`_pull_outputs`), the dispatcher's wait for it and the
    decode (`deltas_finish`), the native insert, the tree folds and the
    respond."""
    from evolu_tpu_torch.storage.native import CppSqliteDatabase

    return Timed(torch, [(eng.BatchReconciler, "start_batch", "dispatch", False),
                         (eng, "_pull_outputs", "pull_thread", False),
                         (eng, "deltas_finish", "pull_wait_and_decode", False),
                         (CppSqliteDatabase, "relay_insert_packed", "insert", False),
                         (eng, "apply_prefix_xors", "trees", False),
                         (eng, "merkle_tree_to_string", "trees", False),
                         (eng.BatchReconciler, "_respond_wire", "respond", False)])


def h_owner(user_id) -> bool:
    """Whether an owner of path E is one of H1's (owners 0 to H_OWNERS - 1)."""
    return user_id < f"owner{H_OWNERS:04d}"


def h_requests(pairs):
    """The (request, wanted response) pairs of path E that belong to H1's owners."""
    return [(r, out) for r, out in pairs if h_owner(r.user_id)]


def h1_bodies():
    """Path E's E1 and E2 requests of H1's owners encoded as sync POST
    bodies, in H1's order; made in a process of the spawned pool while the
    card runs paths B to E (the encoding, 3–5 s, was cut from H1's phase
    when path K was added)."""
    from evolu_tpu_torch.sync import protocol

    _pool, e1, e2, _e3 = e_requests()
    return [protocol.encode_sync_request(r) for r in e1 + e2 if h_owner(r.user_id)]


def path_h1(torch, kernels, keep, tmp, bodies):
    """H1, the live relay at config 3: path E's E1 requests of owners 0-499
    (500,000 messages; all 1k owners until the cut for path Q), then their
    E2 requests, POSTed over HTTP by `sync.client.
    _http_post` from H_CLIENTS threads, each owning a disjoint slice of
    owners and sending each owner's requests in path E's order, to
    `RelayServer(RelayStore(<file>, backend="native"), batching=True)` with
    `device=None`: every batch takes `start_batch`/`finish_batch` on the
    card. Every response equals path E's and the tables path E's store's
    rows of these owners (a batch never holds two requests of one owner).
    `bodies`: the requests encoded (`h1_bodies`). → (launches, report)."""
    import threading

    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import _http_post

    (e1, e1_out), (e2, e2_out) = keep["e1"], keep["e2"]
    jobs = h_requests(zip(e1, e1_out)) + h_requests(zip(e2, e2_out))
    if len(bodies) != len(jobs) or any(protocol.decode_sync_request(bodies[i]) != jobs[i][0]
                                       for i in range(0, len(jobs), 97)):
        raise AssertionError("path H1: the pool's bodies are not path E's requests")
    slot = {}
    for i, (r, _) in enumerate(jobs):
        slot.setdefault(r.user_id, len(slot) % H_CLIENTS)
    lanes = [[] for _ in range(H_CLIENTS)]
    for i, (r, _) in enumerate(jobs):  # E1 before E2 in every lane: path E's order
        lanes[slot[r.user_id]].append(i)
    n = sum(len(r.messages) for r, _ in jobs)

    store = RelayStore(os.path.join(tmp, "h1.db"), backend="native")
    # A listener (peers=[]): after H1 it is path I's anti-entropy donor,
    # kept serving in `keep["h1_server"]`.
    server = keep["h1_server"] = RelayServer(store, batching=True, peers=[]).start()
    got, lat, errors, sizes, decodes = [None] * len(jobs), [0.0] * len(jobs), [], [], []
    routes0 = dict(eng.counts)
    split = h_stream_split(torch, eng)
    reset(kernels)

    def lane(ix):
        try:
            for i in ix:
                t1 = time.perf_counter()
                got[i] = _http_post(server.url, bodies[i])
                lat[i] = time.perf_counter() - t1
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    orig_run = eng.BatchReconciler.run_batch_wire

    def sized(self, requests):
        sizes.append(len(requests))
        return orig_run(self, requests)

    with patched(eng.BatchReconciler, "run_batch_wire", sized), split.on() as stages, \
            durations(protocol, "decode_sync_request", decodes):
        threads = [threading.Thread(target=lane, args=(ix,)) for ix in lanes]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t1
    counts = dict(server.scheduler.counts)
    launches = read(kernels)
    if errors:
        raise AssertionError("path H1: a client's POST failed") from errors[0]
    for i, (r, want) in enumerate(jobs):
        if got[i] != want:
            raise AssertionError(f"path H1: the response to {r.user_id} differs from path E's")
    t1 = time.perf_counter()
    mine, theirs = e_dump(server.store), keep["h_dump"]
    if mine[0] != theirs[0] or mine[1] != theirs[1]:
        raise AssertionError("path H1: the message or merkleTree table differs from path E's store")
    del mine
    # Path K's K2 holds its responses to these; K1 sends the first
    # K1_OWNERS owners' bodies (in H1's lanes) to a write-behind relay.
    keep["h1_wants"] = [want for _, want in jobs]
    k1_owners = set(list(slot)[:K1_OWNERS])
    k1_ix = [i for i, (r, _) in enumerate(jobs) if r.user_id in k1_owners]
    renum = {i: j for j, i in enumerate(k1_ix)}
    keep["k1_replay"] = ([bodies[i] for i in k1_ix], [jobs[i][1] for i in k1_ix],
                         [[renum[i] for i in lane if i in renum] for lane in lanes],
                         sum(len(jobs[i][0].messages) for i in k1_ix), k1_owners,
                         [(jobs[i][0].user_id, [m.timestamp for m in jobs[i][0].messages]) for i in k1_ix])
    routes = {k: eng.counts[k] - routes0[k] for k in routes0}
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {"requests": len(jobs), "messages": n, "client_threads": H_CLIENTS,
           "wall_s": round(wall, 4), "msgs_per_s": round(n / wall), "requests_per_s": round(len(jobs) / wall, 1),
           "latency_ms_p50": round(lat_ms[len(lat_ms) // 2], 3),
           "latency_ms_p99": round(lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))], 3),
           "engine_passes": len(sizes), "pass_requests_mean": round(statistics.mean(sizes), 2),
           "pass_requests_max": max(sizes), "scheduler_counts": counts, "route_counts": routes,
           # The dispatcher's stages by its own wall clock, GIL waits
           # included; the handler threads' decode summed over the threads.
           "stream_split_s": {k: round(v, 4) for k, v in stages.items()},
           "handler_decode_s_summed": round(sum(decodes), 4), "compare_s": round(time.perf_counter() - t1, 3)}
    print(f"  path H1: {json.dumps(out)}", flush=True)
    if counts["poisoned_batches"] or counts["singles"] or counts["batches"] != len(sizes) \
            or counts["coalesced"] != len(jobs):
        raise AssertionError(f"path H1: scheduler counts {counts} for {len(sizes)} engine passes")
    expect = {"seg_lex_max_scan": 0, "seg_sum_scan": 0,
              "timestamp_hash": len(sizes) + routes["overflow"], "seg_xor_scan": len(sizes) + routes["overflow"]}
    if launches != expect:
        raise AssertionError(f"path H1: launches {launches}, expected {expect}")
    return launches, out


def path_h2(torch, kernels, keep):
    """H2, the pipeline alone: H1's owners' E1 requests split into H2_BATCHES
    batches of 125 owners, then their E2 requests as one batch, through
    `reconcile_stream` on a fresh
    native store and through `run_batch_wire` one batch at a time on
    another. The encoded responses equal path E's on both, and both
    stores' tables path E's store's rows of these owners. Per batch: the
    dispatch, the pull
    thread's wait, the dispatcher's wait for the pull and decode, and the
    host leg (`finish_batch`). → (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync import protocol

    e1_jobs, e2_jobs = h_requests(zip(*keep["e1"])), h_requests(zip(*keep["e2"]))
    e1, e2 = [r for r, _ in e1_jobs], [r for r, _ in e2_jobs]
    per = len(e1) // H2_BATCHES
    batches = [e1[i * per:(i + 1) * per] for i in range(H2_BATCHES - 1)] + [e1[(H2_BATCHES - 1) * per:], e2]
    want = [out for _, out in e1_jobs + e2_jobs]
    n = sum(len(r.messages) for b in batches for r in b)
    report, stores = {}, {}
    routes0 = dict(eng.counts)
    reset(kernels)
    for mode in ("reconcile_stream", "run_batch_wire"):
        store = stores[mode] = RelayStore(backend="native")
        rec = eng.BatchReconciler(store)
        times = {"dispatch": [], "pull_thread": [], "pull_wait_and_decode": [], "host_leg": []}
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(durations(rec, "start_batch", times["dispatch"]))
                stack.enter_context(durations(eng, "_pull_outputs", times["pull_thread"]))
                stack.enter_context(durations(eng, "deltas_finish", times["pull_wait_and_decode"]))
                stack.enter_context(durations(rec, "finish_batch", times["host_leg"]))
                t0 = time.perf_counter()
                if mode == "reconcile_stream":
                    got = [protocol.encode_sync_response(r) for out in rec.reconcile_stream(batches) for r in out]
                else:
                    got = [b for batch in batches for b in rec.run_batch_wire(batch)]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            rec.close()
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"path H2 {mode}: response {bad} differs from path E's")
        report[mode] = {"batches": len(batches), "messages": n, "wall_s": round(wall, 4),
                        "msgs_per_s": round(n / wall),
                        "per_batch_ms": {k: [round(x * 1e3, 2) for x in v] for k, v in times.items()}}
        print(f"  path H2 {mode}: {json.dumps(report[mode])}", flush=True)
    t0 = time.perf_counter()
    a, b = stores.values()
    for sql in ('SELECT "userId", "timestamp", "content" FROM "message" ORDER BY 1, 2',
                'SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1'):
        if a.db.exec_sql_query_packed_raw(sql) != b.db.exec_sql_query_packed_raw(sql):
            raise AssertionError("path H2: the pipelined and the one-batch-at-a-time stores' tables differ")
    if e_dump(a) != keep["h_dump"]:
        raise AssertionError("path H2: the stores' tables differ from path E's store")
    report["compare_s"] = round(time.perf_counter() - t0, 3)
    for st in stores.values():
        st.close()
    launches = read(kernels)
    report["route_counts"] = {k: eng.counts[k] - routes0[k] for k in routes0}
    expect = 2 * len(batches) + report["route_counts"]["overflow"]
    if launches != {"seg_lex_max_scan": 0, "timestamp_hash": expect, "seg_xor_scan": expect, "seg_sum_scan": 0}:
        raise AssertionError(f"path H2: launches {launches}, expected H and X {expect} times each")
    return launches, report


def path_h3(torch, kernels, oracle, gpu=""):
    """H3, clients over HTTP with the v2 wire: path F's F2 handles, cut to
    H3_SENDS Sends of 10k with B pulling after each (C restores after half
    of them). The card set's `Evolu(device=None)` clients on the native
    crypto leg POST through the real `_http_post` to a card
    `RelayServer(batching=True)`; the oracle set's (path F's, run by
    `f_oracle` in a process of the pool: `oracle`) to a port
    `RelayServer(batching=False)` on a Python store with `device="cpu"`.
    Round 1 stores only OpenPGP records; after the echo
    `negotiated_capabilities[url]` holds `aead-batch-v1` and every later
    Send stores v2 records (magic 45 32 01). Tables, query rows, trees and
    the stored (timestamp, owner) columns equal the oracle set's. →
    (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.sync import aead, protocol

    per_send = F2_CATS * 3 + F2_TODOS * 5 + F2_UPDATES * 2
    gset, mix = FSet("card", True, http=True), []
    reset(kernels)
    routes = dict(eng.counts)

    def stored_mix(s):
        rows = gset.store.db.exec('SELECT "content" FROM "message"')
        v2 = sum(aead.is_v2_record(bytes(c)) for (c,) in rows)
        mix.append({"send": s, "v1": len(rows) - v2, "v2": v2,
                    "negotiated": sorted(gset.clients["A"]._transport.negotiated_capabilities.get(gset.url, ()))})

    try:
        with gset.active():
            t0 = time.perf_counter()
            result = f2_config2(gset, sends=H3_SENDS, after_send=stored_mix)
            gset.walls["h3"] = time.perf_counter() - t0
        gset.check("h3")
        launches = read(kernels)
        if result[1] != oracle["result"][1]:
            raise AssertionError("path H3: query rows differ from the oracle set's")
        t0 = time.perf_counter()
        sizes = f_compare("h3", f_state(gset), oracle["state"])
        counts = dict(gset.server.scheduler.counts)
    finally:
        gset.close()
    if mix[0]["v2"] or mix[0]["v1"] != per_send:
        raise AssertionError(f"path H3: round 1 stored {mix[0]}, expected {per_send} OpenPGP records only")
    if protocol.CAP_AEAD_BATCH not in mix[0]["negotiated"]:
        raise AssertionError(f"path H3: A's transport negotiated {mix[0]['negotiated']} after round 1")
    if mix[-1]["v1"] != per_send or mix[-1]["v2"] != (H3_SENDS - 1) * per_send:
        raise AssertionError(f"path H3: the relay holds {mix[-1]}, expected every Send after the echo as v2")
    n = result[0]
    plans = sum(sum(v for k, v in e.worker._planner.cache.counts.items() if k in ("cached_plans", "stream_plans"))
                for e in gset.clients.values())
    wall = gset.walls["h3"]
    parts = {k: round(v, 4) for k, v in gset.parts.items()}
    parts["rest"] = round(wall - sum(gset.parts.values()), 4)
    out = {"messages": n, "wall_s": round(wall, 4), "msgs_per_s": round(n / wall),
           "oracle_wall_s": round(oracle["wall"], 4), "oracle_msgs_per_s": round(n / oracle["wall"]),
           "oracle_in_pool_process": True,
           "split_s": parts, "crypto_share": round((gset.parts["encrypt"] + gset.parts["decrypt"]) / wall, 4),
           "f2_v1_crypto_share": F2_V1_CRYPTO_SHARE, "stored_after_send": mix,
           "scheduler_counts": counts, "relay_routes": {k: eng.counts[k] - routes[k] for k in routes},
           "worker_device_plans": plans, "responses_decoded": gset.decoded,
           "transport_counts": {k: dict(e._transport.counts) for k, e in gset.clients.items()},
           "rows": sizes, "compare_s": round(time.perf_counter() - t0, 3)}
    print(f"  path H3: {json.dumps(out)} | {gpu}", flush=True)
    if counts["poisoned_batches"] or counts["singles"]:
        raise AssertionError(f"path H3: scheduler counts {counts}")
    dispatches = sum(out["relay_routes"][k] for k in ("delta", "full", "overflow"))
    if launches["timestamp_hash"] != launches["seg_xor_scan"] or launches["seg_sum_scan"] \
            or launches["timestamp_hash"] < plans + dispatches or launches["seg_lex_max_scan"] < 2 * plans \
            or plans == 0 or dispatches == 0:
        raise AssertionError(f"path H3: launches {launches} for {plans} device plans, "
                             f"{dispatches} relay dispatches")
    if gset.decoded["object"] or not gset.decoded["packed"]:
        raise AssertionError(f"path H3: the card set decoded {gset.decoded}")
    return launches, out


def path_h(torch, kernels, keep, tmp, h3_oracle, bodies, gpu=""):
    """Path H: H1, H2 and H3, each with its own launch counts (summed as
    path H). Closes path E's store at the end; H1's relay stays up in
    `keep["h1_server"]` beside path E's store dump, for path I. →
    (launches, report)."""
    report, per = {}, {}
    # Path E's store rows of H1's owners, which H1, H2, I1 and K2 hold.
    keep["h_dump"] = tuple([row for row in rows if h_owner(row[0])] for rows in keep["store_dump"])
    try:
        per["h1"], report["h1"] = path_h1(torch, kernels, keep, tmp, bodies)
        per["h2"], report["h2"] = path_h2(torch, kernels, keep)
        keep.pop("store").close()
        # Path K's K2 runs H2's batches again.
        keep["k_requests"] = tuple([r for r in keep.pop(e)[0] if h_owner(r.user_id)] for e in ("e1", "e2"))
        per["h3"], report["h3"] = path_h3(torch, kernels, h3_oracle, gpu)
    finally:
        if "store" in keep:
            keep["store"].close()
    report["launches"] = per
    launches = {k: sum(p[k] for p in per.values()) for k in per["h1"]}
    return launches, report


# ---- path I: the relay tier's replication half on the card --------------------------

# I2's donor: each owner's first 64 messages of E1, 64,000 rows (cut from 1.1M, then from 128 an owner
# to make room for path Q).
I2_PER_OWNER = 64
I2_TAIL = 10_000  # I2's handoff: new messages POSTed to the donor after the capture
I2_TAIL_OWNERS = 500  # the owners the tail goes to (all 1,000 until path O3 was added)
I3_RELAYS, I3_R = 3, 2  # benchmarks/fleet_scaling.py:332-339: 3 relays, replication factor 2,
I3_THREADS, I3_BATCH, I3_ZIPF = 8, 64, 1.1  # 8 client threads, batches of 64, Zipf 1.1 over owners
# I3's depth, cut from 128,000 and 12,800 when runs of the script passed 650 s with path K's crash episodes;
# its ingest cut again to 16,000 and 6,400 to make room for path O, and to 8,000 and 3,200 for path Q.
I3_MESSAGES = 8_000  # at config 3's 1,000 owners
I3_JOIN_MESSAGES = 3_200  # the writer's during the join (first half of the owner ids)
I3_JOIN_DEBOUNCE_S = 2.0  # the joiner's gossip debounce: its snapshot sweep, not a ranged pull, moves owners
I_WAIT_S = 300.0


def wait_until(pred, what, deadline_s=I_WAIT_S):
    """Poll `pred` (no fixed sleep) until it holds; fail after `deadline_s`."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"path I: timed out after {deadline_s:.0f} s waiting for {what}")


# The engine's route counts: its `counts` also holds the write-behind ones.
ROUTES = ("delta", "full", "overflow", "host_owners")


def engine_passes(before):
    """Engine passes (reruns included) since the route counts `before`:
    each launches H and X once."""
    from evolu_tpu_torch.server import engine as eng

    return sum(eng.counts[k] - before[k] for k in ("delta", "full", "overflow"))


def check_i(step, launches, passes, relays):
    """H and X launched once a pass, L and S never; no scheduler singles,
    poisoned batches or rejects, no failed gossip round, no failed
    rebalance on any relay of the step."""
    expect = {"seg_lex_max_scan": 0, "seg_xor_scan": passes, "timestamp_hash": passes, "seg_sum_scan": 0}
    if launches != expect or not passes:
        raise AssertionError(f"path I {step}: launches {launches}, expected {expect}")
    for r in relays:
        c = r.scheduler.counts
        if c["poisoned_batches"] or c["singles"] or c["rejected"]:
            raise AssertionError(f"path I {step}: scheduler counts {c} at {r.url}")
        errors = {u: pc["rounds_error"] for u, pc in (r.replication.peer_counts if r.replication else {}).items()
                  if pc["rounds_error"]}
        if errors or (r.fleet is not None and r.fleet.counts["rebalance_failures"]):
            raise AssertionError(f"path I {step}: failed rounds {errors} or rebalances at {r.url}")


def post_all(url_of, bodies, threads=8):
    """POST every body (`url_of(i)` names its relay) from `threads` threads
    with `sync.client._http_post`; any failure fails the step."""
    import threading

    from evolu_tpu_torch.sync.client import _http_post

    errors, it, lock = [], iter(range(len(bodies))), threading.Lock()

    def lane():
        try:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                _http_post(url_of(i), bodies[i])
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    ts = [threading.Thread(target=lane) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise AssertionError("path I: a POST failed") from errors[0]


def path_i1(torch, kernels, keep, tmp):
    """I1, anti-entropy at full state: a fresh card relay B
    (`RelayServer(RelayStore(<file>, backend="native"), batching=True,
    peers=[A])`, bootstrap off, the default pull caps) converges on its own
    gossip loop to path H1's relay A, 550,522 rows over 500 owners; every
    pulled message goes through B's scheduler into engine passes on the
    card. B's Merkle trees equal A's (path E's store's, H1's owners) and so do its rows an
    owner (the full-table compare was cut when path M was added); every
    row was pulled, each exactly once apart from the counted re-pulls, and
    the pulls counted exactly. → (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore

    donor = keep["h1_server"]
    want = keep["h_dump"]
    donor_trees = dict(want[1])
    keys, sizes = [], []
    store = RelayStore(os.path.join(tmp, "i1.db"), backend="native")
    routes0 = dict(eng.counts)
    orig_run = eng.BatchReconciler.run_batch_wire

    def sized(self, requests):
        sizes.append(len(requests))
        return orig_run(self, requests)

    reset(kernels)
    with patched(eng.BatchReconciler, "run_batch_wire", sized):
        b = RelayServer(store, batching=True, peers=[donor.url], replication_interval_s=3600)
        ingest = b.replication._ingest  # records every pulled (owner, timestamp)

        def recorded(requests):
            keys.extend((r.user_id, m.timestamp) for r in requests for m in r.messages)
            return ingest(requests)

        b.replication._ingest = recorded
        t0 = time.perf_counter()
        try:
            b.start()
            wait_until(lambda: dict(store.owner_trees()) == donor_trees, "B's trees to equal A's")
            wall = time.perf_counter() - t0
            b.replication.stop()  # the loop's last (hinted, empty) round ends
            launches = read(kernels)
            passes = engine_passes(routes0)
            check_i("I1", launches, passes, [b])
            peer = dict(b.replication.peer_counts[donor.url])
            counts = dict(b.scheduler.counts)
            trips = dict(b.replication.round_trips)
            t1 = time.perf_counter()
            mine = dict(store.db.exec('SELECT "userId", COUNT(*) FROM "message" GROUP BY 1'))
            want_counts = collections.Counter(owner for owner, _, _ in want[0])
        finally:
            stop_relay(b)
    if mine != want_counts:
        raise AssertionError(f"path I1: B's rows an owner differ from A's: {len(mine)} owners against "
                             f"{len(want_counts)}")
    pulled = set(keys)
    rows, distinct = len(want[0]), len(pulled)
    if pulled != {(owner, ts) for owner, ts, _ in want[0]}:
        raise AssertionError("path I1: the pulled (owner, timestamp) keys differ from A's rows")
    if distinct != rows or len(keys) != peer["messages_pulled"]:
        raise AssertionError(f"path I1: pulled {len(keys)} messages ({distinct} distinct) counted as "
                             f"{peer['messages_pulled']}, for {rows} rows")
    out = {"rows": rows, "owners": len(donor_trees), "wall_s": round(wall, 4),
           "rows_per_s": round(rows / wall), "rounds_ok": peer["rounds_ok"], "rounds_error": peer["rounds_error"],
           "pull_round_trips": trips["pull"], "summary_round_trips": trips["summary"],
           "messages_pulled": peer["messages_pulled"], "messages_pulled_per_s": round(peer["messages_pulled"] / wall),
           "re_pulled": len(keys) - distinct, "owners_diffed": peer["owners_diffed"],
           "engine_passes": passes, "pass_requests_max": max(sizes),
           "pass_requests_mean": round(statistics.mean(sizes), 2), "scheduler_counts": counts,
           "route_counts": {k: eng.counts[k] - routes0[k] for k in routes0},
           "compare_s": round(time.perf_counter() - t1, 3)}
    print(f"  path I1: {json.dumps(out)}", flush=True)
    if counts["batches"] != len(sizes) or counts["coalesced"] != sum(sizes):
        raise AssertionError(f"path I1: scheduler counts {counts} for {len(sizes)} engine passes")
    return launches, out


def i_requests(rows, node="f" * 16):
    """One SyncRequest an owner from (userId, timestamp, content) rows,
    with the empty client tree."""
    from evolu_tpu_torch.sync import protocol

    per = {}
    for uid, ts, content in rows:
        per.setdefault(uid, []).append(protocol.EncryptedCrdtMessage(ts, bytes(content)))
    return [protocol.SyncRequest(tuple(m), uid, node, "{}") for uid, m in per.items()]


def path_i2(torch, kernels, keep, tmp):
    """I2, snapshot bootstrap and checkpoint: a card donor D holds each
    owner's first I2_PER_OWNER messages of E1 (loaded by `run_batch_wire`);
    a fresh card relay C (`peers=[D]`, `bootstrap_lag_owners=1`) installs
    D's snapshot in 4 MiB chunks in one round (verify on the host), then
    I2_TAIL new messages POSTed to D reach C by gossip through C's
    scheduler; `write_checkpoint(D)` restores into a 4-shard native store
    with every tree string byte-identical. → (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server import snapshot as snap
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore, ShardedRelayStore
    from evolu_tpu_torch.server.replicate import ReplicationManager
    from evolu_tpu_torch.sync import protocol

    taken, rows = {}, []
    for row in keep["store_dump"][0]:
        if taken.get(row[0], 0) < I2_PER_OWNER:
            taken[row[0]] = taken.get(row[0], 0) + 1
            rows.append(row)
    load = i_requests(rows)
    rng = np.random.default_rng(29)
    contents = [bytes(b) for b in rng.integers(0, 256, (256, E_CONTENT_BYTES), dtype=np.uint8)]
    # E2's shape, a minute past every stamp of paths E and H: C pulls the tail alone.
    owner, _m, _c, _n, stamps = e_stamps(E_MESSAGES + E_MESSAGES // 10 + 16 * 60_000, I2_TAIL, I2_TAIL_OWNERS, rng)
    tail = i_requests([(f"owner{o:04d}", s, contents[i % 256]) for i, (o, s) in enumerate(zip(owner.tolist(), stamps))])
    walls = {"bootstrap": [], "install_chunk": [], "verify": [], "swap": []}
    report, relays = {}, []
    routes0 = dict(eng.counts)
    reset(kernels)
    d = RelayServer(RelayStore(os.path.join(tmp, "i2_d.db"), backend="native"), batching=True, peers=[]).start()
    relays.append(d)
    try:
        t0 = time.perf_counter()
        rec = eng.BatchReconciler(d.store)
        try:
            rec.run_batch_wire(load)
        finally:
            rec.close()
        report["load"] = {"rows": len(rows), "owners": len(load), "wall_s": round(time.perf_counter() - t0, 4),
                          "engine_passes": engine_passes(routes0)}
        with contextlib.ExitStack() as stack:
            stack.enter_context(durations(ReplicationManager, "_bootstrap", walls["bootstrap"]))
            for name in ("install_chunk", "verify", "swap"):
                stack.enter_context(durations(snap.SnapshotInstaller, name, walls[name]))
            t0 = time.perf_counter()
            c = RelayServer(RelayStore(os.path.join(tmp, "i2_c.db"), backend="native"), batching=True,
                            peers=[d.url], bootstrap_lag_owners=1, replication_interval_s=3600).start()
            relays.append(c)
            peer = lambda: c.replication.peer_counts.get(d.url, {})  # noqa: E731
            # The bootstrap round, then the round its hint arms (nothing to pull).
            wait_until(lambda: peer().get("rounds_ok", 0) >= 2, "C's bootstrap and its follow-up round")
            boot_wall = time.perf_counter() - t0
        if peer()["snapshot_bootstraps"] != 1 or peer()["messages_pulled"]:
            raise AssertionError(f"path I2: C's counts {peer()} after the bootstrap")
        if e_dump(c.store) != e_dump(d.store):
            raise AssertionError("path I2: C's tables differ from D's after the bootstrap")
        stats = c.replication.stats_payload()["peers"][0]
        report["bootstrap"] = {
            "wall_s": round(boot_wall, 4), "bootstrap_s": round(sum(walls["bootstrap"]), 4),
            "install_chunks_s": round(sum(walls["install_chunk"]), 4), "verify_s": round(sum(walls["verify"]), 4),
            "swap_s": round(sum(walls["swap"]), 4), "verify_us_per_row": round(sum(walls["verify"]) / len(rows) * 1e6, 2),
            "chunks": stats["snapshot_chunks_fetched"], "bytes": stats["snapshot_bytes_fetched"],
            "snapshot_bootstraps": stats["snapshot_bootstraps"], "round_trips": dict(c.replication.round_trips),
            "engine_passes_so_far": engine_passes(routes0)}
        if report["bootstrap"]["engine_passes_so_far"] != report["load"]["engine_passes"]:
            raise AssertionError("path I2: the bootstrap ran an engine pass")
        d_batches, c_batches = d.scheduler.counts["batches"], c.scheduler.counts["batches"]
        t0 = time.perf_counter()
        post_all(lambda i: d.url, [protocol.encode_sync_request(r) for r in tail])
        post_s = time.perf_counter() - t0
        c.replication.run_once()
        handoff = time.perf_counter() - t0
        if peer()["messages_pulled"] != I2_TAIL:
            raise AssertionError(f"path I2: C pulled {peer()['messages_pulled']} messages of the "
                                 f"{I2_TAIL}-message tail")
        if e_dump(c.store) != e_dump(d.store):
            raise AssertionError("path I2: C's tables differ from D's after the handoff")
        report["handoff"] = {"messages": I2_TAIL, "requests": len(tail), "post_s": round(post_s, 4),
                             "wall_s": round(handoff, 4), "messages_pulled": peer()["messages_pulled"],
                             "d_passes": d.scheduler.counts["batches"] - d_batches,
                             "c_passes": c.scheduler.counts["batches"] - c_batches}
        c.replication.stop()  # its loop's hinted round ends before the counts are read
        launches = read(kernels)
        passes = engine_passes(routes0)
        check_i("I2", launches, passes, relays)
        path = os.path.join(tmp, "i2.checkpoint")
        t0 = time.perf_counter()
        manifest = snap.write_checkpoint(d.store, path)
        write_s = time.perf_counter() - t0
        restored = ShardedRelayStore(os.path.join(tmp, "i2_ck"), backend="native", shards=4)
        try:
            t0 = time.perf_counter()
            snap.restore_checkpoint(restored, path)
            restore_s = time.perf_counter() - t0
            if sorted(restored.owner_trees()) != sorted(d.store.owner_trees()):
                raise AssertionError("path I2: a restored tree string differs from D's")
            n = sum(s["messages"] for s in restored.stats())
        finally:
            restored.close()
        if n != len(rows) + I2_TAIL or manifest.message_count != n:
            raise AssertionError(f"path I2: the checkpoint holds {manifest.message_count} rows, restored {n}")
        report["checkpoint"] = {"rows": n, "bytes": manifest.total_bytes, "chunks": len(manifest.chunk_sizes),
                                "write_s": round(write_s, 4), "restore_s": round(restore_s, 4), "shards": 4}
    finally:
        for r in relays:
            r.stop()
    report["engine_passes"] = passes
    print(f"  path I2: {json.dumps(report)}", flush=True)
    return launches, report


def zipf_counts(owners, total, s, rng):
    """benchmarks/fleet_scaling.py's owner sizes: Zipf(s) weights, at least
    one message an owner, summing to `total`, shuffled."""
    w = [1.0 / (i + 1) ** s for i in range(owners)]
    z = sum(w)
    counts = [max(1, int(total * wi / z)) for wi in w]
    while sum(counts) > total:
        counts[counts.index(max(counts))] -= 1
    i = 0
    while sum(counts) < total:
        counts[i % owners] += 1
        i += 1
    rng.shuffle(counts)
    return counts


def i3_workload(owners, total, seed, t0=0, trees=None):
    """fleet_scaling.py's workload at path E's message shape: owner k's
    messages 500 ms apart from `t0`, node k+1, 116-byte contents, in
    requests of I3_BATCH messages. Each owner's requests keep their HLC
    order and carry the tree of every message of the owner's device (a
    device pushing its offline backlog), so an answer carries only what
    the relay holds past the request; the owners' requests interleave at
    random. `trees` (the owners' device trees so far, by owner index) is
    updated. → [(owner, SyncRequest)]."""
    import random

    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.sync import protocol

    rng = random.Random(seed)
    pool = [bytes(b) for b in np.random.default_rng(seed).integers(0, 256, (4096, E_CONTENT_BYTES), dtype=np.uint8)]
    counts = zipf_counts(owners, total, I3_ZIPF, rng)
    owner = np.repeat(np.arange(owners), counts)
    j = np.concatenate([np.arange(n) for n in counts])
    millis = BASE_MILLIS + 10**10 + (t0 + j) * 500
    trees = e_trees(trees if trees is not None else {}, owner, millis, np.zeros(len(j), np.int32),
                    (owner + 1).astype(np.uint64))
    per_owner, at = [], 0
    for k, n in enumerate(counts):
        uid, tree = f"owner{k:04d}", merkle_tree_to_string(trees[k])
        stamps = [ts_one(int(m), 0, f"{k + 1:016x}") for m in millis[at:at + n].tolist()]
        per_owner.append([(uid, protocol.SyncRequest(
            tuple(protocol.EncryptedCrdtMessage(t, pool[(k * 7 + i + x) % 4096])
                  for x, t in enumerate(stamps[i:i + I3_BATCH])), uid, "00000000000000bb", tree))
            for i in range(0, n, I3_BATCH)])
        at += n
    order = [k for k, reqs in enumerate(per_owner) for _ in reqs]
    rng.shuffle(order)
    nxt = [0] * owners
    out = []
    for k in order:
        out.append(per_owner[k][nxt[k]])
        nxt[k] += 1
    return out


def i3_ingest(requests, urls, threads):
    """fleet_scaling.py's client: each thread POSTs a request to a random
    member (or its learned route), follows at most one 307 and caches it,
    and retries the request until it is ACKed (`_http_post` backs off on
    503). → (wall_s, 307s followed)."""
    import random
    import threading

    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import _http_post

    routes, lock, errors, followed = {}, threading.Lock(), [], [0]
    it = iter(range(len(requests)))
    bodies = [protocol.encode_sync_request(r) for _u, r in requests]

    def lane(tid):
        rng = random.Random(1000 + tid)
        try:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                uid = requests[i][0]
                for _attempt in range(20):
                    url = routes.get(uid) or rng.choice(urls) + "/"
                    try:
                        try:
                            _http_post(url, bodies[i])
                            break
                        except urllib.error.HTTPError as e:
                            loc = e.headers.get("Location") if e.headers else None
                            if e.code != 307 or not loc:
                                raise
                            with lock:
                                followed[0] += 1
                            _http_post(loc, bodies[i])  # at most one 307 an attempt
                            routes[uid] = loc
                            break
                    except urllib.error.HTTPError as e:
                        # A second 307 (the ring moved under the request) or
                        # 503s past _http_post's backoff (an owner mid-install):
                        # retry from a random member.
                        routes.pop(uid, None)
                        if e.code not in (307, 503):
                            raise
                else:
                    raise AssertionError(f"path I3: the request for {uid} was never ACKed")
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=lane, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise AssertionError("path I3: a client request failed") from errors[0]
    return time.perf_counter() - t0, followed[0]


def owner_rows(store):
    """{owner: (tree text, rows)} of a relay store, rows (timestamp,
    content) in order."""
    msgs, trees = e_dump(store)
    out = {uid: [tree, []] for uid, tree in trees}
    for uid, ts, content in msgs:
        out.setdefault(uid, ["{}", []])[1].append((ts, bytes(content)))
    return out


def i3_fixpoint(ring, members, oracle, step, stop=False):
    """Wait for the scoped-gossip fixpoint under `ring`: every owner's tree
    on each of its placed members equal to the oracle's; with `stop`, stop
    the members' gossip loops there (rounds in flight end; the counts are
    final); then hold the rows too. → ({url: owner_rows}, wait s, compare
    s)."""
    want_trees = dict(oracle.owner_trees())
    by_url = {m.url: m for m in members}

    def reached():
        trees = {u: m.call("trees") for u, m in by_url.items()}
        return all(trees[u].get(uid) == t for uid, t in want_trees.items() for u in ring.placement(uid))

    t0 = time.perf_counter()
    wait_until(reached, f"the scoped-gossip fixpoint {step}")
    wait_s = time.perf_counter() - t0
    if stop:
        for m in members:
            m.call("stop_gossip")
    t0 = time.perf_counter()
    want = owner_rows(oracle)
    held = {u: m.call("rows") for u, m in by_url.items()}
    for uid, state in want.items():
        for u in ring.placement(uid):
            if held[u].get(uid) != state:
                raise AssertionError(f"path I3 {step}: {uid} at {u} differs from the oracle")
    return held, round(wait_s, 4), round(time.perf_counter() - t0, 3)


I3_MEMBER_DEVICE = None  # the members' engine device (None = the card)


def i3_member(conn, path, debounce_s, device):
    """One I3 fleet member in a process of its own: a batching
    `RelayServer` on a native file store (gossip every 1.0 s), driven over
    `conn`. It answers its URL, then joins the fleet config it is sent and
    starts; then it answers "trees", "rows", "rebalance" (the sweep a
    reload started), "stop_gossip", "counts" (its kernel launches, counted
    from 0 in this process, its engine passes, and its scheduler's,
    replication's and fleet's counts) and "stop". Each answer is ("ok",
    value) or ("error", repr)."""
    try:
        from evolu_tpu_torch.ops import cuda_hash, cuda_scan
        from evolu_tpu_torch.server import engine as eng
        from evolu_tpu_torch.server.relay import RelayServer, RelayStore
        from evolu_tpu_torch.utils.config import FleetConfig

        relay = RelayServer(RelayStore(path, backend="native"), batching=True, peers=[],
                            replication_interval_s=1.0, device=device)
        if debounce_s is not None:
            relay.replication.debounce_s = debounce_s
        counters = {"seg_lex_max_scan": cuda_scan.segmented_max_scan_cuda,
                    "seg_xor_scan": cuda_scan.segmented_xor_scan_cuda,
                    "timestamp_hash": cuda_hash.timestamp_hash_cuda,
                    "seg_sum_scan": cuda_scan.segmented_sum_scan_cuda}
        routes0 = dict(eng.counts)
    except BaseException as e:  # noqa: BLE001 - answered to the parent
        conn.send(("error", repr(e)))
        return
    conn.send(("ok", relay.url))
    while True:
        cmd, arg = conn.recv()
        try:
            if cmd == "join":
                relay.enable_fleet(FleetConfig.from_json(arg))  # before start: gossip is placement-scoped
                relay.start()
                out = None
            elif cmd == "trees":
                out = dict(relay.store.owner_trees())
            elif cmd == "rows":
                out = owner_rows(relay.store)
            elif cmd == "rebalance":
                out = relay.fleet.rebalance_once()
            elif cmd == "stop_gossip":
                relay.replication.stop()
                out = None
            elif cmd == "counts":
                pcs = relay.replication.peer_counts.values()
                out = {"launches": {k: f.launches for k, f in counters.items()},
                       "passes": sum(eng.counts[k] - routes0[k] for k in ("delta", "full", "overflow")),
                       "routes": {k: eng.counts[k] - routes0[k] for k in ROUTES},
                       "scheduler": dict(relay.scheduler.counts), "fleet": dict(relay.fleet.counts),
                       "rounds_ok": sum(pc["rounds_ok"] for pc in pcs),
                       "rounds_error": sum(pc["rounds_error"] for pc in pcs),
                       "messages_pulled": sum(pc["messages_pulled"] for pc in pcs)}
            elif cmd == "stop":
                stop_relay(relay)
                conn.send(("ok", None))
                return
            else:
                raise ValueError(f"unknown command {cmd!r}")
        except BaseException as e:  # noqa: BLE001 - answered to the parent
            conn.send(("error", repr(e)))
            continue
        conn.send(("ok", out))


class I3Member:
    """The parent's handle of an `i3_member` process (spawned)."""

    def __init__(self, ctx, path, debounce_s=None):
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=i3_member, args=(child, path, debounce_s, I3_MEMBER_DEVICE), daemon=True)
        self.proc.start()
        child.close()
        self.url = None

    def _answer(self, what, timeout):
        if not self.conn.poll(timeout):
            raise AssertionError(f"path I3: member {self.url} did not answer {what} in {timeout:.0f} s")
        kind, value = self.conn.recv()
        if kind != "ok":
            raise AssertionError(f"path I3: member {self.url} failed {what}: {value}")
        return value

    def ready(self):
        self.url = self._answer("its start", I_WAIT_S)

    def call(self, cmd, arg=None, timeout=I_WAIT_S):
        self.conn.send((cmd, arg))
        return self._answer(cmd, timeout)

    def close(self):
        try:
            if self.proc.is_alive() and self.url is not None:
                self.call("stop", timeout=120)
        finally:
            self.proc.join(30)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()


def i3_spawn(tmp):
    """Start I3's members (I3_RELAYS, then the joiner), each in a spawned
    process of its own; they start while path I2 runs. → (members, joiner)."""
    ctx = multiprocessing.get_context("spawn")
    members = [I3Member(ctx, os.path.join(tmp, f"i3_{i}.db")) for i in range(I3_RELAYS)]
    return members, I3Member(ctx, os.path.join(tmp, "i3_join.db"), I3_JOIN_DEBOUNCE_S)


def path_i3(torch, kernels, tmp, spawned):
    """I3, the owner-sharded fleet: I3_RELAYS card relays (batching, native
    file stores), each in a process of its own (`i3_member`), under one
    FleetConfig (R = I3_R) take I3_MESSAGES messages over 1k owners from
    I3_THREADS clients (random member, one 307 followed and cached). At the
    scoped-gossip fixpoint every owner's rows and tree on its primary and
    each replica equal a single per-request oracle relay's on a Python
    store that took the same requests. Then a fourth card relay joins by
    `POST /fleet/reload` (survivors first, then the joiner) while a writer
    keeps POSTing to the first half of the owners: at the new fixpoint
    every ACKed write is on every placed relay (the oracle took them too),
    quiet moved owners' trees equal the losing relay's, and the joiner cut
    at least one owner over at its watermark. I3's launches are the
    members' (each counted from 0 in its process), H = X = their engine
    passes; the parent launches nothing. `spawned` is `i3_spawn`'s
    (members, joiner), closed here. → (launches, report)."""
    import threading

    from evolu_tpu_torch.server.fleet import HashRing
    from evolu_tpu_torch.server.relay import RelayStore, serve_single_request
    from evolu_tpu_torch.utils.config import FleetConfig

    members, joiner = spawned
    oracle = RelayStore(backend="python")
    report = {}
    reset(kernels)
    try:
        t0 = time.perf_counter()
        trees = {}
        work = i3_workload(E_OWNERS, I3_MESSAGES, seed=42, trees=trees)
        join_work = i3_workload(E_OWNERS // 2, I3_JOIN_MESSAGES, seed=43, t0=10**6, trees=trees)
        del trees
        report["build_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        for m in members + [joiner]:
            m.ready()
        report["members_start_s"] = round(time.perf_counter() - t0, 3)
        cfg = FleetConfig(relays=tuple(m.url for m in members), replication_factor=I3_R, version=1)
        for m in members:
            m.call("join", cfg.to_json())
        urls = [m.url for m in members]
        wall, followed = i3_ingest(work, urls, I3_THREADS)
        t0 = time.perf_counter()
        for _uid, r in work:
            serve_single_request(oracle, r)
        oracle_s = time.perf_counter() - t0
        ring0 = HashRing(cfg)
        held0, wait0, compare0 = i3_fixpoint(ring0, members, oracle, "after the ingest")
        report["ingest"] = {"messages": I3_MESSAGES, "requests": len(work), "wall_s": round(wall, 4),
                            "msgs_per_s": round(I3_MESSAGES / wall), "requests_per_s": round(len(work) / wall, 1),
                            "redirects_followed": followed, "oracle_s": round(oracle_s, 4),
                            "fixpoint_wait_s": wait0, "compare_s": compare0}
        cfg2 = FleetConfig(relays=cfg.relays + (joiner.url,), replication_factor=I3_R, version=2)
        joiner.call("join", cfg2.to_json())
        everyone = members + [joiner]
        writer = {}
        wt = threading.Thread(target=lambda: writer.update(out=i3_ingest(join_work, urls + [joiner.url], 4)))
        wt.start()
        t0 = time.perf_counter()
        for m in everyone:  # survivors first, then the joiner
            code, body = http_json_post(m.url + "/fleet/reload", cfg2.to_json())
            if code != 200 or body["ring_version"] != 2:
                raise AssertionError(f"path I3: reload of {m.url} answered {code} {body}")
        extra = joiner.call("rebalance")  # waits out the reload's sweep
        rebalance_s = time.perf_counter() - t0
        wt.join()
        if "out" not in writer:
            raise AssertionError("path I3: the writer during the join failed")
        for _uid, r in join_work:
            serve_single_request(oracle, r)
        ring = HashRing(cfg2)
        held, wait1, compare1 = i3_fixpoint(ring, everyone, oracle, "after the join", stop=True)
        counts = {m.url: m.call("counts") for m in everyone}
        launches = {k: sum(c["launches"][k] for c in counts.values()) for k in read(kernels)}
        passes = sum(c["passes"] for c in counts.values())
        expect = {"seg_lex_max_scan": 0, "seg_xor_scan": passes, "timestamp_hash": passes, "seg_sum_scan": 0}
        if launches != expect or not passes or any(read(kernels).values()):
            raise AssertionError(f"path I3: the members launched {launches} for {passes} passes, the parent "
                                 f"{read(kernels)}")
        for u, c in counts.items():
            s, f = c["scheduler"], c["fleet"]
            if s["poisoned_batches"] or s["singles"] or s["rejected"] or c["rounds_error"] or f["rebalance_failures"]:
                raise AssertionError(f"path I3: counts at {u}: {c}")
        written = {uid for uid, _r in join_work}
        moved = [uid for uid in held[joiner.url] if joiner.url in ring.placement(uid)]
        quiet = [uid for uid in moved if uid not in written]
        for uid in quiet:
            for u in ring0.placement(uid):
                if u not in ring.placement(uid) and held[u][uid][0] != held[joiner.url][uid][0]:
                    raise AssertionError(f"path I3: moved owner {uid}'s tree differs from the losing relay's")
        fc = counts[joiner.url]["fleet"]
        if fc["cutovers_verified"] < 1:
            raise AssertionError(f"path I3: no owner cut over at its watermark: {fc}")
        report["join"] = {"messages_during_join": I3_JOIN_MESSAGES, "writer_wall_s": round(writer["out"][0], 4),
                          "rebalance_s": round(rebalance_s, 4), "second_sweep_owners": extra,
                          "owners_moved": len(moved), "quiet_owners_moved": len(quiet),
                          "fixpoint_wait_s": wait1, "compare_s": compare1,
                          "joiner_counts": {k: fc[k] for k in ("rebalanced_owners", "rebalanced_messages",
                                                              "cutovers_verified", "cutovers_superset")}}
        report.update({
            "engine_passes": passes,
            "relays": [{"url": u, "scheduler": c["scheduler"], "fleet": {k: v for k, v in c["fleet"].items() if v},
                        "rounds_ok": c["rounds_ok"], "messages_pulled": c["messages_pulled"],
                        "owners_stored": len(held[u]), "launches": c["launches"]} for u, c in counts.items()],
            "route_counts": {k: sum(c["routes"][k] for c in counts.values()) for k in ROUTES}})
    finally:
        oracle.close()
        for m in members + [joiner]:
            m.close()
    print(f"  path I3: {json.dumps(report)}", flush=True)
    return launches, report


def stop_relay(relay):
    """Stop a RelayServer, started or not (`stop()` waits for a serving
    loop that a relay never started does not run)."""
    if relay._thread is not None:
        relay.stop()
        return
    for part in (relay.replication, relay.scheduler):
        if part is not None:
            part.stop()
    relay._httpd.server_close()
    relay.store.close()


def http_json_post(url, payload):
    """POST a JSON body → (status, decoded JSON answer)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {}


def path_i(torch, kernels, keep, tmp, gpu=""):
    """Path I: I1, I2 and I3, each with its own launch counts (summed as
    path I). Stops H1's relay after I1; keeps only what paths J and K need
    in `keep` after I2. → (launches, report)."""
    report, per = {}, {}
    try:
        per["i1"], report["i1"] = path_i1(torch, kernels, keep, tmp)
    finally:
        keep.pop("h1_server").stop()
    # I3's members start (each its own process and CUDA context) while I2 runs.
    spawned = i3_spawn(tmp)
    try:
        per["i2"], report["i2"] = path_i2(torch, kernels, keep, tmp)
    except BaseException:
        for m in spawned[0] + [spawned[1]]:
            m.close()
        raise
    for k in [k for k in keep if k not in ("h1_wants", "k1_replay", "store_dump", "h_dump", "k_requests")]:
        del keep[k]
    per["i3"], report["i3"] = path_i3(torch, kernels, tmp, spawned)
    report["launches"] = per
    launches = {k: sum(p[k] for p in per.values()) for k in per["i1"]}
    return launches, report


# ---- path J: push subscriptions and the event-loop connection tier ------------------

J_IDLE = 10_000  # J1's parked idle long-polls (benchmarks/push_subscriptions.py: n_idle)
J_PROBES = 8  # probes parked on the hot owner a round (the bench's n_probes)
J_ROUNDS = 12  # push rounds (the bench's rounds)
J_POLL_ROUNDS = 3  # polling-baseline rounds (12 in the bench; 6 when path K was added, 3 with path P)
J_POLL_INTERVAL_S = 1.0  # the polling baseline's interval (the bench's POLL_INTERVAL_S)
J_IDLE_TIMEOUT_S = 55.0  # the hub's park ceiling: the idle fleet stays parked through J1
J_FD_MARGIN = 4096  # descriptors a process keeps besides one end of every idle connection
J_BASE = BASE_MILLIS + 20_000_000_000  # after every stamp of paths A-I
J_WRITER, J_SUB = "a" * 16, "5" * 16  # the writer's and the subscribers' nodes
J_SCHEMA = {"todo": ("title", "isCompleted", "createdAt", "updatedAt", "isDeleted", "createdBy")}

# J1's idle fleet: a child process holds the client end of every parked
# connection (the bench's split across two processes), so the relay's
# process holds one descriptor a connection. Commands on stdin: "park N"
# opens connections up to N in all and answers "parked N"; end of input
# closes them all.
J_PARKER = r"""
import socket, sys
host, port, node, timeout = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
socks = []
for line in sys.stdin:
    for k in range(len(socks), int(line.split()[1])):
        s = socket.create_connection((host, port), timeout=60)
        s.sendall(("GET /push/poll?owner=idle-%d&node=%s&cursor=0&timeout=%s HTTP/1.0\r\n"
                   "Content-Length: 0\r\n\r\n" % (k, node, timeout)).encode())
        socks.append(s)
    print("parked", len(socks), flush=True)
for s in socks:
    s.close()
"""


def j_fd_budget(n_idle):
    """This process's descriptor limit, raised (soft up to hard) so that it
    can hold one end of `n_idle` connections; the parker child inherits
    it. → (idle connections that fit, the limits as read and set)."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    need = n_idle + J_FD_MARGIN
    top = need if hard == resource.RLIM_INFINITY else min(need, hard)
    if soft != resource.RLIM_INFINITY and soft < top:
        resource.setrlimit(resource.RLIMIT_NOFILE, (top, hard))
    now = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    fits = n_idle if now == resource.RLIM_INFINITY else min(n_idle, now - J_FD_MARGIN)
    return fits, {"soft": soft, "hard": hard, "soft_set": now, "idle": fits, "cut": fits < n_idle}


def proc_status():
    """This process's OS threads and resident set (KiB), from /proc."""
    threads = rss_kb = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                threads = int(line.split()[1])
            elif line.startswith("VmRSS:"):
                rss_kb = int(line.split()[1])
    return threads, rss_kb


def j_body(owner, node, start, n):
    """An encoded sync request of `n` messages from `node` for `owner`
    (none: a pull), stamps unique from J_BASE."""
    from evolu_tpu_torch.sync import protocol

    msgs = tuple(protocol.EncryptedCrdtMessage(ts_one(J_BASE + (start + i) * 1000, 0, node), b"ct-%d" % (start + i))
                 for i in range(n))
    return protocol.encode_sync_request(protocol.SyncRequest(msgs, owner, node, "{}"))


def j_raw(method, path, body=b""):
    return (f"{method} {path} HTTP/1.0\r\nContent-Length: {len(body)}\r\n\r\n").encode() + body


def j_exchange(addr, raw, timeout=60.0):
    """One raw request on its own connection → the full raw response."""
    import socket

    with socket.create_connection(addr, timeout=timeout) as s:
        s.sendall(raw)
        return j_recv_all(s)


def j_recv_all(sock):
    out = bytearray()
    while chunk := sock.recv(65536):
        out += chunk
    return bytes(out)


def j_normalize(resp):
    """A raw response with its Date header masked (the one field two tiers
    may legitimately differ in)."""
    return re.sub(rb"\r\nDate: [^\r\n]*", b"\r\nDate: -", resp)


def j_park(addr, owner, timeout, cursor=0):
    import socket

    s = socket.create_connection(addr, timeout=60)
    s.sendall(j_raw("GET", f"/push/poll?owner={owner}&node={J_SUB}&cursor={cursor}&timeout={timeout}"))
    return s


def j_subscriptions(relay):
    import urllib.request

    with urllib.request.urlopen(relay.url + "/stats", timeout=60) as r:
        return json.loads(r.read())["push"]["subscriptions"]


def check_j(step, launches, passes):
    """H and X launched once an engine pass, L and S never."""
    expect = {"seg_lex_max_scan": 0, "seg_xor_scan": passes, "timestamp_hash": passes, "seg_sum_scan": 0}
    if launches != expect or not passes:
        raise AssertionError(f"path J {step}: launches {launches}, expected {expect}")


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def path_j1(torch, kernels, relay, gpu=""):
    """J1, idle scaling and the push round trip, the shape of
    benchmarks/push_subscriptions.py: J_IDLE idle long-polls (one owner
    each) parked on the event-tier card relay by a child process; the
    relay's `/stats` push subscriptions, OS threads and RSS at 0, half and
    all of them (threads flat from half to all, under 64). Then J_ROUNDS
    rounds of J_PROBES probes parked on a hot owner at its current cursor
    (so each waits for the round's write; the bench's cursor 0 answers at
    once after its first round), a writer's POST of one message, and each
    woken probe's confirmation sync round (push latency = POST to the
    round's answer); then J_POLL_ROUNDS rounds of the polling baseline at
    J_POLL_INTERVAL_S (pollers spread over the interval, latency = POST to
    the first poll that sees the row). Push p50 must beat it 5x. →
    (launches, report)."""
    import selectors
    import subprocess
    import threading

    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import _http_post

    n_idle, fds = j_fd_budget(J_IDLE)
    addr = relay._httpd.server_address[:2]
    routes0 = dict(eng.counts)
    reset(kernels)
    parker = subprocess.Popen([sys.executable, "-c", J_PARKER, addr[0], str(addr[1]), J_SUB, str(J_IDLE_TIMEOUT_S)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        scaling = []
        t0 = time.perf_counter()
        for target in (0, n_idle // 2, n_idle):
            parker.stdin.write(f"park {target}\n")
            parker.stdin.flush()
            if parker.stdout.readline().split() != ["parked", str(target)]:
                raise AssertionError(f"path J1: the parker child did not park {target} connections")
            wait_until(lambda: j_subscriptions(relay) >= target, f"{target} parked polls")
            threads, rss_kb = proc_status()
            scaling.append({"connections": target, "parked": j_subscriptions(relay), "threads": threads,
                            "python_threads": threading.active_count(), "rss_kb": rss_kb})
        park_s = time.perf_counter() - t0
        t_half, t_full = scaling[1]["threads"], scaling[2]["threads"]
        if t_full > t_half or t_full >= 64:
            raise AssertionError(f"path J1: threads {t_half} -> {t_full} from {n_idle // 2} to {n_idle} idle polls")

        hot, seq, push_lat = "hot-owner", 0, []
        for rnd in range(J_ROUNDS):
            probes = [j_park(addr, hot, 30.0, cursor=seq) for _ in range(J_PROBES)]
            # The hub's own waiter list for the hot owner: parked, not answered.
            wait_until(lambda: len(relay.push_hub._waiters.get(hot, ())) == J_PROBES, f"round {rnd}'s probes parked")
            t1 = time.monotonic()
            _http_post(relay.url, j_body(hot, J_WRITER, seq, 1))
            seq += 1
            sel = selectors.DefaultSelector()
            for s in probes:
                sel.register(s, selectors.EVENT_READ)
            done, deadline = 0, t1 + 30
            while done < J_PROBES and time.monotonic() < deadline:
                for key, _ in sel.select(timeout=1.0):
                    s = key.fileobj
                    sel.unregister(s)
                    resp = j_recv_all(s)
                    if not resp.endswith(b'"wake": true, "cursor": %d}' % seq):
                        raise AssertionError(f"path J1: round {rnd}: a probe answered {resp[-80:]!r}")
                    _http_post(relay.url, j_body(hot, J_SUB, 0, 0))  # the confirmation sync round
                    push_lat.append(time.monotonic() - t1)
                    s.close()
                    done += 1
            sel.close()
            if done != J_PROBES:
                raise AssertionError(f"path J1: round {rnd}: {done}/{J_PROBES} probes woke")
        poll_lat = []
        for rnd in range(J_POLL_ROUNDS):
            offsets = [(i + 0.5) / J_PROBES * J_POLL_INTERVAL_S for i in range(J_PROBES)]
            t1 = time.monotonic()
            _http_post(relay.url, j_body(hot, J_WRITER, seq, 1))
            seq += 1
            for off in offsets:
                time.sleep(max(0.0, (off - (time.monotonic() - t1)) % J_POLL_INTERVAL_S))
                while len(protocol.decode_sync_response(_http_post(relay.url, j_body(hot, J_SUB, 0, 0))).messages) < seq:
                    time.sleep(J_POLL_INTERVAL_S)
                poll_lat.append(time.monotonic() - t1)
        parked_at_end = j_subscriptions(relay)
    finally:
        parker.stdin.close()
        try:
            parker.wait(timeout=60)
        except subprocess.TimeoutExpired:
            parker.kill()
            parker.wait()
    launches = read(kernels)
    passes = engine_passes(routes0)
    push_ms = {"p50": round(percentile(push_lat, 0.5) * 1e3, 3), "p99": round(percentile(push_lat, 0.99) * 1e3, 3)}
    poll_ms = {"p50": round(percentile(poll_lat, 0.5) * 1e3, 3), "p99": round(percentile(poll_lat, 0.99) * 1e3, 3),
               "interval_s": J_POLL_INTERVAL_S}
    factor = poll_ms["p50"] / max(push_ms["p50"], 1e-9)
    counts = dict(relay.scheduler.counts)
    out = {"n_idle": n_idle, "fd_limits": fds, "idle_scaling": scaling, "park_s": round(park_s, 3),
           "idle_parked_at_end": parked_at_end, "probes": J_PROBES, "rounds": J_ROUNDS,
           "poll_rounds": J_POLL_ROUNDS,
           "push_ms": push_ms, "poll_ms": poll_ms, "push_vs_poll_p50_factor": round(factor, 2),
           "push": relay.push_hub.stats_payload(), "conn": relay._httpd.stats_payload(),
           "engine_passes": passes, "scheduler_counts": counts,
           "route_counts": {k: eng.counts[k] - routes0[k] for k in routes0}}
    print(f"  path J1: {json.dumps(out)} | {gpu}", flush=True)
    if factor < 5.0:
        raise AssertionError(f"path J1: push p50 only {factor:.2f}x better than {J_POLL_INTERVAL_S} s polling")
    if counts["poisoned_batches"] or counts["singles"] or counts["rejected"]:
        raise AssertionError(f"path J1: scheduler counts {counts}")
    check_j("J1", launches, passes)
    return launches, out


def path_j4(torch, kernels, relay, gpu=""):
    """J4, the client leg: two `create_evolu` handles (one mnemonic,
    `Config(push_subscribe=True, sync_interval=None)`, their planners on
    the card) against J1's relay. After one bind round each, a mutation on
    A becomes visible in B's query through B's push wake alone: no timer,
    no sync called on B. → (launches, report)."""
    from evolu_tpu_torch.api.query import table
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.sync.client import connect
    from evolu_tpu_torch.utils.config import Config

    cfg = Config(sync_url=relay.url, push_subscribe=True, sync_interval=None)
    wait_until(lambda: relay.push_hub.stats_payload()["subscriptions"] == 0, "J1's idle polls to close")
    routes0 = dict(eng.counts)
    reset(kernels)
    a = create_evolu(J_SCHEMA, config=cfg)
    b = create_evolu(J_SCHEMA, config=cfg, mnemonic=a.owner.mnemonic)
    try:
        ta, tb = connect(a), connect(b)
        for e, t in ((a, ta), (b, tb)):
            e.sync(refresh_queries=False)
            e.worker.flush()
            t.flush()
        wait_until(lambda: relay.push_hub.stats_payload()["subscriptions"] == 2, "both handles' polls")
        b_rounds = tb.counts.get("requests", 0)
        q = table("todo").select("title").serialize()
        t0 = time.perf_counter()
        a.create("todo", {"title": "pushed", "isCompleted": False})
        rows, deadline = [], time.monotonic() + 60
        while not rows and time.monotonic() < deadline:
            rows = b.query_once(q)
            if not rows:
                time.sleep(0.001)
        visible_s = time.perf_counter() - t0
        b_woken = tb.push_subscriber.wakes
        a_woken = ta.push_subscriber.wakes
        b_wake_rounds = tb.counts.get("requests", 0) - b_rounds
        timers = (getattr(a, "_auto_syncer", None), getattr(b, "_auto_syncer", None))
    finally:
        a.dispose()
        b.dispose()
    launches = read(kernels)
    passes = engine_passes(routes0)
    out = {"mutation_to_visible_ms": round(visible_s * 1e3, 3), "rows_at_b": rows, "b_push_wakes": b_woken,
           "a_push_wakes": a_woken, "b_sync_rounds_after_bind": b_wake_rounds, "engine_passes": passes}
    print(f"  path J4: {json.dumps(out)} | {gpu}", flush=True)
    if rows != [{"title": "pushed"}] or b_woken < 1 or a_woken != 0 or timers != (None, None) or b_wake_rounds < 1:
        raise AssertionError(f"path J4: B saw {rows} after {b_woken} wakes ({b_wake_rounds} rounds), "
                             f"A woke {a_woken} times, timers {timers}")
    check_j("J4", launches, passes)
    return launches, out


def path_j3(torch, kernels, tmp):
    """J3, byte identity of the tiers on the card: one mutation stream (12
    writes over 3 owners, a subscriber parked on the first owner and woken,
    a cold pull, an immediate and a malformed poll) at an event-tier and at
    a threaded batching card relay, one after the other. Every raw response
    equal with the Date header masked, both stores' tables and both
    `/stats` push sections equal. → (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore

    sides = {}
    routes0 = dict(eng.counts)
    reset(kernels)
    for tier in ("eventloop", "threaded"):
        relay = RelayServer(RelayStore(os.path.join(tmp, f"j3-{tier}.db"), backend="native"), batching=True,
                            connection_tier=tier).start()
        try:
            addr = relay._httpd.server_address[:2]
            sub = j_park(addr, "ow-0", 30.0)
            wait_until(lambda: relay.push_hub.stats_payload()["subscriptions"] == 1, f"the {tier} subscriber")
            outs = [j_exchange(addr, j_raw("POST", "/", j_body(f"ow-{i % 3}", J_WRITER, i * 10, 3)))
                    for i in range(12)]
            outs.append(j_recv_all(sub))
            sub.close()
            outs += [j_exchange(addr, j_raw("POST", "/", j_body("ow-0", J_SUB, 0, 0))),
                     j_exchange(addr, j_raw("GET", f"/push/poll?owner=ow-1&node={J_SUB}&cursor=0&timeout=0")),
                     j_exchange(addr, j_raw("GET", "/push/poll?owner=ow-1&node=zz&cursor=0")),
                     j_exchange(addr, j_raw("GET", "/ping"))]
            sides[tier] = ([j_normalize(o) for o in outs], relay.push_hub.stats_payload(), e_dump(relay.store))
        finally:
            relay.stop()
    launches = read(kernels)
    passes = engine_passes(routes0)
    ev, th = sides["eventloop"], sides["threaded"]
    diverged = [i for i, (a, b) in enumerate(zip(ev[0], th[0])) if a != b]
    out = {"responses": len(ev[0]), "diverged": diverged, "push": ev[1], "rows": len(ev[2][0]),
           "owners": len(ev[2][1]), "engine_passes": passes,
           "woken_poll": ev[0][12].split(b"\r\n\r\n", 1)[1].decode()}
    print(f"  path J3: {json.dumps(out)}", flush=True)
    if diverged or ev[1] != th[1] or ev[2] != th[2]:
        raise AssertionError(f"path J3: responses {diverged} diverged, push sections {ev[1]} / {th[1]}, "
                             f"stores equal: {ev[2] == th[2]}")
    if out["woken_poll"] != '{"wake": true, "cursor": 1}' or out["rows"] != 36 or not ev[0][14].startswith(
            b"HTTP/1.0 200") or not ev[0][15].startswith(b"HTTP/1.0 400"):
        raise AssertionError(f"path J3: unexpected answers {out}")
    check_j("J3", launches, passes)
    return launches, out


def path_j(torch, kernels, tmp, gpu=""):
    """Path J: J1 and J4 on one event-tier card relay, then J3, each with
    its own launch counts (summed as path J). → (launches, report)."""
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore

    report, per = {}, {}
    relay = RelayServer(RelayStore(os.path.join(tmp, "j1.db"), backend="native"), batching=True,
                        connection_tier="eventloop").start()
    try:
        per["j1"], report["j1"] = path_j1(torch, kernels, relay, gpu)
        per["j4"], report["j4"] = path_j4(torch, kernels, relay, gpu)
    finally:
        relay.stop()
    per["j3"], report["j3"] = path_j3(torch, kernels, tmp)
    report["launches"] = per
    launches = {k: sum(p[k] for p in per.values()) for k in per["j1"]}
    return launches, report


# ---- path K: the write-behind storage inversion on the card ------------------------

K2_MAX_ROWS = 1 << 22  # K2's queue bound: `run_batch_wire` alone has no 503 path, so E1 must fit
K3_BATCHES = 12  # the reference torture's 12 seeded batches
# Owners, most owners a batch, most new messages an owner: ~4,000 messages a batch (500 an owner, ~8,000
# a batch, until the cut for path Q).
K3_SIZE = (64, 64, 250)
# K3's batches redeliver no earlier rows (the worker's `resend=0`): a redelivery makes the respond
# wait for its owner's shard to drain (the exact re-read), and nearly every batch of 64 owners holds
# one, so the queue would be empty at every ACK. With none, the drain stalled a second before each
# commit leaves the batches since the last one queued, and the SIGKILL finds them for the replay.
K3_RESEND = 0.0
K3_DRAIN_DELAY_S = 0.5  # cut from a second to make room for path O
# (shards, drain workers, seed): 3 shards with 3 workers (the one-shard episode, seed 71, was cut
# when path P was added). The seed (of the reference tortures) kills after the 7th ACK (batch 6),
# two batches past the checkpoint of batch 4.
K3_RUNS = ((3, 3, 7),)


def k_dump(store):
    """Path E's `e_dump` over every shard of a store, merged in its order."""
    parts = [e_dump(s) for s in (getattr(store, "shards", None) or [store])]
    if len(parts) == 1:
        return parts[0]
    return sorted(r for p in parts for r in p[0]), sorted(r for p in parts for r in p[1])


def check_k(step, launches, passes):
    """H and X launched once an engine dispatch, L and S never."""
    expect = {"seg_lex_max_scan": 0, "seg_xor_scan": passes, "timestamp_hash": passes, "seg_sum_scan": 0}
    if launches != expect or not passes:
        raise AssertionError(f"path K {step}: launches {launches}, expected {expect}")


def path_k1(torch, kernels, keep, tmp, h1, gpu=""):
    """K1, H1 with write-behind on: the bodies of H1's first K1_OWNERS
    owners (their E1 and E2 requests, 256 requests, ~148,000 messages),
    each from its H1 client lane (32 lanes), to `RelayServer(RelayStore(
    <file>, backend="native"), batching=True, write_behind=True)` on the
    card at the Config's defaults (fsync on, 2^20 rows, drain batches of
    2^16, one drain worker). A full queue answers 503 + Retry-After, which
    `_http_post` retries. Every response equals path E's; after `flush()`
    the tables equal path E's store's rows of these owners; `/health`
    answers 200, and after `stop()` the log is its magic alone.
    → (launches, report)."""
    import threading
    import urllib.request

    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.storage import write_behind as wbm
    from evolu_tpu_torch.sync.client import _http_post

    bodies, want, lanes, n, owners, _stamps = keep["k1_replay"]  # paths O2 and O3 replay it too
    path = os.path.join(tmp, "k1.db")
    server = RelayServer(RelayStore(path, backend="native"), batching=True, write_behind=True).start()
    wb = server.write_behind
    got, lat, errors, sizes, stalled, appends, backlog = [None] * len(bodies), [0.0] * len(bodies), [], [], [], [], [0]
    routes0 = dict(eng.counts)
    orig_run = eng.BatchReconciler.run_batch_wire

    def sized(self, requests):
        sizes.append(len(requests))
        try:
            return orig_run(self, requests)
        except wbm.WriteBehindFull:
            stalled.append(len(requests))
            raise
        finally:
            backlog[0] = max(backlog[0], wb.backlog()[1])

    def lane(ix):
        try:
            for i in ix:
                t1 = time.perf_counter()
                got[i] = _http_post(server.url, bodies[i])
                lat[i] = time.perf_counter() - t1
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    reset(kernels)
    try:
        with patched(eng.BatchReconciler, "run_batch_wire", sized), durations(wb, "_log_append", appends):
            threads = [threading.Thread(target=lane, args=(ix,)) for ix in lanes]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            wb.flush()
            flush_s = time.perf_counter() - t0
        launches = read(kernels)
        passes = engine_passes(routes0)
        counts, wb_counts = dict(server.scheduler.counts), dict(wb.counts)
        deferred = {k: eng.counts[k] - routes0[k] for k in ("deferred_passes", "store_duplicate")}
        if errors:
            raise AssertionError("path K1: a client's POST failed") from errors[0]
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"path K1: {len(bad)} responses differ from path E's (first: request {bad[0]})")
        with urllib.request.urlopen(server.url + "/health", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        t1 = time.perf_counter()
        theirs = tuple([row for row in rows if row[0] in owners] for rows in keep["store_dump"])
        if k_dump(server.store) != theirs:
            raise AssertionError("path K1: after the flush the tables differ from path E's store's rows of "
                                 "these owners")
        compare_s = time.perf_counter() - t1
    finally:
        server.stop()
    with open(path + ".wblog", "rb") as f:
        log_after_stop = f.read()
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {"requests": len(bodies), "owners": len(owners), "messages": n, "client_threads": len(lanes),
           "serve_wall_s": round(wall, 4), "serve_msgs_per_s": round(n / wall),
           "requests_per_s": round(len(bodies) / wall, 1), "latency_ms_p50": round(lat_ms[len(lat_ms) // 2], 3),
           "latency_ms_p99": round(lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))], 3),
           "engine_passes": len(sizes), "stalled_passes": len(stalled),
           "backpressure_503": sum(stalled) + counts["rejected"], "backlog_rows_max": backlog[0],
           "log_appends": len(appends), "log_append_s": round(sum(appends), 4),
           "flush_s": round(flush_s, 4), "end_to_end_msgs_per_s": round(n / (wall + flush_s)),
           "health": health[0], "queue_counts": wb_counts, "deferred": deferred,
           "scheduler_counts": counts,
           "route_counts": {k: eng.counts[k] - routes0[k] for k in ROUTES}, "compare_s": round(compare_s, 3),
           "h1": {k: h1[k] for k in ("msgs_per_s", "requests_per_s", "latency_ms_p50", "latency_ms_p99",
                                     "engine_passes", "wall_s")}}
    print(f"  path K1: {json.dumps(out)} | {gpu}", flush=True)
    if counts["poisoned_batches"] or counts["singles"] or counts["batches"] != len(sizes) - len(stalled) \
            or counts["coalesced"] != len(bodies):
        raise AssertionError(f"path K1: scheduler counts {counts} for {len(sizes)} engine passes")
    if health[0] != 200 or health[1]["write_behind"]["backlog_rows"] or log_after_stop != wbm.LOG_MAGIC:
        raise AssertionError(f"path K1: /health {health}, {len(log_after_stop)} log bytes after stop()")
    if wb_counts["queued"] != wb_counts["drained"] or wb_counts["drain_failures"] \
            or deferred["deferred_passes"] != len(sizes):
        raise AssertionError(f"path K1: queue counts {wb_counts}, {deferred} for {len(sizes)} passes")
    check_k("K1", launches, passes)
    return launches, out


def path_k2(torch, kernels, keep, tmp, h2, gpu=""):
    """K2, H2 with write-behind on: H1's owners' E1 requests in H2's batches of
    125 owners, then their E2 requests, through `run_batch_wire` with a
    `WriteBehindQueue` (its log beside
    the shards, 4 drain workers) over a 4-shard native file
    `ShardedRelayStore`. Serve ms of each batch beside H2's, then the
    flush; the responses equal path E's, the drained tables path E's
    store's. → (launches, report)."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import ShardedRelayStore
    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    e1, e2 = keep["k_requests"]
    want = keep["h1_wants"]
    per = len(e1) // H2_BATCHES
    batches = [e1[i * per:(i + 1) * per] for i in range(H2_BATCHES - 1)] + [e1[(H2_BATCHES - 1) * per:], e2]
    n = sum(len(r.messages) for b in batches for r in b)
    path = os.path.join(tmp, "k2.db")
    store = ShardedRelayStore(path, backend="native", shards=4)
    wb = WriteBehindQueue(store, log_path=path + ".wblog", max_rows=K2_MAX_ROWS, drain_workers=4)
    rec = eng.BatchReconciler(store, write_behind=wb)
    routes0 = dict(eng.counts)
    reset(kernels)
    got, per_batch = [], []
    try:
        t0 = time.perf_counter()
        for b in batches:
            t1 = time.perf_counter()
            got += rec.run_batch_wire(b)
            per_batch.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        wb.flush()
        flush_s = time.perf_counter() - t0
        launches = read(kernels)
        passes = engine_passes(routes0)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad or len(got) != len(want):
            raise AssertionError(f"path K2: {len(bad)} responses differ from path E's")
        if k_dump(store) != keep["h_dump"]:
            raise AssertionError("path K2: the drained tables differ from path E's store")
        wb_counts = dict(wb.counts)
        deferred = eng.counts["deferred_passes"] - routes0["deferred_passes"]
    finally:
        wb.close()
        rec.close()
        store.close()
    h2_rbw = h2["run_batch_wire"]["per_batch_ms"]
    out = {"batches": len(batches), "messages": n, "shards": 4, "drain_workers": 4,
           "serve_wall_s": round(wall, 4), "serve_msgs_per_s": round(n / wall),
           "per_batch_ms": [round(x * 1e3, 2) for x in per_batch], "flush_s": round(flush_s, 4),
           "end_to_end_msgs_per_s": round(n / (wall + flush_s)), "queue_counts": wb_counts,
           "deferred_passes": deferred, "h2_run_batch_wire": {"msgs_per_s": h2["run_batch_wire"]["msgs_per_s"],
                                 "per_batch_ms": [round(a + b, 2) for a, b in zip(h2_rbw["dispatch"],
                                                                                    h2_rbw["host_leg"])]}}
    print(f"  path K2: {json.dumps(out)} | {gpu}", flush=True)
    if wb_counts["queued"] != wb_counts["drained"] or wb_counts["drain_failures"] or wb_counts["stalls"] \
            or deferred != len(batches):
        raise AssertionError(f"path K2: queue counts {wb_counts}, {deferred} deferred passes")
    check_k("K2", launches, passes)
    return launches, out


def path_k3(torch, kernels, tmp, gpu=""):
    """K3, crash and replay on the card, through `tests/
    _torch_write_behind_worker.py` (the port's copy of the reference
    torture's worker): a child serves K3_BATCHES seeded batches of ~4,000
    messages on the card with the drain slowed and a checkpoint every 4th
    batch, the parent SIGKILLs it at a seeded ACK count, and a fresh
    process replays the log (the host fold: no kernel) and flushes. Its
    state crc must equal a synchronous card twin's of the ACKed prefix (or
    prefix+1, or a record prefix of the next batch on 3 shards), and the
    replay must have found rows. K3's launches are the serving children's
    up to their last ACK (each counted from 0 in a fresh process), where
    H = X = the child's engine dispatches; the parent's counts move only
    with its twins (the oracle), which are checked apart and not counted.
    The two runs go side by side, each in its own thread.
    → (launches, report)."""
    from concurrent.futures import ThreadPoolExecutor

    from evolu_tpu_torch.server import engine as eng

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _torch_write_behind_worker as worker

    def run(shards, workers, seed):
        d = os.path.join(tmp, f"k3-{shards}")
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        got = worker.torture(os.path.join(d, "victim.db"), seed, K3_BATCHES, K3_DRAIN_DELAY_S, shards, workers,
                             device="cuda", size=K3_SIZE, twin_device="cuda", resend=K3_RESEND)
        return got, time.perf_counter() - t0

    out = {}
    routes0 = dict(eng.counts)
    reset(kernels)
    with ThreadPoolExecutor(len(K3_RUNS)) as pool:
        runs = [pool.submit(run, *r) for r in K3_RUNS]
        results = [f.result() for f in runs]
    # The parent's counts are the twins' (the oracle), apart from K3's own.
    check_k("K3's twins", read(kernels), engine_passes(routes0))
    hxls = ("timestamp_hash", "seg_xor_scan", "seg_lex_max_scan", "seg_sum_scan")  # the child's order
    launches = dict.fromkeys(hxls, 0)
    for (shards, workers, seed), (got, wall) in zip(K3_RUNS, results):
        fin, child = got["finish"], got["child"]
        h, x, lex, s = (int(v) for v in child["launches"].split(","))
        rows, replay_s = int(fin["rows"]), float(fin["replay_s"])
        step = {"shards": shards, "drain_workers": workers, "seed": seed, "acked_batches": got["acked"] + 1,
                "acked_messages": got["messages"], "crc": got["crc"], "accepted": sorted(got["accepted"]),
                "replayed_records": int(fin["records"]), "replayed_rows": rows, "replay_s": replay_s,
                "replay_rows_per_s": round(rows / replay_s) if replay_s else None,
                "replay_launches": int(fin["launches"]), "child_passes": int(child["passes"]),
                "child_launches_hxls": [h, x, lex, s], "wall_s": round(wall, 3)}
        out[f"shards_{shards}"] = step
        print(f"  path K3: {json.dumps(step)} | {gpu}", flush=True)
        if got["crc"] not in got["accepted"]:
            raise AssertionError(f"path K3: the replayed state {got['crc']} matches no twin {got['accepted']}")
        if not rows:
            raise AssertionError(f"path K3: the SIGKILL left nothing to replay on {shards} shard(s)")
        if step["replay_launches"] or [h, x, lex, s] != [step["child_passes"]] * 2 + [0, 0] or not h:
            raise AssertionError(f"path K3: replay launches {step['replay_launches']}, serving child "
                                 f"H, X, L, S {[h, x, lex, s]} for {step['child_passes']} passes")
        for name, n in zip(hxls, (h, x, lex, s)):
            launches[name] += n
    return launches, out


def path_k(torch, kernels, keep, tmp, h1, h2, gpu=""):
    """Path K: K1, K2 and K3, each with its own launch counts (summed as
    path K). → (launches, report)."""
    report, per = {}, {}
    per["k1"], report["k1"] = path_k1(torch, kernels, keep, tmp, h1, gpu)
    per["k2"], report["k2"] = path_k2(torch, kernels, keep, tmp, h2, gpu)
    replay = keep["k1_replay"]
    keep.clear()
    keep["k1_replay"] = replay  # for paths O2 and O3
    per["k3"], report["k3"] = path_k3(torch, kernels, tmp, gpu)
    report["launches"] = per
    launches = {k: sum(p[k] for p in per.values()) for k in per["k2"]}
    return launches, report


# ---- path O: observability on the reconcile pass and the live relay ----------------

O_REPS = ("off", "on") * 4  # O1's interleaved runs, after one untimed warm-up run
O_PROFILE_MS = 1000.0  # O2's /profile window, opened as its lanes start
O_TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
O_STAGES = ("key_sort", "plan_compare", "hash_render", "minute_fold")
# A Prometheus 0.0.4 sample line: name, optional {label="value",...}, value.
_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*",?)*\})? '
    r'([-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$')


def obs_planes(on: bool) -> None:
    """Every observability plane on or off: the metrics registry (and the
    stage anatomy, which follows it), tracing at 100% sampling, and the
    logger's record_function annotations."""
    from evolu_tpu_torch.obs import metrics, trace
    from evolu_tpu_torch.utils import log as log_mod

    metrics.set_enabled(on)
    trace.set_enabled(on)
    trace.set_sample_rate(1.0)
    log_mod.enable_trace_annotations(on)


def parse_prometheus(text):
    """Prometheus text format 0.0.4, strictly: every line a HELP or TYPE
    comment or a sample; → {(name, labels text): value}."""
    out = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            if not re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$", line):
                raise AssertionError(f"path O2: /metrics comment line not 0.0.4: {line[:120]!r}")
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise AssertionError(f"path O2: /metrics sample line not 0.0.4: {line[:120]!r}")
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def median_events_ms(torch, fn, reps=5):
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def path_o1(torch, kernels, gpu=""):
    """O1: path A's columns pass at 1M messages, obs off / on / off / on.
    → (launches, report)."""
    from evolu_tpu_torch.obs import metrics, trace
    from evolu_tpu_torch.ops import bucket_size, columns_to_device
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import merkle_ops as mo
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.parallel import reconcile as pr
    from evolu_tpu_torch.parallel.mesh import single_mesh
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.utils.log import logger, span

    n = 1_000_000
    cols = build_columns(n)
    mesh = single_mesh(torch.device("cuda"))
    rows = len(cols["cell_id"])
    ev = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev[name] = e

    def spy(orig, before, after):
        def run(*a, **kw):
            if before and before not in ev:
                mark(before)
            out = orig(*a, **kw)
            if after and after not in ev:
                mark(after)
            return out
        return run

    waves = []

    def counted(*xs):
        waves.append(1)
        return orig_pull(*xs)

    orig_pull = pr.to_host_many
    runs, outputs = [], []
    logger.clear()
    obs_planes(False)
    pr.reconcile_columns_sharded(mesh, cols)  # warm-up: the sort's and the scans' first-call allocations
    try:
        for i, mode in enumerate(O_REPS):
            obs_planes(mode == "on")
            ev.clear()
            waves.clear()
            reset(kernels)
            torch.cuda.synchronize()
            root = trace.start_span("o1.columns_pass", attrs={"messages": n})
            with contextlib.ExitStack() as stack:
                stack.enter_context(patched(pm, "segmented_max_scan", spy(pm.segmented_max_scan, "key_sort_end", None)))
                stack.enter_context(patched(pr, "masked_key_hashes",
                                            spy(pr.masked_key_hashes, "plan_compare_end", "hash_render_end")))
                stack.enter_context(patched(pr, "to_host_many", counted))
                stack.enter_context(trace.use(root.context))
                t0 = time.perf_counter()
                with span("kernel:reconcile", "o1.columns_pass", n=n):
                    kernel = pr.shard_kernel_for(cols, mesh.devices[0])

                    def timed(*a):
                        mark("start")
                        out = kernel(*a)
                        mark("minute_fold_end")
                        return out

                    outs = pr.dispatch_columns_sharded(mesh, cols, kernel=timed)
                    torch.cuda.synchronize()
                    t_pull = time.perf_counter()
                    pulled = pr.pull_shards(outs)
                    pull_s = time.perf_counter() - t_pull
                *arrays, digests = pulled
                digest = pr.xor_allreduce(digests.view(np.uint32).tolist(), mesh)
                xor_mask, upsert_mask = unpermute_masks(*arrays[:3])
                wall = time.perf_counter() - t0
            root.end()
            launches = read(kernels)
            order = ["start", "key_sort_end", "plan_compare_end", "hash_render_end", "minute_fold_end"]
            stages = {nm: ev[a].elapsed_time(ev[b]) for nm, a, b in zip(O_STAGES, order, order[1:])}
            runs.append({"mode": mode, "stage_ms": stages, "pass_s": wall, "pull_s": pull_s,
                         "pull_bytes": int(sum(a.nbytes for a in pulled)), "waves": len(waves),
                         "launches": launches})
            outputs.append((arrays, digest, xor_mask, upsert_mask))
            del outs, pulled
        on_spans = [s for s in trace.recorder.dump() if s.name.startswith("kernel:reconcile")]
        kernel_spans = metrics.registry.get_histogram("evolu_kernel_span_ms", target="kernel:reconcile")
    finally:
        obs_planes(True)
        from evolu_tpu_torch.utils import log as log_mod

        log_mod.enable_trace_annotations(False)
    base = outputs[0]
    for i, (arrays, digest, xm, um) in enumerate(outputs[1:], 1):
        if digest != base[1] or not all(np.array_equal(a, b) for a, b in zip(arrays, base[0])) \
                or not np.array_equal(xm, base[2]) or not np.array_equal(um, base[3]):
            raise AssertionError(f"path O1: run {i} ({O_REPS[i]}) differs from run 0 (off) in masks, "
                                 "segments or digest")
    if any(r["launches"] != runs[0]["launches"] or r["waves"] != runs[0]["waves"] for r in runs):
        raise AssertionError(f"path O1: launches or pull waves differ between runs: "
                             f"{[(r['mode'], r['launches'], r['waves']) for r in runs]}")
    want = {"seg_lex_max_scan": 2, "timestamp_hash": 1, "seg_xor_scan": 1, "seg_sum_scan": 0}
    if runs[0]["launches"] != want:
        raise AssertionError(f"path O1: launches {runs[0]['launches']}, expected {want} a pass")
    n_on = O_REPS.count("on")
    if len(on_spans) != n_on or kernel_spans is None or kernel_spans[3] != n_on:
        raise AssertionError(f"path O1: the on runs recorded {len(on_spans)} trace spans, "
                             f"{kernel_spans and kernel_spans[3]} span observations ({n_on} each expected)")

    def mean(mode, key):
        return statistics.mean(r[key] if key in r else r["stage_ms"][key] for r in runs if r["mode"] == mode)

    overhead = {k: (mean("on", k) - mean("off", k)) / mean("off", k) for k in O_STAGES + ("pass_s",)}
    spread = {k: (max(r["stage_ms"][k] for r in runs if r["mode"] == "off")
                  - min(r["stage_ms"][k] for r in runs if r["mode"] == "off")) / mean("off", k) for k in O_STAGES}

    # The cost laws' other terms, on the same inputs with obs off.
    t = columns_to_device(cols, "cuda")
    args = [t[k] for k in pr.COLUMN_NAMES]
    a_, b_ = pm.winner_flags(*args[1:5])
    idx = torch.arange(rows, dtype=torch.int64, device=args[0].device)
    key = pr.pack_owner_cell_key(args[5], args[0], idx, lo_bits=2,
                                 lo=(b_.to(torch.int64) << 1) | a_.to(torch.int64))
    sort_ms = median_events_ms(torch, lambda: torch.sort(key))
    segs = pr._shard_kernel(*args)[3:8]
    cap = bucket_size(max(rows // 8, 64))
    compact_ms = median_events_ms(torch, lambda: eng.compact_segments(*segs, cap))
    del t, args, key, segs, idx, a_, b_
    torch.cuda.empty_cache()
    off_stage = {k: statistics.median(r["stage_ms"][k] for r in runs if r["mode"] == "off") for k in O_STAGES}
    per_1m = 1e6 / rows
    pull_mb_s = statistics.median(r["pull_bytes"] / r["pull_s"] / 1e6 for r in runs if r["mode"] == "off")
    laws = {
        "sort_key_ms_per_1m": sort_ms * per_1m,
        "sort_payload_ms_per_1m": max(off_stage["key_sort"] - sort_ms, 0.0) / 2 * per_1m,
        "plan_scan_pair_ms_per_1m": off_stage["plan_compare"] * per_1m,
        "hash_render_ms_per_1m": off_stage["hash_render"] * per_1m,
        "minute_fold_ms_per_1m": off_stage["minute_fold"] * per_1m,
        "delta_encode_ms_per_1m": compact_ms * per_1m,
        "pull_mb_per_s": pull_mb_s,
    }
    report = {
        "messages": n, "rows_padded": rows, "kernel": kernel.__name__, "runs": [
            {**r, "stage_ms": {k: round(v, 4) for k, v in r["stage_ms"].items()}, "pass_s": round(r["pass_s"], 4),
             "pull_s": round(r["pull_s"], 5)} for r in runs],
        "stage_ms_off": {k: round(v, 4) for k, v in off_stage.items()},
        "overhead_on_vs_off": {k: round(v, 5) for k, v in overhead.items()},
        "off_spread": {k: round(v, 5) for k, v in spread.items()},
        "bare_key_sort_ms": round(sort_ms, 4), "compact_delta_ms": round(compact_ms, 4),
        "cost_laws_measured": {k: round(v, 4) for k, v in laws.items()},
    }
    print(f"  path O1: {json.dumps(report)} | {gpu}", flush=True)
    total = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    return total, report


def path_o2(torch, kernels, keep, tmp, gpu=""):
    """O2: K1's replay at a batching card relay with every plane on, under a
    /profile capture. → (launches, report)."""
    import threading
    import urllib.request

    from evolu_tpu_torch.obs import anatomy, metrics
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore, prepare_device_profiler
    from evolu_tpu_torch.sync.client import _http_post
    from evolu_tpu_torch.utils.log import logger

    bodies, want, lanes, n, owners, _stamps = keep["k1_replay"]  # path O3 replays it too
    t0 = time.perf_counter()
    if not prepare_device_profiler():  # on this, the main thread: /profile's handler thread captures
        raise AssertionError("path O2: the device profiler cannot be prepared")
    prepare_s = time.perf_counter() - t0
    traced = lanes[0][0]
    parent = f"00-{O_TRACE_ID}-b7ad6b7169203331-01"
    logger.clear()
    obs_planes(True)
    from evolu_tpu_torch.utils import log as log_mod

    log_mod.enable_trace_annotations(False)  # /profile turns them on for its window
    server = RelayServer(RelayStore(os.path.join(tmp, "o2.db"), backend="native"), batching=True).start()
    got, errors, sizes, prof = [None] * len(bodies), [], [], {}
    routes0 = dict(eng.counts)
    orig_run = eng.BatchReconciler.run_batch_wire

    def sized(self, requests):
        sizes.append(len(requests))
        return orig_run(self, requests)

    def lane(ix):
        try:
            for i in ix:
                hdrs = {"traceparent": parent} if i == traced else None
                got[i] = _http_post(server.url, bodies[i], headers=hdrs)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    def profile():
        try:
            with urllib.request.urlopen(server.url + f"/profile?ms={O_PROFILE_MS}", timeout=300) as r:
                prof["doc"] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    def get(path):
        with urllib.request.urlopen(server.url + path, timeout=60) as r:
            return r.read()

    reset(kernels)
    try:
        with patched(eng.BatchReconciler, "run_batch_wire", sized):
            threads = [threading.Thread(target=profile)] + [threading.Thread(target=lane, args=(ix,))
                                                            for ix in lanes]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads[1:]:
                t.join()
            wall = time.perf_counter() - t0
            threads[0].join()
        launches = read(kernels)
        passes = engine_passes(routes0)
        counts = dict(server.scheduler.counts)
        t1 = time.perf_counter()
        text = get("/metrics").decode("utf-8")
        stats = json.loads(get("/stats"))
        req_trace = json.loads(get(f"/trace/{O_TRACE_ID}"))
        batch_spans = [s for s in req_trace["spans"] if s["name"] == "engine.batch"]
        batch_trace = json.loads(get(f"/trace/{batch_spans[0]['trace_id']}")) if batch_spans else {"spans": []}
        fetch_s = time.perf_counter() - t1
        platform = anatomy.get_platform()
    finally:
        server.stop()
    if errors:
        raise AssertionError("path O2: a client's POST or the /profile GET failed") from errors[0]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"path O2: {len(bad)} responses differ from path E's (first: request {bad[0]})")
    parsed = parse_prometheus(text)
    msgs = sum(v for (name, _), v in parsed.items()
               if name in ("evolu_crypto_v1_relay_messages_total", "evolu_crypto_v2_relay_messages_total"))
    counters = {"requests": parsed.get(("evolu_relay_requests_total", '{endpoint="/"}')),
                "messages": msgs, "coalesced": parsed.get(("evolu_sched_coalesced_requests_total", "")),
                "batches": parsed.get(("evolu_sched_batches_total", "")),
                "latency_count": parsed.get(("evolu_relay_request_ms_count", ""))}
    if counters != {"requests": len(bodies), "messages": n, "coalesced": len(bodies), "batches": len(sizes),
                    "latency_count": len(bodies)}:
        raise AssertionError(f"path O2: /metrics counters {counters}, driven: {len(bodies)} requests, {n} "
                             f"messages, {len(sizes)} passes")
    stages = stats.get("stages", {}).get("stages", {})
    if stats.get("latency_ms", {}).get("count") != len(bodies) \
            or not all(stages.get(k, {}).get("count") for k in ("device_dispatch", "pull_wave", "host_apply")):
        raise AssertionError(f"path O2: /stats latency_ms {stats.get('latency_ms')}, stages {sorted(stages)}")
    relay_spans = [s for s in req_trace["spans"] if s["name"] == "relay.sync" and s["trace_id"] == O_TRACE_ID]
    linked = [s for s in batch_spans if any(link[0] == O_TRACE_ID for link in s["links"])]
    merkle = [s for s in batch_trace["spans"] if s["name"].startswith("kernel:merkle")
              and linked and s["parent_id"] == linked[0]["span_id"]]
    if not (relay_spans and linked and merkle):
        raise AssertionError(f"path O2: /trace/{O_TRACE_ID}: relay.sync {len(relay_spans)}, linking engine.batch "
                             f"{len(linked)}, kernel:merkle under it {len(merkle)}")
    doc = prof.get("doc") or {}
    meta = doc.get("metadata", {})
    device_kernels = sorted({e["name"] for e in doc.get("traceEvents", []) if e.get("cat") == "kernel"})
    lane_ok = meta.get("device_lane") is True and any("lookback_scan" in k for k in device_kernels) \
        and any("ts_hash_kernel" in k for k in device_kernels)
    if not lane_ok:
        raise AssertionError(f"path O2: the /profile document has no device lane with the port's kernels: "
                             f"metadata {meta}, kernel events {device_kernels[:10]}")
    fams = sorted({name for (name, _) in parsed})
    hist = stages.get("device_dispatch", {}), stages.get("host_apply", {})
    rows_applied = metrics.get_counter("evolu_stage_rows_total", stage="host_apply")
    secs_applied = metrics.get_counter("evolu_stage_seconds_total", stage="host_apply")
    out = {"requests": len(bodies), "owners": len(owners), "messages": n, "client_threads": len(lanes),
           "serve_wall_s": round(wall, 4), "msgs_per_s": round(n / wall), "engine_passes": len(sizes),
           "scheduler_counts": counts, "metrics_counters": counters, "metrics_families": len(fams),
           "latency_ms": stats["latency_ms"], "platform": platform,
           "stages": {k: stages[k] for k in ("device_dispatch", "pull_wave", "host_apply")},
           "host_apply_rows_per_s": round(rows_applied / secs_applied) if secs_applied else None,
           "device_dispatch_fixed_ms": hist[0].get("fixed_ms"),
           "trace": {"request_spans": sorted({s["name"] for s in req_trace["spans"]}),
                     "batch_spans": sorted({s["name"] for s in batch_trace["spans"]})},
           "profile": {"device_kernels": device_kernels[:8], "events": len(doc.get("traceEvents", [])),
                       "wall_ms": meta.get("wall_ms"), "start_ms": meta.get("start_ms"),
                       "stop_ms": meta.get("stop_ms"), "export_ms": meta.get("export_ms"),
                       "host_span_events": meta.get("host_span_events"),
                       "trace_span_events": meta.get("trace_span_events")},
           "profiler_prepare_s": round(prepare_s, 3), "fetch_s": round(fetch_s, 3)}
    print(f"  path O2: {json.dumps(out, default=str)} | {gpu}", flush=True)
    expect = {"seg_lex_max_scan": 0, "seg_xor_scan": passes, "timestamp_hash": passes, "seg_sum_scan": 0}
    if launches != expect or passes < len(sizes) or not passes:  # an overflow rerun dispatches again
        raise AssertionError(f"path O2: launches {launches} for {passes} engine dispatches, expected {expect}")
    return launches, out


# ---- path O3: the conservation ledger's stations and the relay tier's legs ----------

O3_TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"  # the traced write whose hint arms the peer's round
O3B_TRACE_ID = "5c0f3e4b8d1a42c6b07e9a13d2f46e81"  # the traced forward across the fleet
O3_REDELIVER = 8  # exact redeliveries of K1 bodies after the burst
O3_UPPER_NODE = "ABCDEF0123456789"  # a node id in upper-case hex: the engine's host-owner route
O3_SHORT_NODE = "deadbeef"  # a node id of 8 hex digits: a non-canonical width, the singleton path's 500
O3B_OWNERS = 16  # owners placed on the second fleet relay, both their K1 bodies sent to the first
O3C_MESSAGES = 1 << 14  # the client's Receive: config 2's todo shape, above Config.min_device_batch


def o3_post(url, body, n, acct, lock, headers=None, retry=True, reject=False):
    """POST `body` (`n` messages) until it is served, counting every
    delivery's messages in `acct` as the script's own ledger: `attempts`,
    `shed` (a 503 answer), `rejected` (a 500, expected with `reject`) and
    `served`. With `retry=False` a 503 is the answer. → the response
    bytes, or None for a 503 not retried or a 500."""
    from evolu_tpu_torch.sync.client import _http_post

    while True:
        with lock:
            acct["attempts"] += n
        try:
            out = _http_post(url, body, retries=0, headers=headers)
        except urllib.error.HTTPError as e:
            if reject and e.code == 500:
                with lock:
                    acct["rejected"] += n
                return None
            if e.code != 503:
                raise
            with lock:
                acct["shed"] += n
            if not retry:
                return None
            time.sleep(0.05)
            continue
        with lock:
            acct["served"] += n
        return out


def o3_stations(before):
    """The conservation ledger's station totals since `before`."""
    from evolu_tpu_torch.obs import ledger

    now = ledger.totals()
    return {k: now.get(k, 0) - before.get(k, 0) for k in sorted(set(now) | set(before))
            if now.get(k, 0) != before.get(k, 0)}


def o3_get_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def o3_pull_waves():
    from evolu_tpu_torch.obs import metrics

    h = metrics.registry.get_histogram("evolu_pull_wave_bytes")
    return h[3] if h else 0


def o3_check_ledger(step, stations, want):
    """Each station of `want` equals the script's own count; on a mismatch
    the phase fails with the per-station deltas."""
    bad = {k: (stations.get(k, 0), v) for k, v in want.items() if stations.get(k, 0) != v}
    if bad:
        raise AssertionError(f"path {step}: ledger stations (counted, the script's own): {bad}; "
                             f"every station's delta: {stations}")


def o3_relay_burst(kernels, r, replay, acct, lock, tag):
    """R's traffic in one O3a run: K1's bodies from their 32 lanes, 8 exact
    redeliveries, a request whose node id is upper-case hex (the engine's
    host-owner route), one whose node id is 8 digits (a non-canonical
    width: it bounces to the singleton path, whose host oracle answers
    500) and one forced 503 shed (a scheduler queue of 0 for one request),
    then the queue's flush. Every K1 response must equal K1's. → (the
    distinct (owner, timestamp) rows served, the rejected request's
    messages, the burst's seconds, its launches, engine dispatches and
    pull waves)."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.sync import protocol

    bodies, want, lanes, _n, _owners, stamps = replay
    got, errors = [None] * len(bodies), []

    def lane(ix):
        try:
            for i in ix:
                got[i] = o3_post(r.url, bodies[i], len(stamps[i][1]), acct, lock)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    routes0, waves0 = dict(eng.counts), o3_pull_waves()
    reset(kernels)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lane, args=(ix,)) for ix in lanes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    burst_s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"path O3a ({tag}): a client's POST failed") from errors[0]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"path O3a ({tag}): {len(bad)} responses differ from K1's (first: request {bad[0]})")
    pairs = {(u, t) for u, ts in stamps for t in ts}
    for i in range(O3_REDELIVER):
        o3_post(r.url, bodies[i], len(stamps[i][1]), acct, lock)
    upper = [timestamp_to_string(Timestamp(BASE_MILLIS + 40_000_000_000 + j, 0, O3_UPPER_NODE)) for j in range(4)]
    o3_post(r.url, protocol.encode_sync_request(protocol.SyncRequest(
        tuple(protocol.EncryptedCrdtMessage(t, b"o3-upper-%d" % j) for j, t in enumerate(upper)),
        "o3-upper-owner", O3_UPPER_NODE.lower(), "{}")), len(upper), acct, lock)
    pairs.update(("o3-upper-owner", t) for t in upper)
    short = [f"{ts[:-16]}{O3_SHORT_NODE}" for ts in upper[:3]]
    o3_post(r.url, protocol.encode_sync_request(protocol.SyncRequest(
        tuple(protocol.EncryptedCrdtMessage(t, b"o3-short") for t in short), "o3-short-owner",
        O3_SHORT_NODE, "{}")), len(short), acct, lock, reject=True)
    queue_max, r.scheduler.max_queue = r.scheduler.max_queue, 0
    try:
        shed = o3_post(r.url, bodies[-1], len(stamps[-1][1]), acct, lock, retry=False)
    finally:
        r.scheduler.max_queue = queue_max
    if shed is not None:
        raise AssertionError(f"path O3a ({tag}): the forced shed was served")
    r.write_behind.flush()
    launches = read(kernels)
    counts = dict(r.scheduler.counts)
    if counts["singles"] != 1 or acct["rejected"] != len(short) or acct["shed"] < len(stamps[-1][1]):
        raise AssertionError(f"path O3a ({tag}): scheduler counts {counts}, the script's {dict(acct)}")
    return len(pairs), len(short), burst_s, launches, engine_passes(routes0), o3_pull_waves() - waves0


def path_o3a(torch, kernels, replay, tmp, tag, ledger_on, device=None, gpu=""):
    """O3a, one run (`tag` names it): R's traffic (`o3_relay_burst`) at a
    fresh write-behind batching card relay R (4 native file shards, a drain
    worker a shard, a replication listener) with the conservation ledger on
    or off. With it on, a second card relay P (batching, no write-behind)
    then takes a traced write, whose `hint(origin=)` arms the replication
    round that pulls every row of R's into that trace, and every station of
    both relays is held to the script's own counts. → (launches, report)."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.obs import ledger
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore, ShardedRelayStore
    from evolu_tpu_torch.sync import protocol

    n, lanes = replay[3], replay[2]
    ledger.reset()
    ledger.set_enabled(ledger_on)
    acct, lock = {"attempts": 0, "shed": 0, "rejected": 0, "served": 0}, threading.Lock()
    r = RelayServer(ShardedRelayStore(os.path.join(tmp, f"o3r-{tag}.db"), backend="native", shards=4),
                    write_behind=True, peers=[], replication_interval_s=3600, device=device).start()
    # One pull response carries R's whole history: the peer's one round
    # ingests it in one coalesced batch of requests.
    r.replication.pull_messages_per_response = 1 << 18
    p = None
    try:
        t0 = time.perf_counter()
        rows, rejected, burst_s, launches, passes, waves = o3_relay_burst(kernels, r, replay, acct, lock, tag)
        serve_s = time.perf_counter() - t0
        r_stations = o3_stations({})
        r_ledger = o3_get_json(r.url + "/ledger")
        r_stats = o3_get_json(r.url + "/stats")
        out = {"run": tag, "ledger": "on" if ledger_on else "off", "requests": len(replay[0]), "messages": n,
               "client_threads": len(lanes),
               "burst_s": round(burst_s, 4), "msgs_per_s": round(n / burst_s), "serve_and_flush_s": round(serve_s, 4),
               "engine_passes": passes, "pull_waves": waves, "launches": launches,
               "scheduler_counts": dict(r.scheduler.counts), "script_counts": dict(acct), "distinct_rows": rows,
               "relay_stations": r_stations}
        if ledger_on:
            # P: a traced write arms its hint with the write's context; the
            # round it then runs against R pulls every row into that trace.
            p = RelayServer(RelayStore(os.path.join(tmp, "o3p.db"), backend="native"), batching=True, peers=[],
                            replication_interval_s=3600, device=device).start()
            t1 = time.perf_counter()
            before = ledger.totals()
            routes0, waves0 = dict(eng.counts), o3_pull_waves()
            reset(kernels)
            origin = [timestamp_to_string(Timestamp(BASE_MILLIS + 41_000_000_000 + j, 0, "0123456789abcdef"))
                      for j in range(2)]
            o3_post(p.url, protocol.encode_sync_request(protocol.SyncRequest(
                tuple(protocol.EncryptedCrdtMessage(t, b"o3-origin") for t in origin), "o3-origin-owner",
                "0123456789abcdef", "{}")), len(origin), acct, lock,
                headers={"traceparent": f"00-{O3_TRACE_ID}-00f067aa0ba902b7-01"})
            p.replication.add_peer(r.url)
            r_trees = dict(r.store.owner_trees())
            wait_until(lambda: all(p.store.get_merkle_tree_string(o) == t for o, t in r_trees.items()),
                       f"path O3a: the peer's convergence on R's {len(r_trees)} owners")
            # Stopping the loop joins its round in flight: every pulled row
            # is ingested and counted before the peer's counts are read.
            p.replication.stop()
            pulled = p.replication.peer_counts.get(r.url, {}).get("messages_pulled", 0)
            peer = {"wall_s": round(time.perf_counter() - t1, 4), "rows_pulled": pulled,
                    "launches": read(kernels), "engine_passes": engine_passes(routes0),
                    "pull_waves": o3_pull_waves() - waves0, "stations": o3_stations(before)}
            p_ledger = o3_get_json(p.url + "/ledger")
            p_stats = o3_get_json(p.url + "/stats")
            p_trace = {s["name"] for s in o3_get_json(p.url + f"/trace/{O3_TRACE_ID}")["spans"]}
            out["peer"] = peer
    finally:
        if p is not None:
            p.stop()
        r.stop()
        ledger.set_enabled(True)
    print(f"  path O3a ({tag}): {json.dumps(out)} | {gpu}", flush=True)
    runs = [(launches, passes, waves)] + ([(peer["launches"], peer["engine_passes"], peer["pull_waves"])]
                                         if ledger_on else [])
    for run_launches, run_passes, run_waves in runs:
        expect = {"seg_lex_max_scan": 0, "seg_xor_scan": run_passes, "timestamp_hash": run_passes, "seg_sum_scan": 0}
        if run_launches != expect or not run_passes or run_waves != run_passes:
            raise AssertionError(f"path O3a ({tag}): launches {run_launches} and {run_waves} pull waves for "
                                 f"{run_passes} engine dispatches, expected {expect} and a wave a dispatch")
    if "ledger" not in r_stats:
        raise AssertionError(f"path O3a ({tag}): /stats without its ledger section")
    if not ledger_on:
        if r_stations:
            raise AssertionError(f"path O3a ({tag}): the disabled ledger counted {r_stations}")
        return launches, out
    o3_check_ledger("O3a relay", r_stations, {
        ledger.INGRESS_SYNC: acct["attempts"] - len(origin), ledger.SHED_BACKPRESSURE: acct["shed"],
        ledger.STORE_INSERTED: rows, ledger.STORE_DUPLICATE: acct["served"] - len(origin) - rows,
        ledger.WB_QUEUED: r_stations.get(ledger.WB_DRAINED, -1), ledger.REJECT_INVALID: acct["rejected"],
        ledger.BOUNCE_NON_CANONICAL: rejected})
    o3_check_ledger("O3a peer", peer["stations"], {
        ledger.INGRESS_SYNC: len(origin), ledger.INGRESS_REPLICATION: pulled,
        ledger.STORE_INSERTED: rows + len(origin), ledger.STORE_DUPLICATE: pulled - rows})
    if r_ledger["violations"] or p_ledger["violations"]:
        raise AssertionError(f"path O3a: GET /ledger violations {r_ledger['violations']} {p_ledger['violations']}")
    if "ledger" not in p_stats or p_stats["replication"]["peers"][0]["convergence_lag_p99_ms"] is None:
        raise AssertionError(f"path O3a: the peer's /stats: {p_stats.get('replication')}")
    if "repl.round" not in p_trace:
        raise AssertionError(f"path O3a: /trace/{O3_TRACE_ID} on the peer holds {sorted(p_trace)}, no repl.round")
    return {k: launches[k] + peer["launches"][k] for k in launches}, out


def path_o3b(torch, kernels, replay, device=None, gpu=""):
    """O3b: a two-relay forward fleet of batching card relays; both K1
    bodies of 16 owners placed on the second are sent to the first, one of
    them traced. Responses equal K1's; the first relay's egress.forward
    equals the second's ingress.forward equals the messages sent; the
    forward leg joins the request's trace. → (launches, report)."""
    from evolu_tpu_torch.obs import ledger
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.utils.config import FleetConfig

    bodies, want, _lanes, _n, _owners, stamps = replay
    f1 = RelayServer(RelayStore(backend="native"), batching=True, device=device)
    f2 = RelayServer(RelayStore(backend="native"), batching=True, device=device)
    cfg = FleetConfig(relays=(f1.url, f2.url), replication_factor=1, version=1, forward=True)
    f1.enable_fleet(cfg)
    f2.enable_fleet(cfg)
    f1.start()
    f2.start()
    acct, lock = {"attempts": 0, "shed": 0, "rejected": 0, "served": 0}, threading.Lock()
    try:
        placed = []
        for i, (owner, _ts) in enumerate(stamps):
            if f1.fleet.ring.primary(owner) == f2.url and owner not in placed:
                placed.append(owner)
            if len(placed) == O3B_OWNERS:
                break
        ix = [i for i, (owner, _ts) in enumerate(stamps) if owner in placed]
        before = ledger.totals()
        routes0 = dict(eng.counts)
        reset(kernels)
        t0 = time.perf_counter()
        got = {}
        for k, i in enumerate(ix):
            hdrs = {"traceparent": f"00-{O3B_TRACE_ID}-a3ce929d0e0e4736-01"} if k == 0 else None
            got[i] = o3_post(f1.url, bodies[i], len(stamps[i][1]), acct, lock, headers=hdrs)
        wall = time.perf_counter() - t0
        launches = read(kernels)
        passes = engine_passes(routes0)
        stations = o3_stations(before)
        names = {s["name"] for s in o3_get_json(f2.url + f"/trace/{O3B_TRACE_ID}")["spans"]}
        violations = [o3_get_json(f.url + "/ledger")["violations"] for f in (f1, f2)]
    finally:
        f2.stop()
        f1.stop()
    bad = [i for i in ix if got[i] != want[i]]
    if bad:
        raise AssertionError(f"path O3b: {len(bad)} forwarded responses differ from K1's")
    out = {"requests": len(ix), "owners": len(placed), "messages": acct["served"], "wall_s": round(wall, 4),
           "engine_passes": passes, "script_counts": dict(acct), "stations": stations,
           "trace": sorted(n for n in names if not n.startswith("kernel:"))}
    print(f"  path O3b: {json.dumps(out)} | {gpu}", flush=True)
    o3_check_ledger("O3b", stations, {ledger.EGRESS_FORWARD: acct["served"], ledger.INGRESS_FORWARD: acct["served"],
                                      ledger.INGRESS_SYNC: acct["attempts"], ledger.SHED_BACKPRESSURE: acct["shed"]})
    if not {"relay.sync", "fleet.forward", "fleet.forward.serve"} <= names:
        raise AssertionError(f"path O3b: /trace/{O3B_TRACE_ID} on the target holds {sorted(names)}")
    if any(violations):
        raise AssertionError(f"path O3b: GET /ledger violations {violations}")
    expect = {"seg_lex_max_scan": 0, "seg_xor_scan": passes, "timestamp_hash": passes, "seg_sum_scan": 0}
    if launches != expect or not passes:
        raise AssertionError(f"path O3b: launches {launches} for {passes} engine dispatches, expected {expect}")
    return launches, out


def path_o3c(torch, kernels, device=None, gpu=""):
    """O3c: one Receive of 16,384 messages of config 2's todo shape (path
    D's generator), sealed with the native encrypt_batch, pushed into a
    native relay store (the engine's pass), served back and decoded to a
    PackedReceive, into a card
    DbWorker on CppSqliteDatabase with the ledger off, then into another
    with it on. The apply plane's equations hold, the batch routes packed,
    and both workers end equal. → (launches, report)."""
    from evolu_tpu_torch.obs import ledger
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore, serve_single_request
    from evolu_tpu_torch.storage.clock import read_clock
    from evolu_tpu_torch.storage.native import CppSqliteDatabase
    from evolu_tpu_torch.sync import native_crypto, protocol
    from evolu_tpu_torch.utils.config import Config

    base, batch = config2_batch(7, O3C_MESSAGES)
    sealed = native_crypto.encrypt_batch(batch, MNEMONIC)
    if sealed is None:
        raise AssertionError("path O3c: the native encrypt_batch declined a canonical batch")
    states, reports, launches, body = {}, {}, None, None
    for tag in ("off", "on"):
        clock = {"now": base}
        # The sort plan pinned: "auto" is the sort plan on the card and the
        # scatter plan on the CPU, and kernel L is the sort plan's.
        cfg = Config(backend="auto", winner_cache=True, merge_plan="sort")
        w = DWorker(f"o3c-{tag}", cfg, clock, device=device, db=CppSqliteDatabase())
        if body is None:  # one owner and node for both workers: one response
            store = RelayStore(backend="native")
            relay = BatchReconciler(store, device=device)
            relay.run_batch_wire([protocol.SyncRequest(sealed, w.worker.owner.id, "f" * 16, "{}")])
            relay.close()
            body = serve_single_request(store, protocol.SyncRequest(
                (), w.worker.owner.id, read_clock(w.worker.db).timestamp.node, "{}"), device=device)
            store.close()
        decoded = native_crypto.decrypt_response_columns(body, MNEMONIC)
        if decoded is None or len(decoded[0]) != len(batch):
            raise AssertionError("path O3c: the served response did not decode to columns")
        ledger.reset()
        ledger.set_enabled(tag == "on")
        try:
            reset(kernels)
            route = w.receive("o3c", *decoded)
            run = read(kernels)
            stations, audit = ledger.totals(), ledger.audit(at_barrier=False)
        finally:
            ledger.set_enabled(True)
        states[tag] = d_state(w)
        w.stop()
        if launches is not None and run != launches:
            raise AssertionError(f"path O3c: launches {run} with the ledger on, {launches} with it off")
        launches = run
        reports[tag] = {"wall_s": round(w.walls["o3c"], 4), "plans": route.get("plans"), "stations": stations,
                        "violations": audit}
    out = {"messages": len(batch), "runs": reports, "launches": launches}
    print(f"  path O3c: {json.dumps(out)} | {gpu}", flush=True)
    if states["on"] != states["off"]:
        raise AssertionError("path O3c: the worker with the ledger on ends unlike the worker with it off")
    st = reports["on"]["stations"]
    if reports["on"]["violations"] or st.get(ledger.APPLY_INGRESS) != len(batch) \
            or st.get(ledger.ROUTE_PACKED, 0) <= 0:
        raise AssertionError(f"path O3c: apply plane {st}, violations {reports['on']['violations']}")
    plans = sum((reports["on"]["plans"] or {}).values())
    expect = {"seg_lex_max_scan": 2 * plans, "timestamp_hash": plans, "seg_xor_scan": plans, "seg_sum_scan": 0}
    if not plans or launches != expect:
        raise AssertionError(f"path O3c: launches {launches} for {plans} device plans, expected {expect}")
    return launches, out


def path_o3(torch, kernels, replay, tmp, device=None, gpu=""):
    """Path O3: O3a with the conservation ledger off, on, then off again,
    each on a fresh relay R, so the on run's msgs/s is read beside the
    spread of the two off runs around it; then O3b and O3c. Each O3a run
    holds its own launches and pull waves to one X, one H and one wave an
    engine dispatch. → (launches, report)."""
    from evolu_tpu_torch.obs import metrics, trace

    # The metrics and tracing planes on (the peer's trace check reads
    # them), the span annotations left as they are (off).
    metrics.set_enabled(True)
    trace.set_enabled(True)
    trace.set_sample_rate(1.0)
    t0 = time.perf_counter()
    report, per, walls = {}, {}, {}

    def step(name, fn, *args):
        t1 = time.perf_counter()
        per[name], report[name] = fn(torch, kernels, *args)
        walls[name] = round(time.perf_counter() - t1, 3)

    for tag, ledger_on in (("off_1", False), ("on", True), ("off_2", False)):
        step(f"o3a_{tag}", path_o3a, replay, tmp, tag, ledger_on, device, gpu)
    step("o3b", path_o3b, replay, device, gpu)
    step("o3c", path_o3c, device, gpu)
    off = [report["o3a_off_1"]["msgs_per_s"], report["o3a_off_2"]["msgs_per_s"]]
    on = report["o3a_on"]["msgs_per_s"]
    report["wall_s"], report["walls_s"] = round(time.perf_counter() - t0, 3), walls
    report["msgs_per_s"] = {"ledger_off": off, "ledger_on": on, "on_minus_mean_off": round(on - sum(off) / 2),
                            "off_spread": abs(off[0] - off[1])}
    report["launches"] = per
    print(f"  path O3: wall {report['wall_s']}s ({json.dumps(walls)}); O3a msgs/s {json.dumps(report['msgs_per_s'])}; "
          f"launches {json.dumps(per)} | {gpu}", flush=True)
    launches = {k: sum(p[k] for p in per.values()) for k in per["o3c"]}
    return launches, report


def path_o(torch, kernels, keep, tmp, gpu=""):
    """Path O: O1 and O2, each with its own launch counts (summed as path
    O; `main` adds O3's, which runs after the kernel timing phase).
    → (launches, report)."""
    report, per = {}, {}
    per["o1"], report["o1"] = path_o1(torch, kernels, gpu)
    per["o2"], report["o2"] = path_o2(torch, kernels, keep, tmp, gpu)
    report["launches"] = per
    launches = {k: sum(p[k] for p in per.values()) for k in per["o1"]}
    return launches, report


# ---- path P: scoped sync (partial replication) --------------------------------------

# benchmarks/partial_sync.py's shape (10 equal HMAC lanes an owner, a one-lane
# slice, feed-authored rows tagged as the author's scoped push tags them) at
# the depth of a long-lived account.
P_OWNERS, P_PER_OWNER, P_LANES = 16, 1 << 16, 10
P_UNTAGGED_EVERY = 64  # 1/64 of an owner's rows pushed untagged: lane unknown, served to every scope
P_UPPER_OWNER = 15  # its node hex is upper case: its scoped fold takes the host route
P_FULL_OWNERS = (0, 1)  # also pulled by full (unscoped) pullers
P_BYTE_OWNERS = (2, 3)  # HTTP answer held against `scoped_response(device="cpu")`
# The owners with a scoped puller: 8 of the 16 (all 16 until the cut for
# path Q), the byte owners and the upper-case owner among them.
P_SCOPED_OWNERS = (0, 1, 2, 3, 4, 5, 6, P_UPPER_OWNER)
P3_OWNERS = 4
P_BASE = BASE_MILLIS + 30_000_000_000  # after every stamp of paths A-K
P_STEP_MS = 4_000  # an owner's rows 4 s apart: 65,536 rows over 73 hours
P_WATERMARK = P_BASE + (P_PER_OWNER // 2) * P_STEP_MS  # the middle of each history
P_PULL_NODE = "9999aaaabbbbcccc"
P_MAX_ROUNDS = 20
P4_ROWS, P4_HOST_ROWS = 1 << 20, 1 << 17
# P2: W's 10 Sends then 2 more, each 1,000 todo messages (200 creates of 4 and
# 100 updates of 2) and 1,000 todoCategory messages (300 creates of 3 and 50
# updates of 2); F's 1,000 untagged todoCategory messages (200 creates of 3 and
# 200 updates of 2) and 300 untagged note messages (100 creates of 3). The
# scripted clock moves a minute a Send (F_ROUND_MS). `note` is a lower-case
# table, so a query of it on R answers ScopeDeferred; `todoCategory` never
# does (mixed-case names, ROADMAP queue 3 item 9).
P2_SENDS, P2_MORE = 10, 2
P2_TODOS, P2_TODO_UPDATES, P2_CATS, P2_CAT_UPDATES = 200, 100, 300, 50
P2_F_CATS, P2_F_UPDATES, P2_F_NOTES = 200, 200, 100
P2_SCHEMA = {**F_TODO, "note": ("body",)}
P2_BASE = P_BASE + 40_000_000_000
P2_WATERMARK = P2_BASE + 5 * F_ROUND_MS  # the millis of W's 5th Send


def p_mnemonic(o):
    return f"path p owner {o} mnemonic"


def p_node(o):
    node = f"{0xfeed0000 + o:016x}"
    return node.upper() if o == P_UPPER_OWNER else node


def p_iso(millis):
    """JS `toISOString` of int64 millis (after 1970), vectorized."""
    return [s + "Z" for s in np.datetime_as_string(np.asarray(millis, dtype="datetime64[ms]"), unit="ms")]


def p_history(o, contents):
    """Owner `o`'s history: (timestamp strings, contents, lane tags). Row j
    sits in lane j % 10; every 64th row has no tag."""
    from evolu_tpu_torch.sync.scope import derive_scope_tag

    node = p_node(o)
    tags = [derive_scope_tag(p_mnemonic(o), f"table{t}") for t in range(P_LANES)]
    iso = p_iso(P_BASE + np.arange(P_PER_OWNER, dtype=np.int64) * P_STEP_MS)
    stamps = [f"{iso[j]}-{j % 7:04X}-{node}" for j in range(P_PER_OWNER)]
    lanes = ["" if j % P_UNTAGGED_EVERY == P_UNTAGGED_EVERY - 1 else tags[j % P_LANES] for j in range(P_PER_OWNER)]
    rows = [contents[(o * P_PER_OWNER + j) % len(contents)] for j in range(P_PER_OWNER)]
    return stamps, rows, lanes


def p_owed(stamps, rows, lanes, lane):
    """The rows a scoped puller that authored nothing is owed, stated
    plainly: past the watermark (raw-string order, node case as stored),
    and in the lane requested or in no known lane."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    wm = timestamp_to_string(Timestamp(P_WATERMARK, 0, "0" * 16))
    return [(t, c) for t, c, g in zip(stamps, rows, lanes) if t >= wm and g in ("", lane)]


def p_crc(pairs):
    import zlib

    crc = 0
    for t, c in sorted(pairs):
        crc = zlib.crc32(c, zlib.crc32(t.encode(), crc))
    return crc


def p_pull(url, owner, clause, keep_first=None):
    """A fresh puller converges from an empty tree over HTTP with the real
    codec: → (rounds, served (timestamp, content) pairs, request + response
    bytes). `keep_first` gets the first round's request and answer."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import _http_post

    caps = (protocol.CAP_SYNC_SCOPE,) if clause is not None else ()
    tree, served, n_bytes = {}, [], 0
    for rounds in range(1, P_MAX_ROUNDS + 1):
        req = protocol.SyncRequest((), owner, P_PULL_NODE, merkle_tree_to_string(tree), caps, clause)
        body = protocol.encode_sync_request(req)
        out = _http_post(url, body, retries=0)
        if keep_first is not None and rounds == 1:
            keep_first.append((req, out))
        n_bytes += len(body) + len(out)
        msgs = protocol.decode_sync_response(out).messages
        if not msgs:
            return rounds, served, n_bytes
        served += [(m.timestamp, bytes(m.content)) for m in msgs]
        tree = apply_prefix_xors(tree, minute_deltas_host(m.timestamp for m in msgs)[0])
    raise AssertionError(f"path P1: a puller of {owner} did not converge in {P_MAX_ROUNDS} rounds")


def check_p(step, launches, expect):
    if launches != expect:
        raise AssertionError(f"path P {step}: launches {launches}, expected {expect}")


def p_data():
    """P1's data: the owners, each owner's history (`p_history`), its lane-0
    tag and its owed set for a lane-0 puller."""
    from evolu_tpu_torch.sync.scope import derive_scope_tag

    rng = np.random.default_rng(131)
    contents = [bytes(b) for b in rng.integers(0, 256, (E_POOL, E_CONTENT_BYTES), dtype=np.uint8)]
    owners = [f"p-owner-{o:02d}" for o in range(P_OWNERS)]
    hist = [p_history(o, contents) for o in range(P_OWNERS)]
    lane0 = [derive_scope_tag(p_mnemonic(o), "table0") for o in range(P_OWNERS)]
    owed = {owners[o]: p_owed(*hist[o], lane0[o]) for o in range(P_OWNERS)}
    return owners, hist, lane0, owed


def p_seed(path):
    """P1's store, made in a process of the spawned pool while the card runs
    paths B to E (set-up, as path E's oracle is): the 16 histories through
    the one-shot packed ingest (the native insert) of a
    `BatchReconciler(..., device="cpu")` into a native file store at
    `path`, then their lanes by `record_push_lanes`. → the two walls."""
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.server.scope import record_push_lanes

    owners, hist, _lane0, _owed = p_data()
    store = RelayStore(path, backend="native")
    try:
        engine = BatchReconciler(store, device="cpu")
        try:
            t0 = time.perf_counter()
            engine.reconcile_wire([e_request(owners[o], hist[o][0], hist[o][1], "{}", node=p_node(o))
                                   for o in range(P_OWNERS)])
            ingest_s = time.perf_counter() - t0
        finally:
            engine.close()
        t0 = time.perf_counter()
        for o in range(P_OWNERS):
            record_push_lanes(store.db, owners[o], hist[o][0], hist[o][2], node_id=p_node(o))
        lanes_s = time.perf_counter() - t0
    finally:
        store.close()
    return {"seed_ingest_s_in_pool": round(ingest_s, 4), "seed_lanes_s_in_pool": round(lanes_s, 4)}


def path_p1(torch, kernels, seed, gpu=""):
    """P1, thin clients pulling a slice from deep histories: 16 owners x
    65,536 rows (E1's 116-byte contents) in a native file store with their
    lanes (10 an owner, 1/64 untagged, one owner with upper-case node hex),
    made by `p_seed` in the pool (`seed` is its (path, report)), behind a
    batching card `RelayServer` that advertises sync-scope-v1 (and serves
    /replicate/* for P3). 8 fresh scoped pullers of P_SCOPED_OWNERS (watermark = the middle
    of the history, one lane) and 2 fresh full pullers converge over HTTP;
    each puller's crc carry equals the crc of its owed set, and for 2
    owners the first answer's bytes equal `scoped_response(device="cpu")`
    on the same store. H = X = the device scoped folds. → (launches,
    report, relay, owed), the relay left running for P3."""
    import threading

    from evolu_tpu_torch.server import scope
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync import protocol

    t0 = time.perf_counter()
    owners, hist, lane0, owed = p_data()
    data_s = time.perf_counter() - t0
    path, seed_report = seed
    store = RelayStore(path, backend="native")
    scope.tree_cache.reset()
    reset(kernels)
    relay = RelayServer(store, batching=True, peers=[]).start()
    split = {k: [] for k in ("candidate_select", "excluded_set", "mask", "fold", "diff", "serve_select", "filter")}
    counts0 = dict(scope.counts)
    report = {"rows": P_OWNERS * P_PER_OWNER, "owners": P_OWNERS, "lanes": P_LANES,
              "watermark_millis": P_WATERMARK, "data_s": round(data_s, 4), **seed_report}
    firsts = {o: [] for o in P_BYTE_OWNERS}
    results, errors = {}, []

    def puller(key, o, clause):
        try:
            results[key] = p_pull(relay.url, owners[o], clause, firsts.get(o) if key[0] == "scoped" else None)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    with contextlib.ExitStack() as stack:
        for attr, key in (("_candidates", "candidate_select"), ("excluded_timestamps", "excluded_set"),
                          ("_slice_mask", "mask"), ("scoped_minute_deltas", "fold"),
                          ("diff_merkle_trees", "diff"), ("_rows_since", "serve_select"),
                          ("_filter_rows", "filter")):
            stack.enter_context(durations(scope, attr, split[key]))
        for kind, clause_of, which in (
                ("scoped", lambda o: protocol.ScopeClause(P_WATERMARK, (lane0[o],), ()), P_SCOPED_OWNERS),
                ("full", lambda o: None, P_FULL_OWNERS)):
            threads = [threading.Thread(target=puller, args=((kind, o), o, clause_of(o))) for o in which]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            report[kind] = {"wall_s": round(time.perf_counter() - t0, 4), "pullers": len(threads)}
            if errors:
                raise AssertionError(f"path P1: a {kind} puller failed") from errors[0]
    launches = read(kernels)
    counts = {k: scope.counts[k] - counts0[k] for k in counts0}
    for kind in ("scoped", "full"):
        res = [v for k, v in results.items() if k[0] == kind]
        rows = sum(len(r[1]) for r in res)
        n_bytes = sum(r[2] for r in res)
        report[kind].update({"rounds": sum(r[0] for r in res), "rows_served": rows, "bytes": n_bytes,
                             "bytes_per_served_row": round(n_bytes / max(rows, 1), 2),
                             "rows_per_s": round(rows / report[kind]["wall_s"])})
    report["scoped_split_s"] = {k: round(sum(v), 4) for k, v in split.items()}
    report["scope_counts"] = counts
    for (kind, o), (_rounds, served, _b) in results.items():
        want = owed[owners[o]] if kind == "scoped" else list(zip(hist[o][0], hist[o][1]))
        if len(served) != len(want) or p_crc(served) != p_crc(want):
            raise AssertionError(f"path P1: the {kind} puller of {owners[o]} was served {len(served)} rows "
                                 f"(crc {p_crc(served)}), owed {len(want)} (crc {p_crc(want)})")
    report["owed_rows_scoped"] = sum(len(owed[owners[o]]) for o in P_SCOPED_OWNERS)
    t0 = time.perf_counter()
    for o in P_BYTE_OWNERS:
        (req, got), = firsts[o]
        scope.tree_cache.reset()
        want = protocol.encode_sync_response(scope.scoped_response(store, req, device="cpu")) + \
            protocol.encode_response_capabilities((protocol.CAP_SYNC_SCOPE,))
        if got != want:
            raise AssertionError(f"path P1: the HTTP answer for {owners[o]} differs from scoped_response on the CPU")
    report["byte_check_s"] = round(time.perf_counter() - t0, 4)
    sched = dict(relay.scheduler.counts)
    report["scheduler_counts"] = sched
    if sched["poisoned_batches"] or sched["singles"] or sched["rejected"]:
        raise AssertionError(f"path P1: scheduler counts {sched}")
    canonical = len(P_SCOPED_OWNERS) - 1
    if counts["fold_device"] != canonical or counts["fold_host"] != 1 \
            or counts["tree_cache_misses"] != len(P_SCOPED_OWNERS):
        raise AssertionError(f"path P1: scope counts {counts}: expected {canonical} device folds, 1 host fold "
                             f"(the upper-case owner) and {len(P_SCOPED_OWNERS)} misses")
    folds = counts["fold_device"]
    check_p("P1", launches, {"seg_lex_max_scan": 0, "seg_xor_scan": folds, "timestamp_hash": folds,
                             "seg_sum_scan": 0})
    report["launches"] = launches
    print(f"  path P1: {json.dumps(report)} | {gpu}", flush=True)
    return launches, report, relay, {o: owed[owners[o]] for o in range(P3_OWNERS)}, owners, lane0


def path_p3(torch, kernels, relay, owed, owners, lane0, gpu=""):
    """P3, a scoped snapshot bootstrap: POST `/replicate/snapshot` to P1's
    relay with P1's watermark and one lane for 4 owners, fetch the chunks
    and install them into a fresh native store. The installed rows equal
    each owner's owed slice (crc), the installed trees the host fold of the
    slice; beside an unscoped capture of the same owners. No launch.
    → (launches, report)."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
    from evolu_tpu_torch.server import snapshot
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import _http_post

    def fetch(req, with_chunks=True):
        t0 = time.perf_counter()
        manifest = protocol.decode_snapshot_manifest(_http_post(relay.url + "/replicate/snapshot",
                                                                protocol.encode_snapshot_request(req), retries=0))
        capture_s = time.perf_counter() - t0
        if not with_chunks:
            return manifest, [], capture_s, 0.0
        chunks = [protocol.decode_snapshot_chunk(_http_post(
            relay.url + "/replicate/snapshot/chunk",
            protocol.encode_snapshot_chunk_request(protocol.SnapshotChunkRequest(manifest.snapshot_id, i, "p3")),
            retries=0)).payload for i in range(len(manifest.chunk_sizes))]
        return manifest, chunks, capture_s, time.perf_counter() - t0 - capture_s

    picked = tuple(owners[:P3_OWNERS])
    # One lane for all 4 owners: each owner's own lane-0 tag (the request names
    # opaque tags; other owners' rows of that tag are simply in no known lane).
    tags = tuple(lane0[:P3_OWNERS])
    reset(kernels)
    counts0 = dict(snapshot.counts)
    manifest, chunks, capture_s, chunks_s = fetch(protocol.SnapshotRequest("p3", 0, picked, P_WATERMARK, tags))
    dest = RelayStore(backend="native")
    try:
        t0 = time.perf_counter()
        snapshot.install_stream(dest, manifest, chunks)
        install_s = time.perf_counter() - t0
        for o, uid in enumerate(picked):
            rows = [(m.timestamp, bytes(m.content)) for m in dest.replica_messages(uid, "")]
            want = owed[o]
            if len(rows) != len(want) or p_crc(rows) != p_crc(want):
                raise AssertionError(f"path P3: {uid}'s installed rows differ from its owed slice")
            tree = merkle_tree_to_string(apply_prefix_xors({}, minute_deltas_host(t for t, _c in want)[0]))
            if dest.get_merkle_tree_string(uid) != tree:
                raise AssertionError(f"path P3: {uid}'s installed tree differs from the host fold of its slice")
    finally:
        dest.close()
    full_manifest, _none, full_capture_s, _ = fetch(protocol.SnapshotRequest("p3u", 0, picked), with_chunks=False)
    launches = read(kernels)
    report = {"owners": P3_OWNERS, "scoped_rows": manifest.message_count, "scoped_bytes": manifest.total_bytes,
              "chunks": len(chunks), "capture_s": round(capture_s, 4), "chunk_fetch_s": round(chunks_s, 4),
              "install_s": round(install_s, 4), "unscoped_rows": full_manifest.message_count,
              "unscoped_bytes": full_manifest.total_bytes, "unscoped_capture_s": round(full_capture_s, 4),
              "scoped_captures": snapshot.counts["scoped_captures"] - counts0["scoped_captures"],
              "launches": launches}
    print(f"  path P3: {json.dumps(report)} | {gpu}", flush=True)
    if report["scoped_captures"] != 1 or report["scoped_rows"] != sum(len(v) for v in owed.values()):
        raise AssertionError(f"path P3: {report}")
    check_p("P3", launches, dict.fromkeys(launches, 0))
    return launches, report


def p2_drive(fs):
    """P2's commands on one set (`FSet(..., http=True)`): W (scope: both
    tables, so its pushes carry lane tags), R (scope: `todo` from the
    millis of W's 5th Send) and F (unscoped) of one owner; W and R first
    pull once on the empty relay, so sync-scope-v1 is negotiated before
    any row moves. W's updates after the watermark touch only rows created
    before it, each once, and F's updates only categories W does not
    update after it: a row R holds is never re-delivered as a loser when
    the widening's full pulls re-serve it (ROADMAP queue 3 item 2).
    → {step: observations}."""
    from evolu_tpu_torch.runtime import messages as msg
    from evolu_tpu_torch.sync.scope import SyncScope

    w = fs.client("W", P2_SCHEMA, MNEMONIC, scope=SyncScope(tables=("todo", "todoCategory")))
    r = fs.client("R", P2_SCHEMA, MNEMONIC, scope=SyncScope(P2_WATERMARK, ("todo",)))
    f = fs.client("F", P2_SCHEMA, MNEMONIC)
    for e in (w, r):
        fs.pull(e)
    todos, cats, out = [], [], {}
    pre_todos = pre_cats = 0

    def send(s):
        nonlocal pre_todos, pre_cats
        fs.clock["now"] += F_ROUND_MS
        post = fs.clock["now"] >= P2_WATERMARK
        if not post:
            pre_todos, pre_cats = len(todos) + P2_TODOS, len(cats) + P2_CATS
        with w.batching():
            new_todos = [w.create("todo", {"title": f"t{s}-{i}", "isCompleted": 0}) for i in range(P2_TODOS)]
            new_cats = [w.create("todoCategory", {"name": f"c{s}-{i}"}) for i in range(P2_CATS)]
            for i in range(P2_TODO_UPDATES):
                k = (s - 4) * P2_TODO_UPDATES + i if post else (i * 7 + s) % (len(todos) + P2_TODOS)
                w.update("todo", (todos + new_todos)[k], {"title": f"u{s}-{i}"})
            for i in range(P2_CAT_UPDATES):
                k = (s - 4) * P2_CAT_UPDATES + i if post else (i * 7 + s) % (len(cats) + P2_CATS)
                w.update("todoCategory", (cats + new_cats)[k], {"name": f"v{s}-{i}"})
        todos.extend(new_todos)
        cats.extend(new_cats)
        fs.settle(w)

    def quiet(*clients):
        for _ in range(2):
            for e in clients:
                fs.clock["now"] += F_ROUND_MS
                fs.pull(e)

    t0 = time.perf_counter()
    for s in range(P2_SENDS):
        send(s)
    out["w_sends_s"] = time.perf_counter() - t0
    if (pre_todos, pre_cats) != (4 * P2_TODOS, 4 * P2_CATS):
        raise AssertionError(f"path P2: {pre_todos} todos and {pre_cats} categories before the watermark")
    fs.clock["now"] += F_ROUND_MS
    fs.pull(f)
    with f.batching():
        for i in range(P2_F_CATS):
            f.create("todoCategory", {"name": f"f{i}"})
        for i in range(P2_F_UPDATES):
            f.update("todoCategory", cats[(P2_SENDS - 4 + P2_MORE) * P2_CAT_UPDATES + i], {"name": f"g{i}"})
        for i in range(P2_F_NOTES):
            f.create("note", {"body": f"n{i}"})
    fs.settle(f)
    t0 = time.perf_counter()
    quiet(r, f)
    out["r_f_quiet_s"] = time.perf_counter() - t0
    wm = ts_one(P2_WATERMARK, 0, "0" * 16)
    log = w.db.exec_sql_query('SELECT "timestamp", "row", "column", "value" FROM "__message" '
                              'WHERE "table" = ? AND "timestamp" >= ? ORDER BY "timestamp"', ("todo", wm))
    slice_rows = {}
    for m in log:
        slice_rows.setdefault(m["row"], {})[m["column"]] = m["value"]
    held = {row["id"]: {k: v for k, v in row.items() if k != "id" and v is not None}
            for row in r.db.exec_sql_query('SELECT * FROM "todo"')}
    out["r_before_widen"] = {"frontier": r.worker._deferred_frontier(), "todo_equals_slice": held == slice_rows,
                             "todo_rows": len(held)}
    for table in ("todoCategory", "note"):
        n = len(fs.errors)
        rows = r.query_once(f'SELECT * FROM "{table}"')
        r.worker.flush()
        errors = fs.errors[n:]  # the answer under test, taken off the set's error channel
        del fs.errors[n:]
        out["r_before_widen"][f"{table}_query"] = {
            "rows": len(rows), "errors": [(type(e).__name__, getattr(e, "tables", None), getattr(e, "deferred_rows", None))
                                          for e in errors]}
    out["state_before_widen"] = f_state(fs)
    out["response_bytes_before_widen"] = {k: e._transport.counts.get("response_bytes", 0)
                                          for k, e in fs.clients.items()}
    for s in range(P2_SENDS, P2_SENDS + P2_MORE):
        send(s)
    r.worker.post(msg.WidenSyncScope(full=True))
    r.worker.flush()
    t0 = time.perf_counter()
    quiet(w, r, f)
    out["widen_quiet_s"] = time.perf_counter() - t0
    tables = ("__message", *P2_SCHEMA)
    out["r_equals_f"] = all(r.db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2') ==
                            f.db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2') for t in tables)
    out["r_scope_counts"] = dict(r.worker.scope_counts)
    out["r_scope_after"] = r.worker.config.sync_scope
    out["transports"] = {k: {c: e._transport.counts.get(c, 0) for c in ("requests", "response_bytes",
                                                                        "request_bytes", "response_messages")}
                         for k, e in fs.clients.items()}
    out["messages"] = ((P2_SENDS + P2_MORE) * (P2_TODOS * 4 + P2_TODO_UPDATES * 2 + P2_CATS * 3 + P2_CAT_UPDATES * 2)
                       + P2_F_CATS * 3 + P2_F_UPDATES * 2 + P2_F_NOTES * 3)
    out["state_after"] = f_state(fs)
    return out


def p2_oracle():
    """P2's oracle set, run in a process of the spawned pool while the card
    runs paths B to E: `p2_drive` on `FSet("oracle", False, http=True)`
    (a per-request relay on the CPU, `backend="cpu"` clients on
    `device="cpu"`, the pure crypto loops), its clock at P2's base."""
    fs = FSet("oracle", False, http=True)
    fs.clock["now"] = P2_BASE
    try:
        with fs.active():
            t0 = time.perf_counter()
            out = p2_drive(fs)
            out["wall"] = time.perf_counter() - t0
        fs.check("p2 oracle")
        return out
    finally:
        fs.close()


def path_p2(torch, kernels, tmp, oracle, gpu=""):
    """P2, scoped handles through the client API on the card set (a batching
    card relay on a native file store, `backend="auto"` clients with the
    winner cache on the card, the native crypto leg, encrypted sync over
    HTTP), held against the oracle set's `p2_drive` by digest before and
    after the widening. R's `todo` rows equal its slice, its frontier is
    exactly F's 1,000 untagged `todoCategory` rows and 300 `note` rows, a
    `note` query on R answers `ScopeDeferred` with those 300 rows (the
    `todoCategory` query answers its empty rows, as the oracle's does),
    and after the widening R equals F. → (launches, report)."""
    fs = FSet("card", True, http=True, path=os.path.join(tmp, "p2.db"))
    fs.clock["now"] = P2_BASE
    reset(kernels)
    try:
        with fs.active():
            t0 = time.perf_counter()
            got = p2_drive(fs)
            wall = time.perf_counter() - t0
        fs.check("p2")
        launches = read(kernels)
        plans = sum(sum(v for k, v in e.worker._planner.cache.counts.items() if k in ("cached_plans", "stream_plans"))
                    for e in fs.clients.values())
        # Before the widening W has not pulled F's rows and R holds a slice,
        # so only the sets are held equal; after it every client is synced.
        for part in ("clients", "relay"):
            if got["state_before_widen"][part] != oracle["state_before_widen"][part]:
                raise AssertionError(f"path P2: before the widening the {part} differ from the oracle set's")
        sizes = f_compare("P2 after the widening", got["state_after"], oracle["state_after"])
    finally:
        fs.close()
    before = got["r_before_widen"]
    report = {"messages": got["messages"], "wall_s": round(wall, 4), "msgs_per_s": round(got["messages"] / wall),
              "oracle_wall_s": round(oracle["wall"], 4), "oracle_msgs_per_s": round(got["messages"] / oracle["wall"]),
              "w_sends_s": round(got["w_sends_s"], 4), "r_f_quiet_s": round(got["r_f_quiet_s"], 4),
              "widen_quiet_s": round(got["widen_quiet_s"], 4), "r_before_widen": before,
              "r_scope_counts": got["r_scope_counts"], "transports": got["transports"],
              "response_bytes_before_widen": got["response_bytes_before_widen"],
              "worker_device_plans": plans, "rows": sizes, "launches": launches}
    print(f"  path P2: {json.dumps(report, default=str)} | {gpu}", flush=True)
    for key in ("r_before_widen", "r_equals_f", "r_scope_counts"):
        if got[key] != oracle[key]:
            raise AssertionError(f"path P2: {key} {got[key]} differs from the oracle set's {oracle[key]}")
    notes = P2_F_NOTES * 3
    if before["frontier"] != {"todoCategory": P2_F_CATS * 3 + P2_F_UPDATES * 2, "note": notes} \
            or not before["todo_equals_slice"] \
            or before["note_query"] != {"rows": 0, "errors": [("ScopeDeferred", ("note",), notes)]}:
        raise AssertionError(f"path P2: R before the widening {before}")
    if not got["r_equals_f"] or got["r_scope_after"] is not None or not got["r_scope_counts"]["widen_materialized"]:
        raise AssertionError("path P2: after the widening R does not equal F")
    if launches["timestamp_hash"] != launches["seg_xor_scan"] or launches["timestamp_hash"] < plans \
            or plans == 0 or launches["seg_lex_max_scan"] < 2 * plans or launches["seg_sum_scan"]:
        raise AssertionError(f"path P2: launches {launches} for {plans} device plans")
    return launches, report


def p4_kernel_ms(torch, fn):
    """Device ms of kernels H and X alone in one call of `fn`, from
    torch.profiler's kernel records (by kernel name; the sort and the
    elementwise kernels beside them excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        spans = {"H": 0.0, "X": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if "ts_hash_kernel" in e.name:
                    spans["H"] += e.time_range.elapsed_us()
                elif "lookback_scan" in e.name:
                    spans["X"] += e.time_range.elapsed_us()
        if spans["H"] and spans["X"]:
            return {k: round(v / 5 / 1e3, 5) for k, v in spans.items()}
        time.sleep(1.0)
    return {"H": None, "X": None}


def path_p4(torch, kernels, gpu=""):
    """P4, the fold itself: `scoped_minute_deltas` on 2^20 canonical
    timestamps with a 10% mask on the card, split into parse, upload, H and
    X (profiler kernel time), pull and dict, beside the two kernels' bound
    at that size; the host fold timed at 2^17 rows, its deltas equal to the
    card's on those rows. → (launches, report)."""
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.ops import merkle_ops as mo
    from evolu_tpu_torch.server import scope

    rng = np.random.default_rng(141)
    millis = P_BASE + np.sort(rng.integers(0, 10 * 86_400_000, P4_ROWS))
    nodes = rng.integers(0, 2**63, P4_ROWS)
    iso = p_iso(millis)
    stamps = [f"{iso[i]}-{i % 65536:04X}-{int(d):016x}" for i, d in enumerate(nodes.tolist())]
    mask = rng.random(P4_ROWS) < 0.1
    # The split of the one call, host clock: parse, upload, the kernels'
    # launch (host time: `minute_deltas_core` queues them), the pull (waits
    # for the device, then copies) and the dict. Its device inputs are kept
    # for the kernel timing below.
    split = {k: [] for k in ("parse", "upload", "launch", "pull", "dict")}
    inputs = []
    core = mo.minute_deltas_core

    def kept(*a):
        inputs.append(a)
        return core(*a)

    reset(kernels)
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(mo, "minute_deltas_core", kept))
        for obj, attr, key in ((scope, "parse_timestamp_strings", "parse"), (mo, "columns_to_device", "upload"),
                               (mo, "minute_deltas_core", "launch"), (mo, "to_host_many", "pull"),
                               (scope, "minute_deltas_to_dict", "dict")):
            stack.enter_context(durations(obj, attr, split[key]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = scope.scoped_minute_deltas(stamps, mask)
        wall = time.perf_counter() - t0
    # This call is the path's launch; the timing below launches the same
    # kernels again and is not counted.
    launches = read(kernels)
    check_p("P4", launches, {"seg_lex_max_scan": 0, "seg_xor_scan": 1, "timestamp_hash": 1, "seg_sum_scan": 0})
    run = functools.partial(core, *inputs[0])
    split = {f"{k}_s": round(sum(v), 5) for k, v in split.items()}
    split["device_leg_ms"] = round(cuda_ms(run, reps=5, inner=3), 5)
    kernel_ms = p4_kernel_ms(torch, run)
    # Bound: H (columns form) reads 8 + 4 + 8 B and writes 4 B a row and
    # hashes every row; X reads 1 + 4 B and writes 4 B a row.
    h_bytes, x_bytes = P4_ROWS * 24, P4_ROWS * 9
    h_bound = max(h_bytes / MEM_BYTES_PER_S, h_ops_per_row * P4_ROWS / INT32_OPS_PER_S) * 1e3
    x_bound = x_bytes / MEM_BYTES_PER_S * 1e3
    sub = slice(0, P4_HOST_ROWS)
    t0 = time.perf_counter()
    host_deltas, _ = minute_deltas_host(t for t, k in zip(stamps[sub], mask[sub]) if k)
    host_s = time.perf_counter() - t0
    if scope.scoped_minute_deltas(stamps[sub], mask[sub]) != host_deltas:
        raise AssertionError("path P4: the card fold and the host fold differ on 2^17 rows")
    report = {"rows": P4_ROWS, "masked": int(mask.sum()), "wall_s": round(wall, 5),
              "split_s": split, "kernel_device_ms": kernel_ms,
              "bound_ms": {"H": round(h_bound, 5), "X": round(x_bound, 5)},
              "bound_by": {"H": "operations" if h_ops_per_row * P4_ROWS / INT32_OPS_PER_S > h_bytes / MEM_BYTES_PER_S
                           else "bytes", "X": "bytes"},
              "host_fold": {"rows": P4_HOST_ROWS, "s": round(host_s, 5), "rows_per_s": round(P4_HOST_ROWS / host_s)},
              "launches": launches}
    print(f"  path P4: {json.dumps(report)} | {gpu}", flush=True)
    return launches, report


def path_p(torch, kernels, tmp, p2_oracle_out, seed, gpu=""):
    """Path P: P1 to P4, each with its own launch counts (summed as path
    P); `seed` is P1's store from the pool (`p_seed`). → (launches,
    report)."""
    report, per = {}, {}
    per["p1"], report["p1"], relay, owed, owners, lane0 = path_p1(torch, kernels, seed, gpu)
    try:
        per["p3"], report["p3"] = path_p3(torch, kernels, relay, owed, owners, lane0, gpu)
    finally:
        relay.stop()
    per["p2"], report["p2"] = path_p2(torch, kernels, tmp, p2_oracle_out, gpu)
    per["p4"], report["p4"] = path_p4(torch, kernels, gpu)
    report["launches"] = per
    return {k: sum(p[k] for p in per.values()) for k in per["p1"]}, report


# ---- path M: the scatter-argmax LWW plan ---------------------------------------------


M3_CHUNK = 1 << 17  # M3's receive_chunk_size, path D's: D1 arrives in 4 chunks
M4_MESSAGES = 20_000  # each router edge's batch


def route_counts():
    """A copy of `scatter_merge.counts` (the planners' and the shard
    router's routes)."""
    from evolu_tpu_torch.ops import scatter_merge

    return {kind: dict(c) for kind, c in scatter_merge.counts.items()}


def routes_since(before):
    """The routes taken since `before` (a `route_counts()`), zeros left out."""
    return {kind: {k: v - before[kind][k] for k, v in c.items() if v != before[kind][k]}
            for kind, c in route_counts().items()}


@contextlib.contextmanager
def plan_pinned(path):
    """The process-wide LWW plan pinned to `path`, "auto" again after."""
    from evolu_tpu_torch.ops import scatter_merge

    scatter_merge.set_plan_path(path)
    try:
        yield
    finally:
        scatter_merge.set_plan_path("auto")


def check_m(step, launches, want, routes, want_routes):
    if launches != want:
        raise AssertionError(f"path {step}: launches {launches}, expected {want}")
    if routes != want_routes:
        raise AssertionError(f"path {step}: routes {routes}, expected {want_routes}")


def path_m1(torch, kernels, a, gpu=""):
    """M1: path A's 1M messages over 1k owners through
    `reconcile_owner_batches` on the card with the plan pinned to
    "scatter": one scatter shard kernel (H and X once, L never), and every
    owner's xor mask, upserts and deltas and the digest equal to path A's
    sort results, which path A held against the host oracle."""
    from evolu_tpu_torch.parallel import reconcile_owner_batches

    before = route_counts()
    reset(kernels)
    with plan_pinned("scatter"):
        t0 = time.perf_counter()
        results, digest = reconcile_owner_batches(a["batches"], a["winners"])
        wall = time.perf_counter() - t0
    launches, routes = read(kernels), routes_since(before)
    check_m("M1", launches, {"seg_lex_max_scan": 0, "seg_xor_scan": 1, "timestamp_hash": 1, "seg_sum_scan": 0},
            routes, {"merge_plan": {}, "reconcile_kernel": {"scatter": 1}})
    if results.keys() != a["results"].keys() or digest != a["digest"]:
        raise AssertionError(f"path M1: owners or digest {digest:#x} differ from path A's ({a['digest']:#x})")
    bad = [o for o in results if results[o] != a["results"][o]]
    if bad:
        raise AssertionError(f"path M1: {len(bad)} owners differ from path A's sort plan, e.g. {bad[0]}")
    report = {"messages": a["messages"], "owners": len(results), "wall_s": round(wall, 4),
              "msgs_per_s": round(a["messages"] / wall), "path_a_wall_s": round(a["wall"], 4),
              "path_a_msgs_per_s": round(a["messages"] / a["wall"]), "path_a_routes": a["routes"],
              "routes": routes, "launches": launches}
    print(f"  path M1: every owner and digest {digest:#010x} equal path A's sort plan; {json.dumps(report)} | {gpu}",
          flush=True)
    return launches, report


def path_m3(torch, kernels, trees, batches, oracle, gpu=""):
    """M3: a card `DbWorker` with `backend="cuda"`, no winner cache and
    `merge_plan="scatter"` replays path D's D1 (in 4 chunks); its outputs,
    pushes, tables and tree equal path D's `backend="cpu"` oracle after D1.
    Every chunk is a scatter plan: H and X once each, L never. (D2's three
    Receives were cut when path N was added; path N4 replays them.)"""
    from evolu_tpu_torch.utils.config import Config

    clock = {"now": D1_BASE}
    before = route_counts()
    # The worker's planner sets the process-wide plan from its config;
    # "auto" again after, for the paths that follow.
    with plan_pinned("scatter"):
        w = DWorker("m3", Config(backend="cuda", winner_cache=False, merge_plan="scatter",
                                 receive_chunk_size=M3_CHUNK), clock)
        try:
            reset(kernels)
            clock["now"] = batches[0][0]
            w.receive("d1", batches[0][1], trees[0])
            launches, routes = read(kernels), routes_since(before)
            t0 = time.perf_counter()
            got = d_state(w)
        finally:
            w.stop()
    plans = -(-len(batches[0][1]) // M3_CHUNK)  # a plan a chunk
    check_m("M3", launches, {"seg_lex_max_scan": 0, "seg_xor_scan": plans, "timestamp_hash": plans,
                             "seg_sum_scan": 0}, routes, {"merge_plan": {"scatter": plans}, "reconcile_kernel": {}})
    if got["outputs"] != oracle["outputs"] or got["pushes"] != oracle["pushes"]:
        raise AssertionError("path M3: outputs or pushes differ from path D's backend='cpu' oracle after D1")
    if got["tables"] != oracle["tables"] or got["tree"] != oracle["tree"]:
        raise AssertionError("path M3: tables or the Merkle tree differ from path D's backend='cpu' oracle after D1")
    n = {"d1": len(batches[0][1])}
    report = {p: {"messages": n[p], "wall_s": round(w.walls[p], 4), "msgs_per_s": round(n[p] / w.walls[p])}
              for p in n}
    report.update({"routes": routes, "launches": launches, "compare_s": round(time.perf_counter() - t0, 4)})
    print(f"  path M3: outputs, pushes, every table and the tree equal path D's backend='cpu' oracle after D1; "
          f"{json.dumps(report)} | {gpu}", flush=True)
    return launches, report


def m2_bytes_bound_ms(n):
    """The scatter plan's least time at n rows: cell_id (4 B), k1, k2,
    ex_k1, ex_k2 (8 B each) read once, the two bool masks written once."""
    return n * (4 + 4 * 8 + 2) / MEM_BYTES_PER_S * 1e3


def kernel_breakdown(torch, fn, reps=10, top=8):
    """Device time a call of `fn` by CUDA kernel name (torch.profiler,
    mean over `reps` calls), the `top` largest, in µs: where a plan's time
    goes. {} when the profiler recorded nothing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:80]] += e.time_range.elapsed_us() / reps
    return {name: round(us, 2) for name, us in by_name.most_common(top)}


def path_m2(torch, args, columns_report, gpu=""):
    """M2: the two LWW plans on the 1M columns pass's config-3 device
    columns (2^20 rows): `scatter_plan_masks` against the sort plan's
    masks in sorted order (`plan_merge_sorted_flags`: the key, `torch.sort`,
    2 gathers, `masks_from_sorted_flags`), and `_shard_kernel_scatter`
    against `_shard_kernel`, after checking that each pair plans alike.
    CUDA events (median of 7 x 10 back-to-back calls) in turns (sort,
    scatter, scatter, sort) and torch.profiler device time, beside the
    scatter plan's byte bound; each plan's device time by kernel."""
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import scatter_merge as psm
    from evolu_tpu_torch.ops import to_host_many
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr

    cell_id, k1, k2, ex_k1, ex_k2, _owner_ix = args
    n = int(cell_id.shape[0])
    host_cell, host_k1, host_k2 = to_host_many(cell_id, k1, k2)
    with plan_pinned("scatter"):
        table = psm.scatter_table_for(host_cell, host_k1.view(np.uint64), host_k2.view(np.uint64))
    if table is None:
        raise AssertionError("path M2: the router refused the config-3 columns")
    plans = {"sort": functools.partial(pm.plan_merge_sorted_flags, cell_id, k1, k2, ex_k1, ex_k2),
             "scatter": functools.partial(psm.scatter_plan_masks, cell_id, k1, k2, ex_k1, ex_k2, table)}
    shards = {"sort": functools.partial(pr._shard_kernel, *args),
              "scatter": functools.partial(pr.scatter_shard_kernel(table), *args)}
    xor_s, upsert_s, i_s = to_host_many(*plans["sort"]()[:3])
    sorted_masks = pm.unpermute_masks(xor_s, upsert_s, i_s)
    scatter_masks = to_host_many(*plans["scatter"]())
    if not all(np.array_equal(a, b) for a, b in zip(sorted_masks, scatter_masks)):
        raise AssertionError("path M2: the scatter plan's masks differ from the sort plan's")
    decoded = {}
    for name, fn in shards.items():
        xor_s, upsert_s, i_s, *segs, digest = to_host_many(*fn())
        decoded[name] = (*pm.unpermute_masks(xor_s, upsert_s, i_s), decode_owner_minute_deltas(*segs),
                         int(digest.view(np.uint32)[0]))
    check_against_plain(decoded["scatter"], decoded["sort"], "path M2 shard kernels (scatter vs sort)")
    report = {"rows": n, "table_size": table, "bound_ms": round(m2_bytes_bound_ms(n), 5), "bound_by": "bytes"}
    for label, fns in (("plan", plans), ("shard_kernel", shards)):
        turns = {"sort": [], "scatter": []}
        for name in ("sort", "scatter", "scatter", "sort"):
            turns[name].append(cuda_ms(fns[name]))
        for name, fn in fns.items():
            report[f"{label}_{name}"] = {"ms_turns": [round(t, 5) for t in turns[name]],
                                         **device_ms(torch, [fn])}
    for name, fn in plans.items():
        report[f"plan_{name}"]["kernels_us"] = kernel_breakdown(torch, fn)
    stages = columns_report["stage_ms"]
    report["columns_pass_key_sort_plus_plan_compare_ms"] = round(stages["key_sort"] + stages["plan_compare"], 4)
    print(f"  path M2: {json.dumps(report)} | {gpu}", flush=True)
    return report


def m4_messages(seed, n, millis=BASE_MILLIS, big_node=False):
    """n todo messages with unique timestamps over 2,000 cells, and stored
    winners for about half the cells from the same window."""
    from evolu_tpu_torch.core.types import CrdtMessage

    rng = np.random.default_rng(seed)
    node = rng.integers(1 << 63 if big_node else 1, 2**64 if big_node else 2**63, n, dtype=np.uint64)
    stamps = ts_strings(millis + np.arange(n, dtype=np.int64) * 7 + rng.integers(0, 7, n),
                        rng.integers(0, 4, n), node)
    cells = rng.integers(0, 2000, n)
    cols = ("title", "isCompleted")
    msgs = [CrdtMessage(s, "todo", f"m4row{c >> 1}", cols[c & 1], f"v{i}")
            for i, (s, c) in enumerate(zip(stamps, cells.tolist()))]
    w_stamps = ts_strings(millis + rng.integers(0, 7 * n, 1000), rng.integers(0, 4, 1000),
                          rng.integers(1, 2**63, 1000, dtype=np.uint64))
    winners = {("todo", f"m4row{c >> 1}", cols[c & 1]): s for c, s in zip(range(0, 2000, 2), w_stamps)}
    return msgs, winners


def path_m4(torch, kernels, gpu=""):
    """M4: the router's edges on the card, each plan held against the host
    `plan_batch` (and the host Merkle fold) and the port on the CPU:
    a batch that repeats one (cell, timestamp) row routes to sort; a cell
    id ≥ 2^25 routes the full plan to sort and the shard router to wide;
    millis ≥ 2^47 (k1 ≥ 2^63) with nodes ≥ 2^63 routes to scatter; and
    `plan_batch_device` on both routes. The scatter path is pinned in
    each case, so only the router's own rules decide."""
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import resolve_device
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr
    from evolu_tpu_torch.parallel.mesh import single_mesh
    from evolu_tpu_torch.storage.apply import plan_batch

    def host(msgs, winners):
        xor, upserts = plan_batch(msgs, winners)
        return xor, sorted(map(repr, upserts)), minute_deltas_host(m.timestamp for f, m in zip(xor, msgs) if f)[0]

    def full(msgs, winners, device=None):
        xor, upserts, deltas = pm.plan_batch_device_full(msgs, winners, device=device)
        return list(xor), sorted(map(repr, upserts)), dict(deltas)

    def held(step, got, want, cpu):
        if got != want or got != cpu:
            raise AssertionError(f"path M4 {step}: the card's plan differs from the host oracle's or the CPU port's")

    report, t0 = {}, time.perf_counter()
    before = route_counts()
    reset(kernels)
    with plan_pinned("scatter"):
        msgs, winners = m4_messages(41, M4_MESSAGES)
        dup = msgs + [msgs[17]]
        mark = route_counts()
        got = full(dup, winners)
        report["repeated_row"] = routes_since(mark)
        held("repeated row", got, host(dup, winners), full(dup, winners, "cpu"))

        cell_ids, k1, k2, ex_k1, ex_k2, *_ = pm.messages_to_columns(msgs, winners)
        wide = cell_ids + np.int32(1 << 25)
        mark = route_counts()
        xor, upsert_mask, deltas = pm.plan_packed_device_full(wide, k1, k2, ex_k1, ex_k2, len(msgs))
        report["cell_2_25_full_plan"] = routes_since(mark)
        cpu = pm.plan_packed_device_full(wide, k1, k2, ex_k1, ex_k2, len(msgs), device="cpu")
        want = host(msgs, winners)
        held("cell id >= 2^25 (full plan)",
             (xor.tolist(), sorted(repr(m) for m, u in zip(msgs, upsert_mask) if u), deltas), want,
             (cpu[0].tolist(), sorted(repr(m) for m, u in zip(msgs, cpu[1]) if u), cpu[2]))
        cols, index, _ = pr.build_owner_columns({"m4": msgs}, {"m4": winners})
        real = cols["cell_id"] != int(pm._PAD_CELL)
        cols["cell_id"][real] += np.int32(1 << 25)
        mark = route_counts()

        def shard(device):
            mesh = single_mesh(resolve_device(device))
            xor_s, upsert_s, i_s, *segs, _digest = pr.reconcile_columns_sharded(mesh, cols)
            xor_m, upsert_m = pm.unpermute_masks(xor_s, upsert_s, i_s)
            pos = index["m4"][0]
            return (xor_m[pos].tolist(), sorted(repr(m) for m, u in zip(msgs, upsert_m[pos]) if u),
                    decode_owner_minute_deltas(*segs).get(0, {}))

        got = shard(None)
        report["cell_2_25_shard_router"] = routes_since(mark)
        held("cell id >= 2^25 (shard router)", got, want, shard("cpu"))

        big, big_winners = m4_messages(43, M4_MESSAGES, millis=(1 << 47) + 1_000, big_node=True)
        mark = route_counts()
        got = full(big, big_winners)
        report["k1_and_node_past_2_63"] = routes_since(mark)
        held("millis >= 2^47, nodes >= 2^63", got, host(big, big_winners), full(big, big_winners, "cpu"))

    for path in ("sort", "scatter"):
        with plan_pinned(path):
            mark = route_counts()
            xor, upserts = pm.plan_batch_device(msgs, winners)
            report[f"plan_batch_device_{path}"] = routes_since(mark)
            cx, cu = pm.plan_batch_device(msgs, winners, device="cpu")
            held(f"plan_batch_device ({path})", (xor, sorted(map(repr, upserts))),
                 host(msgs, winners)[:2], (cx, sorted(map(repr, cu))))
    launches, routes = read(kernels), routes_since(before)
    want_routes = {"repeated_row": {"merge_plan": {"sort": 1}, "reconcile_kernel": {}},
                   "cell_2_25_full_plan": {"merge_plan": {"sort": 1}, "reconcile_kernel": {}},
                   "cell_2_25_shard_router": {"merge_plan": {}, "reconcile_kernel": {"wide": 1}},
                   "k1_and_node_past_2_63": {"merge_plan": {"scatter": 1}, "reconcile_kernel": {}},
                   "plan_batch_device_sort": {"merge_plan": {"sort": 1}, "reconcile_kernel": {}},
                   "plan_batch_device_scatter": {"merge_plan": {"scatter": 1}, "reconcile_kernel": {}}}
    bad = {k: report[k] for k in want_routes if report[k] != want_routes[k]}
    if bad:
        raise AssertionError(f"path M4: routes {bad}, expected {want_routes}")
    # On the card: H and X once a full plan or shard pass (4), L twice a sort
    # plan (the repeated row, both cell ≥ 2^25 cases, plan_batch_device's sort).
    want = {"seg_lex_max_scan": 8, "seg_xor_scan": 4, "timestamp_hash": 4, "seg_sum_scan": 0}
    if launches != want:
        raise AssertionError(f"path M4: launches {launches}, expected {want}")
    report.update({"routes": routes, "launches": launches, "wall_s": round(time.perf_counter() - t0, 4)})
    print(f"  path M4: every edge routed as stated and equal to the host oracle and the CPU port; "
          f"{json.dumps(report)} | {gpu}", flush=True)
    return launches, report


# ---- path N: the owner mesh on one card ---------------------------------------------

N_SHARDS = 8  # shards sharing cuda:0: the analog of the reference's 8-device virtual CPU mesh
# Config 5's layout (benchmarks/config5_mesh.py:23-42) at 10M messages, cut to 2^22 for path N's
# wall (N1 took 18.4 s at 10M in PR 15's first chip call).
N1_MESSAGES = 1 << 22
N3_HOT = (16, 24_000, 1_000)  # owners, the hot owner's rows, each other owner's rows
N4_HOT_MIN = 1 << 17  # D1's chunk size: every D1 chunk takes the hot-owner route
N5_OWNERS, N5_PER = 500, 400  # config 5's pod pass (benchmarks/config5_mesh.py:99-101): 200,000 rows
N5_JOIN_S = 120.0  # the pod processes' own limit
N5_MEMBER_DEVICE = "cuda:0"  # the pod processes' shards' device
N6_REQUESTS = 256  # E2's first requests, POSTed to each N6 relay
N_LWW = ("seg_lex_max_scan", "timestamp_hash", "seg_xor_scan", "seg_sum_scan")


def card_mesh(n=N_SHARDS):
    """A MeshContext of `n` shards sharing cuda:0."""
    from evolu_tpu_torch.parallel.mesh import MeshContext, create_mesh

    return MeshContext(create_mesh(devices=["cuda:0"] * n))


def lww(n_l, n_h, n_x):
    """Launches of L, H and X (S never, on the LWW path)."""
    return dict(zip(N_LWW, (n_l, n_h, n_x, 0)))


def check_n(step, launches, want):
    if launches != want:
        raise AssertionError(f"path {step}: launches {launches}, expected {want}")


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def n1_layout(cols, n, n_dev):
    """bench.shard_layout's layout of the first n (real) rows of `cols`:
    owner o on shard o % n_dev, each shard padded with the planner's padding
    cell to the bucket of the largest load. → (columns, each original row's
    layout position, loads, shard size)."""
    from evolu_tpu_torch.ops import bucket_size

    shard_of = cols["owner_ix"][:n] % n_dev
    order = np.argsort(shard_of, kind="stable")
    loads = np.bincount(shard_of, minlength=n_dev)
    size = bucket_size(int(loads.max()))
    starts = np.zeros(n_dev, np.int64)
    starts[1:] = np.cumsum(loads)[:-1]
    positions = np.empty(n, np.int64)
    positions[order] = np.arange(n) - np.repeat(starts, loads) + np.repeat(np.arange(n_dev) * size, loads)
    out = {}
    for k, v in cols.items():
        dst = np.full(n_dev * size, 0x7FFFFFFF, v.dtype) if k == "cell_id" else np.zeros(n_dev * size, v.dtype)
        dst[positions] = v[:n]
        out[k] = dst
    return out, positions, loads.tolist(), size


def path_n1(torch, kernels, gpu=""):
    """N1, config 5's layout: N1_MESSAGES messages over 1k owners
    (`build_columns`) laid out over 8 shards of cuda:0 (owner % 8, as the
    reference's benchmark) through `reconcile_columns_sharded`, against one
    1-shard pass over the same rows: the masks in the rows' original
    positions and the digest equal; L 16, H 8, X 8. Each shard's rows and
    padding; the two passes' kernels on resident columns by torch.profiler
    and CUDA events (in turns); each pass's wall with upload and pull, two
    of each in turns (8, 1, 1, 8; the first of each is the checked one)."""
    from evolu_tpu_torch.ops import columns_to_device
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.parallel import reconcile as pr
    from evolu_tpu_torch.parallel.mesh import create_mesh

    n = N1_MESSAGES
    t0 = time.perf_counter()
    cols1 = build_columns(n)
    cols8, positions, loads, size = n1_layout(cols1, n, N_SHARDS)
    build_s = time.perf_counter() - t0
    mesh8, mesh1 = create_mesh(devices=["cuda:0"] * N_SHARDS), create_mesh(devices=["cuda:0"])
    reset(kernels)
    t0 = time.perf_counter()
    out8 = pr.reconcile_columns_sharded(mesh8, cols8)
    wall8 = time.perf_counter() - t0
    launches = read(kernels)
    check_n("N1", launches, lww(2 * N_SHARDS, N_SHARDS, N_SHARDS))
    t0 = time.perf_counter()
    out1 = pr.reconcile_columns_sharded(mesh1, cols1)
    wall1 = [time.perf_counter() - t0]
    wall8 = [wall8]
    for mesh, walls, cols in ((mesh1, wall1, cols1), (mesh8, wall8, cols8)):  # a second pair, in turns
        t0 = time.perf_counter()
        pr.reconcile_columns_sharded(mesh, cols)
        walls.append(time.perf_counter() - t0)
    x8, u8 = unpermute_masks(out8[0], out8[1], out8[2], block_size=size)
    x1, u1 = unpermute_masks(out1[0], out1[1], out1[2])
    if not (np.array_equal(x8[positions], x1[:n]) and np.array_equal(u8[positions], u1[:n])):
        raise AssertionError("path N1: the 8-shard masks differ from the 1-shard pass's")
    digest = out8[-1]
    if digest != out1[-1]:
        raise AssertionError(f"path N1: digest {digest:#x} != the 1-shard pass's {out1[-1]:#x}")
    del out8, out1, x8, u8, x1, u1, positions
    # The kernels alone, on columns already on the card.
    kernel8, kernel1 = pr.shard_kernel_for(cols8, "cuda"), pr.shard_kernel_for(cols1, "cuda")
    t8 = [columns_to_device({k: cols8[k][i * size:(i + 1) * size] for k in pr.COLUMN_NAMES}, "cuda")
          for i in range(N_SHARDS)]
    t1 = columns_to_device({k: cols1[k] for k in pr.COLUMN_NAMES}, "cuda")
    del cols1, cols8

    def run8():
        return [kernel8(*(t[k] for k in pr.COLUMN_NAMES)) for t in t8]

    def run1():
        return kernel1(*(t1[k] for k in pr.COLUMN_NAMES))

    report = {"messages": n, "shards": N_SHARDS, "shard_rows": loads, "shard_size": size,
              "padding_rows": [size - x for x in loads], "rows_padded_8": N_SHARDS * size,
              "rows_padded_1": int(t1["cell_id"].shape[0]), "kernel": kernel8.__name__,
              "build_s": round(build_s, 3), "wall_s_8": [round(w, 4) for w in wall8],
              "wall_s_1": [round(w, 4) for w in wall1], "msgs_per_s_8": round(n / min(wall8)),
              "msgs_per_s_1": round(n / min(wall1)),
              "device_ms_8": device_ms(torch, [run8], reps=3), "device_ms_1": device_ms(torch, [run1], reps=3),
              "events_ms": {"8": [], "1": []}, "launches": launches}
    for turn in ("8", "1", "1", "8"):
        report["events_ms"][turn].append(round(cuda_ms(run8 if turn == "8" else run1, 3, 2), 4))
    del t8, t1
    torch.cuda.empty_cache()
    print(f"  path N1: the masks in the rows' original positions and the digest {digest:#010x} equal the 1-shard "
          f"pass's; {json.dumps(report)} | {gpu}", flush=True)
    return launches, report


def path_n2(torch, kernels, a, gpu=""):
    """N2: path A's 1M messages over 1k owners through
    `reconcile_owner_batches(mesh_ctx=8 shards of cuda:0)`: every owner's
    (xor_mask, upserts, deltas) and the digest equal path A's card results,
    which path A held against the host oracle; L 16, H 8, X 8."""
    from evolu_tpu_torch.parallel import reconcile_owner_batches

    ctx = card_mesh()
    reset(kernels)
    t0 = time.perf_counter()
    results, digest = reconcile_owner_batches(a["batches"], a["winners"], mesh_ctx=ctx)
    wall = time.perf_counter() - t0
    launches = read(kernels)
    check_n("N2", launches, lww(2 * N_SHARDS, N_SHARDS, N_SHARDS))
    if results.keys() != a["results"].keys() or digest != a["digest"]:
        raise AssertionError(f"path N2: owners or digest {digest:#x} differ from path A's ({a['digest']:#x})")
    bad = [o for o in results if results[o] != a["results"][o]]
    if bad:
        raise AssertionError(f"path N2: {len(bad)} owners differ from path A's, e.g. {bad[0]}")
    report = {"messages": a["messages"], "owners": len(results), "wall_s": round(wall, 4),
              "msgs_per_s": round(a["messages"] / wall), "path_a_wall_s": round(a["wall"], 4),
              "path_a_msgs_per_s": round(a["messages"] / a["wall"]), "shard_rows": ctx.last_loads,
              "mesh_counts": ctx.counts, "launches": launches}
    print(f"  path N2: every owner and digest {digest:#010x} equal path A's; {json.dumps(report)} | {gpu}",
          flush=True)
    return launches, report


def n3_batches():
    """N3's extra batches: one owner holding over half the rows (the
    hot-owner row split), and E4's cap-overflow shape (every row its own
    minute, 64 owners)."""
    owners, hot, per = N3_HOT
    base = BASE_MILLIS + 60 * 10**9
    hot_batch, pos = [], 0
    for o in range(owners):
        k = hot if o == 0 else per
        stamps = [ts_one(base + (pos + i) // 16, (pos + i) % 16, f"{o + 1:016x}") for i in range(k)]
        pos += k
        hot_batch.append(e_request(f"nhot{o:02d}", stamps, [b"n3-%d" % i for i in range(k)], e_tree({}, stamps)))
    per_owner = {}
    for i in range(E4_ROWS):
        per_owner.setdefault(i % 64, []).append(ts_one(base + 10**9 + i * 60_000, i % 16, f"{i % 64:016x}"))
    overflow = [e_request(f"nmin{o:02d}", s, [b"n3"] * len(s), e_tree({}, s)) for o, s in per_owner.items()]
    return hot_batch, overflow


def n3_store_digest(store):
    """A store's digest as N3 holds it: every owner's stored Merkle tree
    and its count of message rows. `store` is a sharded store, or a dump
    (`e_dump`) of one. The trees hash every stored timestamp; the rows
    themselves are written by the insert paths G2 and K2 hold row for
    row."""
    if isinstance(store, tuple):
        messages, trees = store
        counts = {}
        for row in messages:
            counts[row[0]] = counts.get(row[0], 0) + 1
        return sorted(map(tuple, trees)), counts
    trees, counts = [], {}
    for s in store.shards:
        trees += s.db.exec('SELECT "userId", "merkleTree" FROM "merkleTree"')
        counts.update(s.db.exec('SELECT "userId", count(*) FROM "message" GROUP BY 1'))
    return sorted(map(tuple, trees)), counts


def path_n3(torch, kernels, keep, tmp, report_g2, gpu=""):
    """N3, the engine on the mesh: E1 then E2 through
    `BatchReconciler(ShardedRelayStore(<file>, 4 native shards),
    mesh_ctx=8 shards of cuda:0).run_batch_wire` (the streaming ingest):
    every response's bytes equal path E's, and the store's digest (every
    owner's tree and row count) path E's store's; H = X = 8 a pass. Then, on fresh stores against a 1-shard engine, a
    batch with one owner holding over half the rows (the hot-owner row
    split: `owner_delta_partials` rises) and E4's cap-overflow shape (the
    full-width rerun on every shard): equal bytes and tables."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import ShardedRelayStore

    (e1, e1_out), (e2, e2_out) = keep["e1"], keep["e2"]
    ctx = card_mesh()
    store = ShardedRelayStore(os.path.join(tmp, "n3.db"), backend="native", shards=4)
    rec = eng.BatchReconciler(store, mesh_ctx=ctx)
    report, total = {}, {}
    try:
        for name, requests, want in (("e1", e1, e1_out), ("e2", e2, e2_out)):
            routes0 = dict(eng.counts)
            reset(kernels)
            t0 = time.perf_counter()
            got = rec.run_batch_wire(requests)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, passes = read(kernels), engine_passes(routes0)
            check_n(f"N3 {name}", launches, lww(0, N_SHARDS * passes, N_SHARDS * passes))
            add_launches(total, launches)
            if got != want:
                bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
                raise AssertionError(f"path N3 {name}: response {bad} differs from path E's")
            n = sum(len(r.messages) for r in requests)
            report[name] = {"messages": n, "wall_s": round(wall, 4), "msgs_per_s": round(n / wall),
                            "passes": passes, "shard_rows": ctx.last_loads,
                            "path_g2_msgs_per_s": report_g2.get(name, {}).get("msgs_per_s")}
        t0 = time.perf_counter()
        if n3_store_digest(store) != n3_store_digest(keep["store_dump"]):
            raise AssertionError("path N3: the 4-shard store's trees or message counts after E2 differ from path "
                                 "E's store")
        report["compare_s"] = round(time.perf_counter() - t0, 3)
    finally:
        rec.close()
        store.close()
    hot, overflow = n3_batches()
    for name, batch in (("hot_owner", hot), ("cap_overflow", overflow)):
        stores = [ShardedRelayStore(backend="native", shards=4) for _ in range(2)]
        sharded, single = eng.BatchReconciler(stores[0], mesh_ctx=ctx), eng.BatchReconciler(stores[1])
        try:
            partials = ctx.counts["xdev_reduce"]["owner_delta_partials"]
            routes0 = dict(eng.counts)
            reset(kernels)
            t0 = time.perf_counter()
            got = sharded.run_batch_wire(batch)
            wall = time.perf_counter() - t0
            launches, passes = read(kernels), engine_passes(routes0)
            overflowed = eng.counts["overflow"] - routes0["overflow"]
            split = ctx.counts["xdev_reduce"]["owner_delta_partials"] - partials
            check_n(f"N3 {name}", launches, lww(0, N_SHARDS * passes, N_SHARDS * passes))
            add_launches(total, launches)
            if got != single.run_batch_wire(batch) or k_dump(stores[0]) != k_dump(stores[1]):
                raise AssertionError(f"path N3 {name}: bytes or tables differ from a 1-shard engine's")
            if (name == "hot_owner" and split < 1) or (name == "cap_overflow" and overflowed != 1):
                raise AssertionError(f"path N3 {name}: {split} split owners, {overflowed} overflow reruns")
            report[name] = {"messages": sum(len(r.messages) for r in batch), "wall_s": round(wall, 4),
                            "owner_delta_partials": split, "overflow_reruns": overflowed,
                            "shard_rows": ctx.last_loads}
        finally:
            for x in (sharded, single, *stores):
                x.close()
    report["mesh_counts"] = ctx.counts
    report["launches"] = total
    print(f"  path N3: E1 and E2 bytes, trees and row counts equal path E's, the hot owner's and the overflow's a 1-shard "
          f"engine's; {json.dumps(report)} | {gpu}", flush=True)
    return total, report


def path_n4(torch, kernels, trees, batches, oracle, report_d, gpu=""):
    """N4, the client worker on the mesh: path D's D1 (2^19 in 4 chunks)
    and D2's first batch (100k; D2's other two were cut to make room for
    path O) into `DbWorker(device=None, mesh_ctx=8 shards of cuda:0)` with
    `Config(mesh_engine=True, hot_owner_min_batch=2^17)`: D1's chunks take
    `reconcile_hot_owner`, the D2 batch `MeshShardedWinnerCache` with its
    gate off (a sharded cached plan); the state equals path D's oracle
    after D2's first Receive. `trees` and `batches` are D1's and that
    batch's."""
    from evolu_tpu_torch.parallel import hot_owner
    from evolu_tpu_torch.utils.config import Config

    ctx = card_mesh()
    clock = {"now": D1_BASE}
    hot_calls = []
    orig = hot_owner.reconcile_hot_owner
    w = DWorker("n4", Config(backend="auto", mesh_engine=True, hot_owner_min_batch=N4_HOT_MIN,
                             receive_chunk_size=N4_HOT_MIN), clock, mesh_ctx=ctx)
    try:
        cache = w.cache
        if type(cache).__name__ != "MeshShardedWinnerCache":
            raise AssertionError(f"path N4: the planner's cache is {type(cache).__name__}")
        # The gate off pins the cached route: D2's first batches are all
        # first contact (D1's hot chunks bypassed the cache), which the
        # adaptive gate streams on one device.
        cache.adaptive = False
        routes = []
        reset(kernels)
        with patched(hot_owner, "reconcile_hot_owner", lambda *a: hot_calls.append(len(a[1])) or orig(*a)):
            for i, ((base, batch), tree) in enumerate(zip(batches, trees)):
                clock["now"] = base
                routes.append(w.receive("d1" if i == 0 else "d2", batch, tree))
        launches = read(kernels)
        got = d_state(w)
        slots = cache.shard_slot_counts()
    finally:
        w.stop()
    d1_chunks = -(-len(batches[0][1]) // N4_HOT_MIN)
    cached, streamed = cache.counts.get("cached_plans", 0), cache.counts.get("stream_plans", 0)
    if hot_calls != [N4_HOT_MIN] * d1_chunks or cached != len(batches) - 1:
        raise AssertionError(f"path N4: hot-owner chunks {hot_calls}, {cached} sharded cached plans")
    sharded = d1_chunks + cached  # each on 8 shards; a streamed plan runs on one
    check_n("N4", launches, lww(2 * (N_SHARDS * sharded + streamed), N_SHARDS * sharded + streamed,
                                N_SHARDS * sharded + streamed))
    if got != oracle:
        raise AssertionError("path N4: outputs, pushes, tables or the tree differ from path D's oracle after "
                             "D2's first Receive")
    n = {"d1": len(batches[0][1]), "d2": sum(len(b) for _, b in batches[1:])}
    report = {p: {"messages": n[p], "wall_s": round(w.walls[p], 4), "msgs_per_s": round(n[p] / w.walls[p]),
                  "path_d_msgs_per_s": report_d[p]["msgs_per_s"]} for p in n}
    report.update({"hot_owner_chunks": hot_calls, "cache": type(cache).__name__, "cache_counts": dict(cache.counts),
                   "shard_slot_counts": slots, "routes": routes, "mesh_counts": ctx.counts, "launches": launches})
    print(f"  path N4: the state equals path D's oracle after D2's first Receive; "
          f"{json.dumps(report, default=str)} | {gpu}",
          flush=True)
    return launches, report


def n5_requests():
    """Config 5's pod batch (`benchmarks/pod_requests.build_pod_requests(
    owners=500, per=400, factor=977, stride_ms=1000, payload=b"c" * 64)`)
    with the port's protocol. → (requests, the host fold's digest)."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
    from evolu_tpu_torch.sync import protocol

    requests, expect = [], 0
    for o in range(N5_OWNERS):
        ts = [ts_one(BASE_MILLIS + (o * 977 + i) * 1000, i % 4, f"{o + 1:016x}") for i in range(N5_PER)]
        deltas, d = minute_deltas_host(iter(ts))
        expect ^= d
        requests.append(protocol.SyncRequest(
            tuple(protocol.EncryptedCrdtMessage(t, b"c" * 64 + b"-%d" % o) for t in ts), f"owner{o}", "f" * 16,
            merkle_tree_to_string(apply_prefix_xors({}, deltas))))
    return requests, expect & 0xFFFFFFFF


def n5_write_requests(path):
    """`n5_requests` pickled to `path` (made in a process of the spawned
    pool while the card runs paths B to N4; the pod processes and the
    parent load it)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(n5_requests(), f, protocol=pickle.HIGHEST_PROTOCOL)


def n5_load_requests(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def n5_member(rank, init, path, out_path, device, requests_path):
    """One process of N5's pod (spawned): joins the gloo group through the
    `file://` store `init` with 4 shards of `device`, loads the pod's
    requests (`n5_write_requests`), runs `reconcile_pod` (wire) on a
    native 4-shard file store of its own with every kernel's count set to
    0 just before, and pickles its answers, digest, owners, walls and
    kernel launches to `out_path`."""
    import pickle

    import torch.distributed as dist

    from evolu_tpu_torch.ops import cuda_hash, cuda_scan
    from evolu_tpu_torch.parallel.multihost import initialize_multihost
    from evolu_tpu_torch.server.engine import reconcile_pod
    from evolu_tpu_torch.server.relay import ShardedRelayStore

    fns = (cuda_scan.segmented_max_scan_cuda, cuda_hash.timestamp_hash_cuda, cuda_scan.segmented_xor_scan_cuda,
           cuda_scan.segmented_sum_scan_cuda)
    t0 = time.perf_counter()
    mesh = initialize_multihost(f"file://{init}", 2, rank, devices=[device] * 4, timeout_s=N5_JOIN_S)
    requests, expect = n5_load_requests(requests_path)
    store = ShardedRelayStore(path, backend="native", shards=4)
    start_s = time.perf_counter() - t0
    try:
        for f in fns:
            f.launches = 0
        t0 = time.perf_counter()
        responses, digest = reconcile_pod(mesh, store, requests, wire=True)
        wall = time.perf_counter() - t0
        launches = dict(zip(N_LWW, (f.launches for f in fns)))
        owners = store.user_ids()
    finally:
        store.close()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump({"answers": {i: r for i, r in enumerate(responses) if r is not None}, "digest": digest,
                     "expect": expect, "owners": owners, "wall_s": wall, "start_s": start_s,
                     "launches": launches, "mesh": [(str(s.device), s.rank) for s in mesh.shards]}, f)


def n5_spawn(tmp, requests_path):
    """Start N5's two pod processes (spawned: the parent holds a CUDA
    context). → (processes, their result paths, the requests' path)."""
    ctx = multiprocessing.get_context("spawn")
    outs = [os.path.join(tmp, f"n5_{r}.pkl") for r in range(2)]
    procs = [ctx.Process(target=n5_member, args=(r, os.path.join(tmp, "n5.gloo"), os.path.join(tmp, f"n5_{r}.db"),
                                                 outs[r], N5_MEMBER_DEVICE, requests_path), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    return procs, outs, requests_path


def path_n5(torch, kernels, spawned, tmp, gpu=""):
    """N5, config 5's pod across two processes on one card, each in a gloo
    group through a `file://` store with 4 shards of cuda:0, running
    `reconcile_pod` on a native 4-shard store of its own (`n5_member`,
    started before path M4). Both digests equal, and equal a 1-process port
    `reconcile_pod` on 8 shards and the host fold; every request answered
    once, the union byte-equal to the 1-process answers; each store holds
    only its process's owners. The 1-process pass runs after the pod
    processes ended, so neither shares the card with the other. The
    launches are the pod processes' (H = X = 4 each)."""
    import pickle

    from evolu_tpu_torch.parallel.mesh import create_mesh
    from evolu_tpu_torch.server.engine import owner_process, reconcile_pod
    from evolu_tpu_torch.server.relay import ShardedRelayStore

    procs, outs, requests_path = spawned
    t0 = time.perf_counter()
    deadline = time.perf_counter() + N5_JOIN_S
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 1.0))
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if codes != [0, 0]:
        raise AssertionError(f"path N5: the pod processes ended {codes}")
    wait_s = time.perf_counter() - t0
    requests, expect = n5_load_requests(requests_path)
    store = ShardedRelayStore(os.path.join(tmp, "n5_one.db"), backend="native", shards=4)
    try:
        t1 = time.perf_counter()
        want, digest = reconcile_pod(create_mesh(devices=["cuda:0"] * N_SHARDS), store, requests, wire=True)
        one_wall = time.perf_counter() - t1
    finally:
        store.close()
    members = []
    for path in outs:
        with open(path, "rb") as f:
            members.append(pickle.load(f))
    union = {}
    for m in members:
        for i, body in m["answers"].items():
            if i in union:
                raise AssertionError(f"path N5: request {i} answered twice")
            union[i] = body
    if sorted(union) != list(range(len(requests))) or [union[i] for i in range(len(requests))] != want:
        raise AssertionError("path N5: the two processes' answers differ from the 1-process pod pass's")
    if not (members[0]["digest"] == members[1]["digest"] == digest == expect):
        raise AssertionError(f"path N5: digests {[m['digest'] for m in members]}, 1-process {digest:#x}, "
                             f"host {expect:#x}")
    for r, m in enumerate(members):
        mine = sorted(q.user_id for q in requests if owner_process(q.user_id, 2) == r)
        if sorted(m["owners"]) != mine:
            raise AssertionError(f"path N5: process {r}'s store holds {len(m['owners'])} owners, not its {len(mine)}")
        check_n(f"N5 process {r}", m["launches"], lww(0, 4, 4))
    launches = {k: sum(m["launches"][k] for m in members) for k in N_LWW}
    report = {"owners": N5_OWNERS, "rows": N5_OWNERS * N5_PER, "digest": f"{digest:#010x}",
              "process_walls_s": [round(m["wall_s"], 4) for m in members],
              "process_start_s": [round(m["start_s"], 3) for m in members],
              "process_owners": [len(m["owners"]) for m in members], "one_process_wall_s": round(one_wall, 4),
              "wait_s": round(wait_s, 3), "mesh": members[0]["mesh"], "launches": launches}
    print(f"  path N5: both processes' digests equal the 1-process pass's and the host fold's; the union of their "
          f"answers equals the 1-process answers; {json.dumps(report)} | {gpu}", flush=True)
    return launches, report


def n6_post(url, bodies, threads=8):
    """POST every body from `threads` threads; → the answers in order."""
    import threading

    from evolu_tpu_torch.sync.client import _http_post

    out, errors, it, lock = [None] * len(bodies), [], iter(range(len(bodies))), threading.Lock()

    def lane():
        try:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                out[i] = _http_post(url, bodies[i])
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    ts = [threading.Thread(target=lane) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise AssertionError("path N6: a POST failed") from errors[0]
    return out


def path_n6(torch, kernels, keep, gpu=""):
    """N6, the live relay: E2's first N6_REQUESTS requests POSTed to a
    batching card relay without a mesh, then to `RelayServer(store,
    mesh_ctx=8 shards of cuda:0, mesh_engine=True)` and to a relay that
    `EVOLU_MESH_ENGINE=on` turns on (its context the process-wide one, made
    first over 8 shards of cuda:0), each on a fresh native store: equal
    bytes; `/stats` carries the `mesh` section with devices 8 and
    `dispatches_total` equal to the engine passes."""
    import urllib.request

    from evolu_tpu_torch.parallel.mesh import get_mesh_context
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync import protocol

    requests = keep["e2"][0][:N6_REQUESTS]
    bodies = [protocol.encode_sync_request(r) for r in requests]
    n = sum(len(r.messages) for r in requests)
    ref = RelayServer(RelayStore(backend="native"), batching=True).start()
    try:
        t0 = time.perf_counter()
        want = n6_post(ref.url, bodies)
        report = {"no_mesh": {"requests": len(bodies), "messages": n, "wall_s": round(time.perf_counter() - t0, 4)}}
    finally:
        stop_relay(ref)
    process_ctx = get_mesh_context(devices=["cuda:0"] * N_SHARDS)
    total = {}
    for mode in ("mesh_engine", "EVOLU_MESH_ENGINE"):
        ctx = card_mesh() if mode == "mesh_engine" else process_ctx
        old = os.environ.get("EVOLU_MESH_ENGINE")
        if mode == "EVOLU_MESH_ENGINE":
            os.environ["EVOLU_MESH_ENGINE"] = "on"
        try:
            kw = {"mesh_ctx": ctx, "mesh_engine": True} if mode == "mesh_engine" else {}
            relay = RelayServer(RelayStore(backend="native"), **kw).start()
        finally:
            if old is None:
                os.environ.pop("EVOLU_MESH_ENGINE", None)
            else:
                os.environ["EVOLU_MESH_ENGINE"] = old
        try:
            dispatches0 = ctx.counts["dispatches"]
            reset(kernels)
            t0 = time.perf_counter()
            got = n6_post(relay.url, bodies)
            wall = time.perf_counter() - t0
            launches = read(kernels)
            with urllib.request.urlopen(relay.url + "/stats", timeout=60) as r:
                mesh = json.loads(r.read())["mesh"]
            passes, resolved = relay.scheduler.counts["batches"], relay.scheduler.mesh_ctx
        finally:
            stop_relay(relay)
        add_launches(total, launches)
        if got != want:
            bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"path N6 {mode}: answer {bad} differs from the relay without a mesh")
        if resolved is not ctx or mesh["devices"] != N_SHARDS or mesh["dispatches_total"] - dispatches0 != passes:
            raise AssertionError(f"path N6 {mode}: /stats mesh {mesh} for {passes} engine passes")
        check_n(f"N6 {mode}", launches, lww(0, N_SHARDS * passes, N_SHARDS * passes))
        report[mode] = {"requests": len(bodies), "messages": n, "wall_s": round(wall, 4),
                        "msgs_per_s": round(n / wall), "passes": passes, "stats_mesh": mesh}
    report["launches"] = total
    print(f"  path N6: both mesh relays answer the bytes of the relay without a mesh; {json.dumps(report)} | {gpu}",
          flush=True)
    return total, report


def engine_kernel_timing(torch, captured):
    """The three engine kernels on E1's columns: device ms (CUDA events
    around 10 back-to-back calls; and the profiler's kernel time), bytes
    up and down, the upload and the pull (host clock, median of 7). And H
    and X on the inputs E1 handed them, against their plain versions."""
    from evolu_tpu_torch.ops import columns_to_device, to_host_many
    from evolu_tpu_torch.server import engine as eng

    k1, node, oix, _dev, cap = captured["path_e_state"][4]
    real = oix >= 0
    millis = (k1 >> np.uint64(16)).astype(np.int64)
    base = int(millis[real].min())
    forms = {
        "compact_delta_16B": ({"dmillis": np.where(real, millis - base, 0).astype(np.uint32).view(np.int32),
                               "ownctr": np.where(real, (oix.astype(np.uint32) << np.uint32(16))
                                                  | (k1 & np.uint64(0xFFFF)).astype(np.uint32),
                                                  np.uint32(0xFFFF << 16)).view(np.int32),
                               "node": node},
                              lambda t: eng._merkle_shard_kernel_compact_delta(
                                  t["dmillis"], t["ownctr"], t["node"], base, cap)),
        "compact_20B": ({"k1": k1, "node": node, "owner_ix": oix},
                        lambda t: eng._merkle_shard_kernel_compact(t["k1"], t["node"], t["owner_ix"], cap)),
        "full_width_29B": ({"millis": millis, "counter": (k1 & np.uint64(0xFFFF)).astype(np.int32), "node": node,
                            "valid": real, "owner_ix": np.maximum(oix, 0).astype(np.int64)},
                           lambda t: eng._merkle_shard_kernel(t["millis"], t["counter"], t["node"],
                                                              t["valid"], t["owner_ix"])),
    }
    out = {}
    for name, (cols, fn) in forms.items():
        ups, pulls = [], []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t = columns_to_device(cols, "cuda")
            torch.cuda.synchronize()
            ups.append(time.perf_counter() - t0)
        for _ in range(7):
            res = fn(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = to_host_many(*res)
            pulls.append(time.perf_counter() - t0)
        out[name] = {"rows": int(k1.shape[0]), "cap": cap,
                     "bytes_up": int(sum(a.nbytes for a in cols.values())),
                     "bytes_down": int(sum(a.nbytes for a in host)),
                     "upload_ms": round(statistics.median(ups) * 1e3, 5),
                     "ms": round(cuda_ms(lambda: fn(t)), 5),
                     **device_ms(torch, [lambda: fn(t)]),
                     "pull_ms": round(statistics.median(pulls) * 1e3, 5)}
        print(f"  engine kernel {name} on E1's columns: {json.dumps(out[name])}", flush=True)
    calls = captured["path_e"]
    out["H_on_e1"] = time_slot_at(torch, "H", *calls["H"][0], "path E E1")
    out["X_on_e1"] = time_slot_at(torch, "X", *calls["X"][0], "path E E1")
    return out


def u64_max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over u64 bit patterns (0 when equal)."""
    g = got.cpu().numpy().view(np.uint64)
    w = want.cpu().numpy().view(np.uint64)
    bad = np.flatnonzero(g != w)
    return max((abs(int(g[i]) - int(w[i])) for i in bad), default=0)


def time_sum_kernel(torch, captured):
    """Kernel S, its plain version and `torch.cumsum` (the nearest one-call
    pass, no segments) on the inputs path C1 handed S."""
    from evolu_tpu_torch.ops import cuda_scan

    shapes = {}
    for slot in ("S_counter", "S_tensor_sum"):
        (flags, values), _ = captured[slot][0]
        n = flags.shape[0]
        got = cuda_scan.segmented_sum_scan_cuda(flags, values)
        want = cuda_scan.segmented_sum_scan_plain(flags, values)
        same([got], [want], f"S on path C1's {slot} input")
        call = functools.partial(cuda_scan.segmented_sum_scan_cuda, flags, values)
        ms = cuda_ms(call)
        dev = device_ms(torch, [call], records=1)
        plain_ms = cuda_ms(functools.partial(cuda_scan.segmented_sum_scan_plain, flags, values), reps=3, inner=2)
        cumsum_ms = cuda_ms(functools.partial(torch.cumsum, values, 0))
        bound = max(bound_parts("S", (flags, values)))
        shapes[slot] = {"rows": n, "max_abs_err": u64_max_abs_err(got, want), "ms": round(ms, 5),
                        **dev, "plain_ms": round(plain_ms, 5), "bound_ms": round(bound, 5),
                        "cumsum_ms": round(cumsum_ms, 5)}
        print(f"  S {slot}: {json.dumps(shapes[slot])}", flush=True)
    return shapes


def columns_pass(torch, n, captured=None, slots=("L", "H", "X"), reps=3):
    """The reconcile pass on device-resident columns: stage times from
    CUDA events recorded where each kernel is entered and left. Then one
    more, untimed, run hands the inputs of the kernels in `slots` to
    `captured`, so that holding them moves no timed run's peak memory.
    Returns (decoded outputs, report)."""
    from evolu_tpu_torch.ops import columns_to_device, to_host_many
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import merkle_ops as mo
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr

    cols = build_columns(n)
    t = columns_to_device(cols, "cuda")
    args = [t[k] for k in pr.COLUMN_NAMES]
    kernel = pr.shard_kernel_for(cols)
    ev, into = {}, None

    def mark(name):
        if name is not None and name not in ev:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev[name] = e

    def spy(orig, before, after, slot):
        def run(*a, **kw):
            mark(before)
            if into is not None and slot in slots:
                into.setdefault(slot, []).append((a, kw))
            out = orig(*a, **kw)
            if after:
                mark(after)
            return out
        return run

    def spies():
        stack = contextlib.ExitStack()
        stack.enter_context(patched(pm, "segmented_max_scan",
                                    spy(pm.segmented_max_scan, "key_sort_end", None, "L")))
        stack.enter_context(patched(pr, "masked_key_hashes",
                                    spy(pr.masked_key_hashes, "plan_compare_end", "hash_render_end", "H")))
        stack.enter_context(patched(mo, "segmented_xor_scan", spy(mo.segmented_xor_scan, None, None, "X")))
        return stack

    runs = []
    for _ in range(reps):
        ev.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with spies():
            t0 = time.perf_counter()
            mark("start")
            outs = kernel(*args)
            mark("minute_fold_end")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            xor_s, upsert_s, i_s, *segs, digest = to_host_many(*outs)
            xor_mask, upsert_mask = unpermute_masks(xor_s, upsert_s, i_s)
            deltas = decode_owner_minute_deltas(*segs)
            t2 = time.perf_counter()
        order = ["start", "key_sort_end", "plan_compare_end", "hash_render_end", "minute_fold_end"]
        names = ["key_sort", "plan_compare", "hash_render", "minute_fold"]
        stages = {nm: ev[a].elapsed_time(ev[b]) for nm, a, b in zip(names, order, order[1:])}
        stages["delta_encode"] = (t2 - t1) * 1e3
        runs.append((stages, (t2 - t0), torch.cuda.max_memory_allocated()))
    stages = {k: statistics.median(r[0][k] for r in runs) for k in runs[0][0]}
    wall = statistics.median(r[1] for r in runs)
    report = {
        "messages": n, "rows_padded": int(args[0].shape[0]), "kernel": kernel.__name__,
        "stage_ms": {k: round(v, 4) for k, v in stages.items()},
        "stage_ms_reps": [{k: round(v, 4) for k, v in r[0].items()} for r in runs],
        "device_ms": round(sum(v for k, v in stages.items() if k != "delta_encode"), 4),
        "pass_s": round(wall, 4), "rows_per_s": round(n / wall),
        "peak_device_bytes": max(r[2] for r in runs),
    }
    if captured is not None:
        into = captured
        with spies():
            kernel(*args)
        torch.cuda.synchronize()
    decoded = (xor_mask, upsert_mask, deltas, int(digest.view(np.uint32)[0]))
    return decoded, report, (kernel, args)


def plain_reference(torch, kernel, args):
    """The same pass with every kernel swapped for its plain version."""
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan, to_host_many
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import merkle_ops as mo
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr

    with patched(pm, "segmented_max_scan", cuda_scan.segmented_max_scan_plain), \
         patched(mo, "segmented_xor_scan", cuda_scan.segmented_xor_scan_plain), \
         patched(pr, "masked_key_hashes", cuda_hash.masked_key_hashes_plain):
        xor_s, upsert_s, i_s, *segs, digest = to_host_many(*kernel(*args))
    return (*unpermute_masks(xor_s, upsert_s, i_s), decode_owner_minute_deltas(*segs),
            int(digest.view(np.uint32)[0]))


def check_against_plain(decoded, reference, what):
    if not (np.array_equal(decoded[0], reference[0]) and np.array_equal(decoded[1], reference[1])
            and decoded[2] == reference[2] and decoded[3] == reference[3]):
        raise AssertionError(f"{what}: kernel pass differs from the plain pass")


h_ops_per_row = None  # counted in the SASS of timestamp_hash in main()


def bound_parts(slot, a):
    """(bytes / HBM rate, integer ops / INT32 rate) in ms for one call of
    kernel `slot` on positional arguments `a`: each input read once,
    each output written once. Bytes per row: L 1+8+8 in, 16 out; X 1+4
    in, 4 out; S 1+8 in, 8 out; H 8+8+1 in, 4 out (and a 4-byte digest).
    H's operations: `h_ops_per_row` for each row its mask hashes."""
    n = a[0].shape[0]
    bytes_ = n * {"L": 33, "X": 9, "S": 17, "H": 21}[slot] + (4 if slot == "H" else 0)
    ops = h_ops_per_row * int(a[2].sum()) if slot == "H" else 0
    return bytes_ / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3


def kernel_forms():
    """slot -> (kernel wrapper, plain version), both on a dispatcher's
    arguments."""
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan

    return {"L": (cuda_scan.segmented_max_scan_cuda, cuda_scan.segmented_max_scan_plain),
            "X": (cuda_scan.segmented_xor_scan_cuda, cuda_scan.segmented_xor_scan_plain),
            "S": (cuda_scan.segmented_sum_scan_cuda, cuda_scan.segmented_sum_scan_plain),
            "H": (cuda_hash.masked_key_hashes_cuda, cuda_hash.masked_key_hashes_plain)}


def as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def time_path_calls(torch, kernels, calls):
    """Each kernel on every input path C2 handed it, checked against its
    plain version: kernel ms (CUDA events), device ms (profiler) and bound
    ms summed over the calls, i.e. per run of path C2; and the wrapper's
    host time per call on the smallest of those inputs."""
    forms = kernel_forms()
    out = {}
    for k in kernels:
        cuda_fn, plain_fn = forms[k["slot"]]
        ms = bound = 0.0
        rows, fns = [], []
        for a, kw in calls[k["slot"]]:
            same(as_list(cuda_fn(*a, **kw)), as_list(plain_fn(*a, **kw)), k["name"] + " on path C2's input")
            fns.append(functools.partial(cuda_fn, *a, **kw))
            ms += cuda_ms(fns[-1])
            bound += max(bound_parts(k["slot"], a))
            rows.append(int(a[0].shape[0]))
        small = min(range(len(rows)), key=rows.__getitem__)
        out[k["name"]] = {"calls": len(rows), "rows_min": min(rows), "rows_max": max(rows),
                          "ms": round(ms, 5), **device_ms(torch, fns, reps=5, records=len(fns)),
                          "bound_ms": round(bound, 5), "host_us": round(host_us(torch, fns[small]), 3),
                          "host_us_rows": rows[small]}
        print(f"  {k['name']} per run of path C2: {json.dumps(out[k['name']])}", flush=True)
    return out


def time_slot_at(torch, slot, a, kw, what):
    """Kernel `slot` and its plain version on one input, checked bit for bit."""
    cuda_fn, plain_fn = kernel_forms()[slot]
    got = as_list(cuda_fn(*a, **kw))
    want = as_list(plain_fn(*a, **kw))
    same(got, want, f"{slot} on {what}")
    call = functools.partial(cuda_fn, *a, **kw)
    t_bytes, t_ops = bound_parts(slot, a)
    out = {"timed_on": what, "rows": int(a[0].shape[0]), "max_abs_err": max_abs_err(got, want),
           "ms": round(cuda_ms(call), 5), **device_ms(torch, [call], records=1),
           "plain_ms": round(cuda_ms(functools.partial(plain_fn, *a, **kw), reps=3, inner=2), 5),
           "bound_ms": round(max(t_bytes, t_ops), 5), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"  {slot} {what}: {json.dumps(out)}", flush=True)
    return out


def time_kernels(torch, kernels, captured):
    """Each kernel and its plain version on the inputs the 1M columns
    pass gave it (L: the mean over its calls); bound = max(bytes / HBM
    rate, ops / INT32 rate)."""
    forms = kernel_forms()
    rows = []
    for k in kernels:
        cuda_fn, plain_fn = forms[k["slot"]]
        calls = captured[k["slot"]]
        timed = calls if k["slot"] == "L" else calls[:1]
        got = [as_list(cuda_fn(*a, **kw)) for a, kw in calls]
        want = [as_list(plain_fn(*a, **kw)) for a, kw in calls]
        for g, w in zip(got, want):
            same(g, w, k["name"] + " on main-path inputs")
        ms = statistics.mean(cuda_ms(functools.partial(cuda_fn, *a, **kw)) for a, kw in timed)
        dev = device_ms(torch, [functools.partial(cuda_fn, *a, **kw) for a, kw in timed], per=len(timed),
                         records=len(timed))
        plain_ms = statistics.mean(cuda_ms(functools.partial(plain_fn, *a, **kw), reps=3, inner=2)
                                   for a, kw in timed)
        t_bytes, t_ops = bound_parts(k["slot"], calls[0][0])
        rows.append({
            "name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "timed_on": "columns pass 1M", "rows": int(calls[0][0][0].shape[0]),
            "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got, want)),
            "ms": round(ms, 5), **dev, "plain_ms": round(plain_ms, 5),
            "bound_ms": round(max(t_bytes, t_ops), 5),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    return rows


def native_build():
    """Build the two native host libraries (g++, at first use) in a thread
    while nvcc builds the kernels. → a function that waits for the build
    and raises its log if it failed."""
    import threading

    from evolu_tpu_torch.storage.native import load_library
    from evolu_tpu_torch.sync import native_crypto
    from evolu_tpu_torch.utils import native_loader

    errors = []

    def build():
        try:
            load_library()
            native_loader.load_native_library(native_crypto.SO_NAME, native_crypto._configure)
        except native_loader.NativeBuildError as e:
            errors.append(e)

    thread = threading.Thread(target=build, name="native-build")
    thread.start()

    def join():
        thread.join()
        if errors:
            raise errors[0]

    return join


# ---- path Q: the public surface and the system's entry points ----------------------

Q_CATEGORIES = 20
Q_TODOS = 2_000
Q_EDITS = {"toggle": 500, "rename": 500, "assign": 1_000, "delete": 200}
Q_MIN_RECEIVE = 8_192  # B's first receive must hold at least this many of A's messages
Q_DEVICE = None  # the entry points' device (None = the card; a CPU rehearsal sets "cpu")
Q_WAIT_S = 120.0
# JAX's examples/pod_server.py prints this line for its demo batch at one
# process (tests/test_torch_examples.py holds the port's to it).
Q_POD_LINE = ("proc 0/1: answered 8/8 requests [0, 1, 2, 3, 4, 5, 6, 7] (5312 response bytes), "
              "pod digest 0x9eac93cd")
Q_APP_TABLES = ("todo", "todoCategory")


def q_command(name, *args):
    device = () if Q_DEVICE is None else ("--device", Q_DEVICE)
    return [sys.executable, "-m", f"evolu_tpu_torch.examples.{name}", *args, *device]


def q_spawn(tmp):
    """Q3's two entry points as processes, started before Q1 so that they
    reach the card while Q1 and Q2 run: the relay server on a free port and
    the one-process pod server."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    relay = subprocess.Popen(q_command("relay_server", "--host", "127.0.0.1", "--port", str(port),
                                       "--db", os.path.join(tmp, "q3_relay.db")),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
    pod = subprocess.Popen(q_command("pod_server"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=env, cwd=tmp)
    return {"relay": relay, "pod": pod, "port": port, "t0": t0}


def q_line(proc, prefix, deadline_s=Q_WAIT_S):
    """The first line of `proc`'s output that starts with `prefix`; fails
    with the output so far if the process ends or the deadline passes."""
    import selectors

    seen = []
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    end = time.perf_counter() + deadline_s
    try:
        while time.perf_counter() < end:
            if not sel.select(timeout=max(0.0, end - time.perf_counter())):
                break
            line = proc.stdout.readline()
            if not line:
                break
            seen.append(line.rstrip("\n"))
            if line.startswith(prefix):
                return seen[-1]
    finally:
        sel.unregister(proc.stdout)
    raise AssertionError(f"path Q3: no {prefix!r} line from {proc.args}; its output:\n" + "\n".join(seen[-40:]))


def q_settle(*clients, rounds=4):
    for _ in range(rounds):
        for c in clients:
            c.sync()
            c.worker.flush()
            c._transport.flush()
            c.worker.flush()


def q_dump(db):
    """The app tables and `__message`, each in key order."""
    out = {t: db.exec(f'SELECT * FROM "{t}" ORDER BY "id"') for t in Q_APP_TABLES}
    out["__message"] = db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')
    return out


def q_tree(db):
    (tree,), = db.exec('SELECT "merkleTree" FROM "__clock"')
    return tree


def path_q1(torch, kernels, tmp, device=None):
    """The TodoMVC flow through the public surface: client A writes a real
    user's list and syncs it through a relay; client B restores A's
    mnemonic on an empty database and syncs once (its first receive, all of
    A's messages, planned on the card); a twin of B with backend="cpu" does
    the same on the host planner."""
    from evolu_tpu_torch import Config, RelayServer, RelayStore, connect, create_evolu
    from evolu_tpu_torch.examples import todo_cli

    report = {}
    reset(kernels)
    t0 = time.perf_counter()
    relay = RelayServer(RelayStore(os.path.join(tmp, "q_relay.db")), device=device).start()
    clients = []
    try:
        cfg = Config(sync_url=relay.url + "/")
        a = create_evolu(todo_cli.SCHEMA, config=cfg, db_path=os.path.join(tmp, "q_a.db"), device=device)
        clients.append(a)
        connect(a)
        with a.batching():
            cats = [a.create("todoCategory", {"name": f"category {i}"}) for i in range(Q_CATEGORIES)]
        with a.batching():
            todos = [a.create("todo", {"title": f"todo {i}", "isCompleted": False}) for i in range(Q_TODOS)]
        with a.batching():
            for i in range(Q_EDITS["toggle"]):
                a.update("todo", todos[i], {"isCompleted": True})
        with a.batching():
            for i in range(Q_EDITS["rename"]):
                a.update("todo", todos[250 + i], {"title": f"renamed todo {250 + i}"})
        with a.batching():
            for i in range(Q_EDITS["assign"]):
                a.update("todo", todos[2 * i], {"categoryId": cats[i % Q_CATEGORIES]})
        with a.batching():
            for i in range(Q_EDITS["delete"]):
                a.update("todo", todos[Q_TODOS - 1 - 3 * i], {"isDeleted": True})
        q_settle(a, rounds=2)
        report["a_s"] = round(time.perf_counter() - t0, 3)
        a_messages = a.db.exec('SELECT COUNT(*) FROM "__message"')[0][0]
        a_tree = q_tree(a.db)
        if relay.store.get_merkle_tree_string(a.owner.id) != a_tree:
            raise AssertionError("path Q1: the relay's tree differs from A's after A synced")

        b_end = {}
        for name, backend, dev in (("b", "auto", device), ("b_cpu", "cpu", "cpu")):
            t1 = time.perf_counter()
            b = create_evolu(todo_cli.SCHEMA, config=Config(sync_url=relay.url + "/", backend=backend),
                             db_path=os.path.join(tmp, f"q_{name}.db"), mnemonic=a.owner.mnemonic, device=dev)
            clients.append(b)
            tb = connect(b)
            q_settle(b, rounds=1)
            first = tb.counts.get("response_messages", 0)
            report[f"{name}_first_receive"] = first
            report[f"{name}_s"] = round(time.perf_counter() - t1, 3)
            if first != a_messages or first < Q_MIN_RECEIVE:
                raise AssertionError(f"path Q1: {name}'s first receive held {first} messages, not A's {a_messages} "
                                     f"(at least {Q_MIN_RECEIVE})")
            b_end[name] = (b.query_once(todo_cli.TODOS), q_tree(b.db), q_dump(b.db))
        launches = read(kernels)
        wall = time.perf_counter() - t0
        a_rows = a.query_once(todo_cli.TODOS)
        if b_end["b"][0] != a_rows:
            raise AssertionError("path Q1: B's ls rows differ from A's")
        if not (b_end["b"][1] == a_tree == relay.store.get_merkle_tree_string(a.owner.id)):
            raise AssertionError("path Q1: B's Merkle tree differs from A's or the relay's")
        if b_end["b"][2] != b_end["b_cpu"][2]:
            raise AssertionError("path Q1: B's SQLite end state differs from its backend='cpu' twin's")
        if b_end["b_cpu"][0] != a_rows or b_end["b_cpu"][1] != a_tree:
            raise AssertionError("path Q1: the backend='cpu' twin's rows or tree differ from A's")
        live = len(a_rows)
        if live != Q_TODOS - Q_EDITS["delete"]:
            raise AssertionError(f"path Q1: {live} live todos, not {Q_TODOS - Q_EDITS['delete']}")
        for k in kernels:
            if k["slot"] in "LXH" and not launches[k["name"]]:
                raise AssertionError(f"path Q1: {k['name']} never launched")
        report.update({"messages": a_messages, "live_todos": live, "wall_s": round(wall, 3),
                       "b_msgs_per_s": round(a_messages / report["b_s"], 1),
                       "b_cpu_msgs_per_s": round(a_messages / report["b_cpu_s"], 1)})
        return launches, report, relay
    except BaseException:
        stop_relay(relay)
        raise
    finally:
        for c in clients:
            c.dispose()


def q_api(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def path_q2(torch, kernels, relay, device=None):
    """The web demo's episode over HTTP (tests/test_web_demo.py): CRUD with
    categories and soft-delete, a long-poll woken by a mutation, a reset;
    then two demos of one owner converging through Q1's relay."""
    from evolu_tpu_torch.examples.web_todo import DemoApp, DemoServer

    reset(kernels)
    t0 = time.perf_counter()
    report = {}
    server = DemoServer(DemoApp(device=device)).start()
    try:
        base = server.url
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            if "TodoMVC" not in r.read().decode():
                raise AssertionError("path Q2: the page does not render")
        cat = q_api(base, "/api/mutate", {"table": "todoCategory", "values": {"name": "home"}})["id"]
        t1 = q_api(base, "/api/mutate", {"table": "todo", "values": {"title": "Buy milk", "isCompleted": False,
                                                                   "categoryId": cat}})["id"]
        s1 = q_api(base, "/api/state?since=-1")
        if [t["title"] for t in s1["todos"]] != ["Buy milk"] or s1["todos"][0]["categoryId"] != cat \
                or not s1["owner"]["mnemonic"]:
            raise AssertionError(f"path Q2: state after two creates: {s1}")
        got = {}
        poll = threading.Thread(target=lambda: got.update(q_api(base, f"/api/state?since={s1['version']}")))
        poll.start()
        time.sleep(0.2)
        q_api(base, "/api/mutate", {"table": "todo", "values": {"id": t1, "isCompleted": True}})
        poll.join(timeout=60)
        if poll.is_alive() or got.get("version", -1) <= s1["version"] or got["todos"][0]["isCompleted"] != 1:
            raise AssertionError(f"path Q2: the long-poll did not wake with the toggle: {got}")
        q_api(base, "/api/mutate", {"table": "todo", "values": {"id": t1, "isDeleted": True}})
        if q_api(base, "/api/state?since=-1")["todos"] != []:
            raise AssertionError("path Q2: the soft-deleted todo is still listed")
        q_api(base, "/api/reset", {})
        s = q_api(base, "/api/state?since=-1")
        if s["todos"] != [] or s["categories"] != []:
            raise AssertionError("path Q2: reset left rows")
    finally:
        server.stop()
    a = DemoServer(DemoApp(sync_url=relay.url, device=device)).start()
    b = None
    try:
        b = DemoServer(DemoApp(sync_url=relay.url, mnemonic=a.app.evolu.owner.mnemonic, device=device)).start()
        cat = q_api(a.url, "/api/mutate", {"table": "todoCategory", "values": {"name": "shared"}})["id"]
        for title in ("from A", "and another"):
            q_api(a.url, "/api/mutate", {"table": "todo", "values": {"title": title, "isCompleted": False,
                                                                   "categoryId": cat}})
        q_api(a.url, "/api/sync", {})
        end = time.perf_counter() + Q_WAIT_S
        while True:
            q_api(b.url, "/api/sync", {})
            sa, sb = q_api(a.url, "/api/state?since=-1"), q_api(b.url, "/api/state?since=-1")
            if (sa["todos"], sa["categories"]) == (sb["todos"], sb["categories"]) and len(sb["todos"]) == 2:
                break
            if time.perf_counter() > end:
                raise AssertionError(f"path Q2: the two demos did not converge: {sa['todos']} vs {sb['todos']}")
            time.sleep(0.1)
        report["converged_titles"] = [t["title"] for t in sb["todos"]]
    finally:
        for s in (a, b):
            if s is not None:
                s.stop()
    launches = read(kernels)
    report["wall_s"] = round(time.perf_counter() - t0, 3)
    return launches, report


def path_q3(torch, spawned, tmp, device=None):
    """The entry points as processes: the relay server answers /ping and a
    POST with the bytes an in-process RelayServer answers; the one-process
    pod server prints JAX's line for the demo batch."""
    from evolu_tpu_torch import RelayServer, RelayStore, Timestamp, timestamp_to_string
    from evolu_tpu_torch.sync import SyncRequest, EncryptedCrdtMessage, encode_sync_request

    t0 = time.perf_counter()
    report = {}
    relay, pod = spawned["relay"], spawned["pod"]
    try:
        q_line(relay, "relay listening on ")
        report["relay_up_s"] = round(time.perf_counter() - spawned["t0"], 3)
        msgs = tuple(EncryptedCrdtMessage(timestamp_to_string(Timestamp(BASE_MILLIS + i * 61_000, i % 3, "ab" * 8)),
                                          b"q3-%d" % i) for i in range(64))
        bodies = [encode_sync_request(SyncRequest(msgs, "q3-owner", "ab" * 8, "{}")),
                  encode_sync_request(SyncRequest((), "q3-owner", "f" * 16, "{}"))]
        twin = RelayServer(RelayStore(os.path.join(tmp, "q3_twin.db")), device=device).start()
        answers = {}
        try:
            for url in (f"http://127.0.0.1:{spawned['port']}", twin.url):
                with urllib.request.urlopen(url + "/ping", timeout=60) as r:
                    answers[url] = [(r.status, r.read())]
                for body in bodies:
                    req = urllib.request.Request(url + "/", data=body,
                                                 headers={"Content-Type": "application/octet-stream"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        answers[url].append((r.status, r.read()))
        finally:
            stop_relay(twin)
        process, in_process = answers.values()
        if process != in_process:
            raise AssertionError("path Q3: the relay_server process answers other bytes than an in-process "
                                 "RelayServer")
        report["answers"] = [(status, len(body)) for status, body in process]
        line = q_line(pod, "proc 0/1:")
        report["pod_up_s"] = round(time.perf_counter() - spawned["t0"], 3)
        if line != Q_POD_LINE:
            raise AssertionError(f"path Q3: the pod server printed {line!r}, not {Q_POD_LINE!r}")
        pod.wait(timeout=Q_WAIT_S)
        if pod.returncode != 0:
            raise AssertionError(f"path Q3: the pod server ended {pod.returncode}")
        report["pod_line"] = line
    finally:
        q_stop(spawned)
    report["wall_s"] = round(time.perf_counter() - t0, 3)
    return report


def q_stop(spawned):
    for key in ("relay", "pod"):
        p = spawned[key]
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        p.stdout.close()


def path_q(torch, kernels, tmp, gpu=""):
    spawned = q_spawn(tmp)
    try:
        launches_q1, report_q1, relay = path_q1(torch, kernels, tmp, Q_DEVICE)
        try:
            launches_q2, report_q2 = path_q2(torch, kernels, relay, Q_DEVICE)
        finally:
            stop_relay(relay)
        report_q3 = path_q3(torch, spawned, tmp, Q_DEVICE)
    finally:
        q_stop(spawned)
    launches = {k: launches_q1[k] + launches_q2[k] for k in launches_q1}
    report = {"q1": report_q1, "q2": report_q2, "q3": report_q3,
              "launches": {"q1": launches_q1, "q2": launches_q2}}
    print("  " + json.dumps(report) + f" | {gpu}", flush=True)
    return launches, report


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from evolu_tpu_torch.ops import cuda_hash, cuda_lib, cuda_scan
    from evolu_tpu_torch.utils import native_loader

    tools = native_loader.toolchain()
    print(f"native toolchain: {tools['compiler']}; links: "
          + ", ".join(f"{so} -> {linked or 'NONE'}" for so, linked in tools["links"].items()), flush=True)
    missing = [so for so, linked in tools["links"].items() if linked is None]
    if missing:
        raise AssertionError(f"the native libraries {missing} cannot link here (no libsqlite3.so.0 or "
                             f"libcrypto); path G needs them")

    gpu = gpu_line()
    dev = torch.device("cuda")
    kernels = [
        {"name": "seg_lex_max_scan", "slot": "L", "fn": cuda_scan.segmented_max_scan_cuda,
         "source": "evolu_tpu_torch/csrc/seg_scan.cu", "replaces": "evolu_tpu/ops/pallas_scan.py:157",
         "ported": 1, "redesigned": 3, "design": "lookback_scan<LexTile>"},
        {"name": "seg_xor_scan", "slot": "X", "fn": cuda_scan.segmented_xor_scan_cuda,
         "source": "evolu_tpu_torch/csrc/seg_scan.cu", "replaces": "evolu_tpu/ops/pallas_scan.py:158",
         "ported": 1, "redesigned": 4, "design": "lookback_scan<XorTile>"},
        {"name": "timestamp_hash", "slot": "H", "fn": cuda_hash.timestamp_hash_cuda,
         "source": "evolu_tpu_torch/csrc/ts_hash.cu", "replaces": "evolu_tpu/ops/pallas_hash.py:98",
         "ported": 1, "redesigned": 4,
         "design": "one 64-bit step, SWAR words, digest by the last block"},
        {"name": "seg_sum_scan", "slot": "S", "fn": cuda_scan.segmented_sum_scan_cuda,
         "source": "evolu_tpu_torch/csrc/seg_scan.cu", "replaces": "evolu_tpu/ops/pallas_scan.py:159",
         "ported": 2, "redesigned": 3, "design": "lookback_scan<SumTile>"},
    ]
    lwws = kernels[:3]
    lww_names = [k["name"] for k in lwws]

    global h_ops_per_row
    with phase("build", gpu), tempfile.TemporaryDirectory() as tmp:
        probe = start_hash_probe(tmp)
        native_built = native_build()
        lib = cuda_lib.load()
        print(f"  build {cuda_lib.build_info['seconds']:.2f}s -> {cuda_lib.build_info['path']}")
        for line in cuda_lib.build_info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip())
        print(f"  H grid: {lib.evolu_ts_hash_scratch_bytes() // 4 - 1} blocks of 256 (reconcile form)")
        h_ops_per_row, detail = sass_ops_per_hashed_row(*probe)
        print(f"  H integer instructions a hashed row: {h_ops_per_row}, counted in the SASS of "
              f"timestamp_hash alone: {detail}", flush=True)
        native_built()
        for so, info in native_loader.build_info.items():
            print(f"  native {so}: {info['seconds']:.2f}s -> {info['path']} (links {info['linked']})", flush=True)
        native_paths_in_port_build()
    with phase("kernels vs plain", gpu):
        kernels_vs_plain(torch, dev)
        print(f"  L, X and S equal their plain versions on {lookback_stress(torch, dev)} look-back stress cases")
        print(f"  H equals its plain version on {hash_stress(torch, dev)} digest and size stress cases")
    launches = {}
    # Daemonic workers: an exception that ends the run ends them too.
    pool = multiprocessing.get_context("spawn").Pool(ORACLE_PROCESSES)
    with phase("path A: reconcile_owner_batches 1M x 1k owners", gpu):
        launches["a"], path_a_run = path_a(torch, kernels, lww_names, pool)
    # Path D's oracle (the longest) and paths B's and C2's sequential
    # oracles run in the pool while the card runs paths M1 to D.
    d_oracle_job = pool.apply_async(d_oracle)
    b_oracle_job, c2_oracle_job = pool.apply_async(b_oracle), pool.apply_async(c2_oracle)
    launches_m, report_m = {}, {}
    with phase("path M1: path A's owners through the scatter plan vs path A's sort plan", gpu):
        launches_m["m1"], report_m["m1"] = path_m1(torch, kernels, path_a_run, gpu)
    launches_n, report_n = {}, {}
    with phase("path N2: path A's owners through reconcile_owner_batches on 8 shards of the card vs path A", gpu):
        launches_n["n2"], report_n["n2"] = path_n2(torch, kernels, path_a_run, gpu)
        del path_a_run
    # Paths E's, F's and H3's oracles, and H1's bodies, are made in the
    # pool while the card runs paths B to E.
    e_oracle_job = pool.apply_async(e_oracle)
    f_oracle_job, h1_bodies_job = pool.apply_async(f_oracle), pool.apply_async(h1_bodies)
    # Path P's oracle set and P1's 1M-row store are made in the pool too.
    p_dir = tempfile.TemporaryDirectory()
    p_store = os.path.join(p_dir.name, "p1.db")
    p2_oracle_job, p_seed_job = pool.apply_async(p2_oracle), pool.apply_async(p_seed, (p_store,))
    # Path N5's pod requests too (pickled for the pod processes).
    n5_dir = tempfile.TemporaryDirectory()
    n5_requests_path = os.path.join(n5_dir.name, "n5_requests.pkl")
    n5_requests_job = pool.apply_async(n5_write_requests, (n5_requests_path,))
    with phase("path B: SQLite apply 100k + 64-replica contention", gpu):
        launches["b"] = path_b(torch, kernels, lww_names, b_oracle_job)
    captured, c2_calls = {}, {}
    with phase("path C1: typed folds at benchmark sizes", gpu):
        launches["c1"], report_c1 = path_c1(torch, kernels, captured)
        print("  " + json.dumps(report_c1), flush=True)
    with phase("path C2: SQLite typed apply 4 x 31k + 10k re-delivery", gpu):
        launches["c2"], report_c2 = path_c2(torch, kernels, c2_calls, c2_oracle_job)
        print("  " + json.dumps(report_c2), flush=True)
    with phase("path D: client DbWorker with the winner cache vs the backend='cpu' oracle", gpu):
        launches["d"], report_d, trees_d2, batches_d, (m3_oracle, n4_oracle) = path_d(
            torch, kernels, d_oracle_job)
        print("  " + json.dumps(report_d), flush=True)
    captured_e, keep_e = {}, {}
    with phase("path E: relay engine at config 3 (1M messages, 1k owners) vs per-request serve", gpu):
        launches["e"], report_e = path_e(torch, kernels, captured_e, keep_e, e_oracle_job)
    with phase("path F: client handle, encrypted sync through the relay, card set vs oracle set", gpu):
        launches["f"], report_f, h3_oracle = path_f(torch, kernels, f_oracle_job, gpu=gpu)
    with phase("path G1: packed receive, native decrypt to columns into a card DbWorker on the C++ "
               "SQLite layer vs the pure oracle", gpu):
        launches_g1, report_g1 = path_g1(torch, kernels, trees_d2, batches_d, report_d, n4_oracle, pool)
        print("  " + json.dumps(report_g1) + f" | {gpu}", flush=True)
    with phase("path M3: a card DbWorker on the scatter plan replays D1 and D2 vs path D's oracle", gpu):
        launches_m["m3"], report_m["m3"] = path_m3(torch, kernels, trees_d2, batches_d, m3_oracle, gpu)
        report_m["m3"]["path_d_msgs_per_s"] = {"d1": report_d["d1"]["msgs_per_s"]}
    with phase("path N4: a card DbWorker on 8 shards (the hot-owner route, the sharded winner cache) replays D1 "
               "and D2 vs path D's oracle", gpu):
        launches_n["n4"], report_n["n4"] = path_n4(torch, kernels, trees_d2, batches_d, n4_oracle,
                                                   report_d, gpu)
        del batches_d, m3_oracle, n4_oracle
    bodies_h1 = h1_bodies_job.get()
    p2_oracle_out, p_seed_out = p2_oracle_job.get(), p_seed_job.get()
    n5_requests_job.get()
    pool.terminate()
    pool.join()
    with phase("path G2: the relay's packed ingest on native stores vs path E's generic ingest", gpu):
        launches_g2, report_g2 = path_g2(torch, kernels, keep_e)
        print("  " + json.dumps(report_g2) + f" | {gpu}", flush=True)
    launches["g"] = {k: launches_g1[k] + launches_g2[k] for k in launches_g1}
    with tempfile.TemporaryDirectory() as tmp_n:
        with phase("path N3: the relay engine on 8 shards of the card (E1, E2, a hot owner, a cap overflow) vs "
                   "path E and a 1-shard engine", gpu):
            launches_n["n3"], report_n["n3"] = path_n3(torch, kernels, keep_e, tmp_n, report_g2, gpu)
    with phase("path N6: live relays with the mesh engine (mesh_engine, EVOLU_MESH_ENGINE) vs a relay without "
               "a mesh", gpu):
        launches_n["n6"], report_n["n6"] = path_n6(torch, kernels, keep_e, gpu)
    report_g = {"g1": report_g1, "g2": report_g2, "launches_g1": launches_g1, "launches_g2": launches_g2}
    with tempfile.TemporaryDirectory() as tmp_hi:
        with phase("path H: the relay as a live HTTP server (batching RelayServer, the streaming ingest, "
                   "clients on the v2 wire) vs path E and path F's oracle set", gpu):
            launches["h"], report_h = path_h(torch, kernels, keep_e, tmp_hi, h3_oracle, bodies_h1, gpu)
            del bodies_h1
            print("  " + json.dumps(report_h["launches"]) + f" | {gpu}", flush=True)
        with phase("path I: the relay tier on the card (anti-entropy at full state, snapshot bootstrap and "
                   "checkpoint, the owner-sharded fleet) vs their oracles", gpu):
            launches["i"], report_i = path_i(torch, kernels, keep_e, tmp_hi, gpu)
            print("  " + json.dumps(report_i["launches"]) + f" | {gpu}", flush=True)
        with phase("path J: push subscriptions and the event-loop connection tier (parked long-polls beside "
                   "engine passes, tier byte identity, the client's push leg)", gpu):
            launches["j"], report_j = path_j(torch, kernels, tmp_hi, gpu)
            print("  " + json.dumps(report_j["launches"]) + f" | {gpu}", flush=True)
        with phase("path K: the write-behind storage inversion (H1 and H2 with write-behind on, crash and "
                   "replay) vs path E and synchronous twins", gpu):
            launches["k"], report_k = path_k(torch, kernels, keep_e, tmp_hi, report_h["h1"], report_h["h2"], gpu)
            print("  " + json.dumps(report_k["launches"]) + f" | {gpu}", flush=True)
        with phase("path O: observability on the reconcile pass (obs off / on, 1M messages) and on the live relay "
                   "(/metrics, /stats, /trace, /profile with the device lane)", gpu):
            launches["o"], report_o = path_o(torch, kernels, keep_e, tmp_hi, gpu)
            print("  " + json.dumps(report_o["launches"]) + f" | {gpu}", flush=True)
        with phase("path P: scoped sync (partial replication: thin pullers of a one-lane slice from deep "
                   "histories, scoped handles with the deferred frontier and the widening, a scoped snapshot "
                   "bootstrap, the scoped fold) vs owed sets and an oracle set", gpu):
            try:
                launches["p"], report_p = path_p(torch, kernels, tmp_hi, p2_oracle_out, (p_store, p_seed_out), gpu)
            finally:
                p_dir.cleanup()
            del p2_oracle_out
            print("  " + json.dumps(report_p["launches"]) + f" | {gpu}", flush=True)
    reports = []
    # The 1M pass gives L, H and X their timed inputs (the 10M pass was cut
    # when path J was added, two of its three reps when path P was).
    with phase("columns pass 1,000,000 messages", gpu):
        decoded, report, (kernel, args) = columns_pass(torch, 1_000_000, captured, ("L", "H", "X"), reps=1)
        check_against_plain(decoded, plain_reference(torch, kernel, args), "columns 1000000")
        print("  " + json.dumps(report), flush=True)
        reports.append(report)
    with phase("path M2: the scatter plan vs the sort plan at 2^20 rows (the columns pass's inputs)", gpu):
        report_m["m2"] = path_m2(torch, args, report, gpu)
        del args
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp_n:
        # N5's pod processes start here, after the timed M2, and start up
        # while M4 runs; N1 runs after they ended, with the card to itself.
        spawned_n5 = n5_spawn(tmp_n, n5_requests_path)
        try:
            with phase("path M4: the merge-plan router's edges on the card vs the host oracle and the CPU port",
                       gpu):
                launches_m["m4"], report_m["m4"] = path_m4(torch, kernels, gpu)
            launches["m"] = {k: sum(p[k] for p in launches_m.values()) for k in launches_m["m1"]}
            report_m["launches"] = launches_m
            with phase("path N5: config 5's pod pass across two processes (gloo, 4 shards each) vs one process",
                       gpu):
                launches_n["n5"], report_n["n5"] = path_n5(torch, kernels, spawned_n5, tmp_n, gpu)
        finally:
            for p in spawned_n5[0]:
                if p.is_alive():
                    p.kill()
                    p.join()
            n5_dir.cleanup()
    with phase("path N1: config 5's layout at 2^22 messages (cut from 10M) on 8 shards of the card vs one shard",
               gpu):
        launches_n["n1"], report_n["n1"] = path_n1(torch, kernels, gpu)
    launches["n"] = {k: sum(p[k] for p in launches_n.values()) for k in N_LWW}
    report_n["launches"] = launches_n
    for k in kernels:
        if k["slot"] in "LHX" and not launches["n"][k["name"]]:
            raise AssertionError(f"path N: {k['name']} never launched on the mesh")
    with phase("kernel timing on main-path inputs", gpu):
        table = time_kernels(torch, lwws, captured)
        s_shapes = time_sum_kernel(torch, captured)
        c2_times = time_path_calls(torch, kernels, c2_calls)
        report_e["engine_kernels"] = engine_kernel_timing(torch, captured_e)
    del captured_e
    # O3 runs after the timing phase: with O3 after O2, unscheduled
    # profiler sessions of the timing phase caught fewer kernel records,
    # none in four of five whole runs. `device_ms`'s scheduled sessions
    # caught every record before and after O3 alike, but O3 stays out of
    # their way (ROADMAP queue 3 item 10).
    with phase("path O3: the conservation ledger on the relay tier (write-behind relay and peer, forward fleet, "
               "client apply; ledger off / on / off)", gpu), tempfile.TemporaryDirectory() as tmp_o3:
        launches_o3, report_o["o3"] = path_o3(torch, kernels, keep_e.pop("k1_replay"), tmp_o3, gpu=gpu)
        report_o["launches"]["o3"] = launches_o3
        launches["o"] = {k: launches["o"][k] + launches_o3[k] for k in launches_o3}
        print("  " + json.dumps(report_o["launches"]) + f" | {gpu}", flush=True)
    with phase("path Q: the public surface (the TodoMVC flow through create_evolu, connect and a RelayServer, "
               "the web demo over HTTP, the relay and pod servers as processes)", gpu), \
            tempfile.TemporaryDirectory() as tmp_q:
        launches["q"], report_q = path_q(torch, kernels, tmp_q, gpu)
    table[1]["at_path_e"] = report_e["engine_kernels"]["X_on_e1"]
    table[2]["at_path_e"] = report_e["engine_kernels"]["H_on_e1"]
    table[2]["ops_per_hashed_row"] = h_ops_per_row
    s_row = s_shapes["S_counter"]
    table.append({
        "name": "seg_sum_scan", "route": "cuda", "source": kernels[3]["source"],
        "replaces": kernels[3]["replaces"], "timed_on": "path C1 pn_counter_sums", "rows": s_row["rows"],
        "max_abs_err": max(v["max_abs_err"] for v in s_shapes.values()),
        "ms": s_row["ms"], **{k: s_row[k] for k in ("device_ms", "device_ms_events") if k in s_row},
        "plain_ms": s_row["plain_ms"], "bound_ms": s_row["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "cumsum_ms_nearest_one_call": s_row["cumsum_ms"],
        "at_tensor_sum_input": s_shapes["S_tensor_sum"],
    })
    for row, k in zip(table, kernels):
        row.update({key: k[key] for key in ("ported", "redesigned", "design")})
        for p in ("a", "b", "c1", "c2", "d", "e", "f", "g", "h", "i", "j", "k", "o", "p", "m", "n", "q"):
            row[f"launches_path_{p}"] = launches[p][row["name"]]
        row["launches"] = sum(launches[p][row["name"]] for p in launches)
        row["path_c2_ms"] = c2_times[row["name"]]["ms"]
        for key in ("device_ms", "device_ms_events"):
            if key in c2_times[row["name"]]:
                row[f"path_c2_{key}"] = c2_times[row["name"]][key]
        row["path_c2_bound_ms"] = c2_times[row["name"]]["bound_ms"]
        row["host_us"] = c2_times[row["name"]]["host_us"]
        row["host_us_rows"] = c2_times[row["name"]]["host_us_rows"]
    print(f"chip_smoke: every phase ok in {time.perf_counter() - t_start:.1f}s | {gpu}", flush=True)
    print(json.dumps({"columns": reports, "typed": {"c1": report_c1, "c2": report_c2}, "client": report_d,
                      "relay": report_e, "handle": report_f, "packed_native": report_g, "live_relay": report_h,
                      "relay_tier": report_i, "push_tier": report_j, "write_behind": report_k,
                      "observability": report_o, "scoped_sync": report_p, "merge_plan": report_m,
                      "mesh": report_n, "public_surface": report_q}, default=str))
    print(json.dumps({"kernels": table}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
