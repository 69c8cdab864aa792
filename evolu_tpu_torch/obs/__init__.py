"""Observability: metrics registry, flight recorder, distributed tracing,
conservation ledger and stage anatomy (host-side only).

The port's copy of `evolu_tpu.obs`, with the same module, function and
metric-family names.

`obs.metrics` — thread-safe counters/gauges/histograms with Prometheus
v0.0.4 text exposition, a JSON snapshot, span-derived exemplars, and a
label-cardinality bound, served by the relay at GET /metrics and
GET /stats (server/relay.py).

`obs.flight` — bounded structured-event ring whose dump is attached to
exceptions crossing the worker/relay boundary.

`obs.ledger` — the conservation-ledger accounting plane: typed flow
stations with registered conservation equations, an `audit()` that
returns violated equations with per-station deltas (empty ==
conserved), owner-scoped sub-ledgers behind the cardinality cap. The
port's modules do not count into it yet; `obs.trace.write_evidence`
reads its snapshot.

`obs.trace` — W3C-traceparent-style distributed tracing: a bounded
per-process span ring, deterministic hash-based sampling, fan-in span
links, `GET /trace/<id>` span trees, and a Chrome-trace export (one
mutation followed client → relay → scheduler → engine).

`obs.anatomy` — the stage-anatomy plane: a declarative registry over
the reconcile pipeline with machine-readable cost laws and priced
floors (a `cuda` row only), and the `evolu_stage_*` metrics family
(per-batch dispatch/pull/apply shares, fixed-cost-vs-slope fits,
over-floor flags).

This package imports no torch, no jax, no kernel module and nothing of
`evolu_tpu` (directly or transitively): metrics and spans record
host-side Python values the hot paths already hold — never an extra
device pull, never a launch. `tests/test_torch_import_hygiene.py` and
`tests/test_torch_obs_liveness.py` enforce it.
"""

from evolu_tpu_torch.obs import flight, ledger, metrics, trace
from evolu_tpu_torch.obs import anatomy
from evolu_tpu_torch.obs.flight import recorder
from evolu_tpu_torch.obs.metrics import registry, set_enabled

__all__ = ["anatomy", "flight", "ledger", "metrics", "trace", "recorder",
           "registry", "set_enabled"]
