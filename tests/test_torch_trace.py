"""The port's distributed tracing (`evolu_tpu_torch.obs.trace`), the twin
of tests/test_trace.py without its fleet episodes (their twins are in
tests/test_torch_trace_legs.py): the context codec and
deterministic sampling, the bounded span ring and fan-in link retrieval,
the Chrome export's shape, the relay's GET /trace surface and its token
gate, traceparent header fuzz (malformed headers are ignored, never a 4xx
or 5xx), the client transport's header hop and the worker's root span.
Then single-relay tracing (client → relay → scheduler → engine on the
CPU) and parity with the JAX package: the same codec results over the
fuzz inputs, the same sampling decisions, and an equal `export_chrome()`
for the same spans with the clock pinned."""

import json
import time
import urllib.error
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu_torch.obs import metrics, trace
from evolu_tpu_torch.server.relay import RelayServer, RelayStore
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.sync.client import _http_post
from evolu_tpu_torch.utils.log import logger

BASE = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _clean_slate():
    logger.clear()  # resets metrics + flight + trace ring
    trace.set_enabled(True)
    trace.set_sample_rate(1.0)
    yield
    trace.set_enabled(True)
    trace.set_sample_rate(1.0)
    logger.clear()


def _msgs(k, n, t0=0, content=b"ct-%d"):
    node = f"{k + 1:016x}"
    return tuple(
        protocol.EncryptedCrdtMessage(
            timestamp_to_string(Timestamp(BASE + (t0 + j) * 1000, 0, node)),
            content % (t0 + j) if b"%d" in content else content,
        )
        for j in range(n)
    )


def _sync_request(owner, messages=(), tree="{}"):
    return protocol.SyncRequest(messages, owner, "00000000000000bb", tree)


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


# --- context codec + sampling ---


def test_traceparent_roundtrip():
    ctx = trace.SpanContext("ab" * 16, "cd" * 8, True)
    assert trace.format_traceparent(ctx) == f"00-{'ab' * 16}-{'cd' * 8}-01"
    back = trace.parse_traceparent(trace.format_traceparent(ctx))
    assert back.trace_id == ctx.trace_id and back.span_id == ctx.span_id


@pytest.mark.parametrize("value", [
    None, "", "garbage", "00", "00-xyz", "00-" + "g" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",      # all-zero trace id
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",     # all-zero span id
    "00-" + "ab" * 16 + "-" + "cd" * 8,             # missing flags
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-xx",  # v00 with extra member
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",     # forbidden version
    "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",     # uppercase hex
    "x" * 10_000,                                   # oversized
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01" + "-m" * 500,
])
def test_parse_traceparent_never_raises_and_rejects(value):
    assert trace.parse_traceparent(value) is None


def test_parse_accepts_future_version_with_extra_members():
    ctx = trace.parse_traceparent(
        "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra-members"
    )
    assert ctx is not None and ctx.trace_id == "ab" * 16


def test_sampling_is_deterministic_and_proportional():
    rec = trace.TraceRecorder()
    rec.sample_rate = 0.5
    ids = [rec.new_trace_id() for _ in range(1000)]
    decisions = [rec.sampled(t) for t in ids]
    # Deterministic: same id, same answer, every time.
    assert decisions == [rec.sampled(t) for t in ids]
    assert 350 < sum(decisions) < 650  # ~50%, generous bounds
    rec.sample_rate = 1.0
    assert all(rec.sampled(t) for t in ids)
    rec.sample_rate = 0.0
    assert not any(rec.sampled(t) for t in ids)


def test_unsampled_trace_propagates_context_but_records_nothing():
    rec = trace.TraceRecorder()
    rec.sample_rate = 0.0
    s = rec.start_span("quiet")
    assert s.context is not None  # downstream hops still see the id
    # No exemplar may be minted from an unsampled span: the histogram→
    # trace jump must never dead-end on a trace the ring can't show.
    assert s.trace_id is None
    s.end()
    assert rec.dump() == []


def test_link_forced_span_promotes_its_context_so_children_record():
    """A fan-in span recorded because a LINKED trace is sampled must
    hand children (the engine pass's kernel:* spans) a sampled
    context — not silently drop them whenever its own fresh trace
    rolls unsampled."""
    rec = trace.TraceRecorder()
    rec.sample_rate = 1.0
    req = rec.start_span("request")
    req.end()
    rec.sample_rate = 0.0  # every fresh trace now rolls unsampled
    batch = rec.start_span("batch", links=[req.context])
    assert batch.context.sampled  # promoted
    child = rec.start_span("kernel:merkle", parent=batch.context)
    child.end()
    batch.end()
    names = {s.name for s in rec.dump()}
    assert {"request", "batch", "kernel:merkle"} <= names


# --- ring + links + exports ---


def test_span_ring_is_bounded():
    rec = trace.TraceRecorder(capacity=8)
    for i in range(50):
        rec.start_span(f"s{i}").end()
    assert len(rec.dump()) == 8


def test_spans_for_includes_fanin_links_and_tree_nests():
    root = trace.start_span("root")
    child = trace.start_span("child", parent=root.context)
    child.end()
    root.end()
    batch = trace.start_span("batch", links=[child.context])
    batch.end()
    got = trace.serve_trace(root.trace_id)
    names = {s["name"] for s in got["spans"]}
    assert names == {"root", "child", "batch"}
    (tree_root,) = [n for n in got["tree"] if n["name"] == "root"]
    assert [c["name"] for c in tree_root["children"]] == ["child"]
    (linked,) = [n for n in got["tree"] if n.get("linked")]
    assert linked["name"] == "batch"
    assert [root.trace_id, child.context.span_id] in linked["links"]


def test_chrome_export_shape():
    s = trace.start_span("kernel:merkle", attrs={"n": 3})
    s.end()
    out = trace.export_chrome()
    (ev,) = [e for e in out["traceEvents"] if e["name"] == "kernel:merkle"]
    assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["args"]["n"] == 3


def test_log_span_mirrors_into_active_trace_under_kernel_name():
    from evolu_tpu_torch.utils.log import span

    root = trace.start_span("batch")
    with trace.use(root.context):
        with span("kernel:reconcile"):
            pass
    root.end()
    names = [s.name for s in trace.spans_for(root.trace_id)]
    assert "kernel:reconcile" in names and "batch" in names


def test_write_evidence_artifact(tmp_path):
    trace.start_span("ev").end()
    path = trace.write_evidence("unit", seed=7)
    with open(path) as f:
        payload = json.load(f)
    assert payload["seed"] == 7
    assert any(e["name"] == "ev" for e in payload["trace"]["traceEvents"])
    assert "counters" in payload["metrics"]


# --- relay surface: /trace + token gate + header fuzz ---


def test_relay_trace_endpoint_and_404s():
    server = RelayServer(RelayStore()).start()
    try:
        root = trace.start_span("client.mutate")
        hdr = {trace.TRACEPARENT_HEADER: trace.format_traceparent(root.context)}
        _http_post(server.url + "/", protocol.encode_sync_request(
            _sync_request("alice", _msgs(0, 2))), headers=hdr)
        root.end()
        got = json.loads(_get(server.url + f"/trace/{root.trace_id}"))
        names = {s["name"] for s in got["spans"]}
        assert {"client.mutate", "relay.sync", "relay.respond"} <= names
        (srv,) = [s for s in got["spans"] if s["name"] == "relay.sync"]
        assert srv["trace_id"] == root.trace_id
        assert srv["attrs"]["owner"] == "alice"
        # The index lists the trace; chrome format parses.
        assert root.trace_id in json.loads(_get(server.url + "/trace"))["recent"]
        chrome = json.loads(_get(
            server.url + f"/trace/{root.trace_id}?format=chrome"))
        assert chrome["traceEvents"]
        # Not-a-trace-id answers 404, never 500.
        for bad in ("zz", "a" * 31, "A" * 32, "a" * 33):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + "/trace/" + bad)
            assert e.value.code == 404
    finally:
        server.stop()


def test_obs_token_gates_metrics_stats_and_trace(monkeypatch):
    server = RelayServer(RelayStore()).start()
    try:
        monkeypatch.setenv("EVOLU_OBS_TOKEN", "s3cret")
        for path in ("/metrics", "/stats", "/trace"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + path)
            assert e.value.code == 403
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + path, {"X-Evolu-Obs-Token": "wrong"})
            assert e.value.code == 403
            # A non-ASCII token header must 403, never crash the
            # handler (compare_digest rejects non-ASCII str inputs).
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + path, {"X-Evolu-Obs-Token": "s\xe9cret"})
            assert e.value.code == 403
            assert _get(server.url + path, {"X-Evolu-Obs-Token": "s3cret"})
        # /ping (liveness) stays open — probes carry no tokens.
        assert _get(server.url + "/ping") == b"ok"
        monkeypatch.delenv("EVOLU_OBS_TOKEN")
        assert _get(server.url + "/metrics")  # unset = open, unchanged
    finally:
        server.stop()


def test_malformed_traceparent_headers_are_ignored_never_an_error():
    """The header-fuzz pin: a hostile/oversized/malformed traceparent
    must never change the HTTP outcome — the request serves 200 and
    the response bytes are identical to the headerless request."""
    server = RelayServer(RelayStore()).start()
    try:
        body = protocol.encode_sync_request(_sync_request("fuzz", _msgs(1, 1)))
        baseline = _http_post(server.url + "/", body)
        for hdr in (
            "garbage", "00", "00-zz-xx-01", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
            "00-" + "0" * 32 + "-" + "0" * 16 + "-00",
            "x" * 8192, "00-" + "a" * 4096 + "-b-01", "\x7f\x01\x02",
            "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-" + "y" * 4000,
        ):
            out = _http_post(server.url + "/", body,
                             headers={trace.TRACEPARENT_HEADER: hdr})
            assert out == baseline, f"header {hdr[:40]!r} changed the response"
    finally:
        server.stop()


# --- client transport hop ---


def test_sync_transport_sends_traceparent_of_the_mutation_trace():
    from evolu_tpu_torch.core.types import Owner
    from evolu_tpu_torch.runtime.messages import SyncRequestInput
    from evolu_tpu_torch.sync.client import SyncTransport
    from evolu_tpu_torch.utils.config import Config

    seen = {}

    def capturing_post(url, body, headers=None):
        seen["headers"] = headers or {}
        # An empty, valid sync response.
        return protocol.encode_sync_response(protocol.SyncResponse((), "{}"))

    transport = SyncTransport(
        Config(sync_url="http://example.invalid"),
        on_receive=lambda *a: None, http_post=capturing_post,
    )
    try:
        root = trace.start_span("client.mutate")
        transport.request_sync(SyncRequestInput(
            messages=(), clock_timestamp=timestamp_to_string(
                Timestamp(BASE, 0, "00000000000000aa")),
            merkle_tree="{}", owner=Owner("o", "m"), trace=root.context,
        ))
        transport.flush()
        root.end()
        hdr = seen["headers"].get(trace.TRACEPARENT_HEADER)
        assert hdr is not None and root.trace_id in hdr
        # The round span joined the mutation's trace in the ring.
        names = [s.name for s in trace.spans_for(root.trace_id)]
        assert "sync.round" in names
    finally:
        transport.stop()


def test_worker_send_mints_the_mutation_root_span():
    from evolu_tpu_torch.runtime.client import create_evolu

    evolu = create_evolu({"todo": ("title",)}, device="cpu")
    pushed = []
    evolu.worker.post_sync = pushed.append
    try:
        evolu.create("todo", {"title": "traced"})
        evolu.worker.flush()
        (req,) = pushed[-1:]
        assert req.trace is not None
        spans = trace.spans_for(req.trace.trace_id)
        assert [s.name for s in spans] == ["client.mutate"]
        assert spans[0].attrs["messages"] >= 1
    finally:
        evolu.dispose()


def test_tracing_disabled_serves_identically_with_empty_ring():
    server = RelayServer(RelayStore()).start()
    try:
        trace.set_enabled(False)
        body = protocol.encode_sync_request(_sync_request("quiet", _msgs(2, 2)))
        _http_post(server.url + "/", body, headers={
            trace.TRACEPARENT_HEADER: "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
        })
        assert trace.recorder.dump() == []
        assert json.loads(_get(server.url + "/trace"))["recent"] == []
    finally:
        trace.set_enabled(True)
        server.stop()


# --- single-relay tracing: client → relay → scheduler → engine ---


def test_one_trace_follows_a_mutation_through_the_batching_relay():
    """A traced sync POST to a batching port relay on the CPU: the
    request's trace holds relay.sync, sched.queue and relay.respond, the
    scheduler's engine.batch span links it, and under the batch span (in
    the batch's own trace) the engine records its kernel:merkle span."""
    server = RelayServer(RelayStore(backend="native"), batching=True, device="cpu").start()
    try:
        root = trace.start_span("client.mutate")
        hdr = {trace.TRACEPARENT_HEADER: trace.format_traceparent(root.context)}
        _http_post(server.url + "/", protocol.encode_sync_request(_sync_request("bob", _msgs(3, 4))),
                   headers=hdr)
        root.end()
        got = json.loads(_get(server.url + f"/trace/{root.trace_id}"))
        names = {s["name"] for s in got["spans"]}
        assert {"client.mutate", "relay.sync", "sched.queue", "engine.batch", "relay.respond"} <= names
        (batch,) = [s for s in got["spans"] if s["name"] == "engine.batch"]
        assert batch["trace_id"] != root.trace_id
        assert any(link[0] == root.trace_id for link in batch["links"])
        inner = json.loads(_get(server.url + f"/trace/{batch['trace_id']}"))
        kernels = [s for s in inner["spans"] if s["name"].startswith("kernel:merkle")]
        assert kernels and all(s["parent_id"] == batch["span_id"] for s in kernels)
    finally:
        server.stop()


# --- parity with the JAX package ---


_FUZZ = [
    None, "", "garbage", "00", "00-xyz", "00-" + "g" * 32 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8, "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-xx",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01", "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",
    "x" * 10_000, "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01" + "-m" * 500,
    "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra-members",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-00", "00-" + "12" * 16 + "-" + "34" * 8 + "-01",
    "garbage", "00", "00-zz-xx-01", "\x7f\x01\x02", "x" * 8192,
]


def test_traceparent_codec_and_sampling_parity_with_jax():
    """The reference's fuzz inputs parse to the same result in both
    packages and format back the same; the same trace ids get the same
    sampling decision at every rate."""
    import numpy as np

    from evolu_tpu.obs import trace as jtrace

    for value in _FUZZ:
        got, want = trace.parse_traceparent(value), jtrace.parse_traceparent(value)
        assert (got is None) == (want is None), value
        if got is not None:
            assert tuple(got) == tuple(want)
            assert trace.format_traceparent(got) == jtrace.format_traceparent(want)
    rng = np.random.default_rng(17)
    ids = [f"{int(rng.integers(0, 1 << 63)) << 65 | int(rng.integers(1, 1 << 63)):032x}" for _ in range(500)]
    for rate in (0.0, 0.01, 0.25, 0.5, 0.999, 1.0):
        prec, jrec = trace.TraceRecorder(), jtrace.TraceRecorder()
        prec.sample_rate = jrec.sample_rate = rate
        assert [prec.sampled(t) for t in ids] == [jrec.sampled(t) for t in ids]


def test_export_chrome_parity_with_jax(monkeypatch):
    """The same span script on a fresh recorder of each package, with the
    id generator seeded alike and the clock pinned, exports the same
    Chrome-trace document."""
    import random
    import time as _time

    from evolu_tpu.obs import trace as jtrace

    def script(mod):
        wall = iter(1_700_000_000.0 + 0.001 * i for i in range(10_000))
        mono = iter(100.0 + 0.0005 * i for i in range(10_000))
        monkeypatch.setattr(_time, "time", lambda: next(wall))
        monkeypatch.setattr(_time, "perf_counter", lambda: next(mono))
        monkeypatch.setattr(mod, "_rng", random.Random(99))
        rec = mod.TraceRecorder()
        root = rec.start_span("client.mutate", attrs={"messages": 3})
        child = rec.start_span("relay.sync", parent=root.context, attrs={"owner": "o1"})
        rec.record_span("sched.queue", child.context, 1_700_000_000.5, 1.25)
        child.end()
        batch = rec.start_span("engine.batch", links=[child.context], attrs={"requests": 1})
        rec.record_span("kernel:merkle|reconcile_stream_finish", batch.context, 1_700_000_000.75, 0.5,
                        {"n": 4})
        batch.end()
        root.end()
        return mod.export_chrome(rec.dump()), rec.spans_for(root.trace_id)

    (pdoc, pspans), (jdoc, jspans) = script(trace), script(jtrace)
    assert pdoc == jdoc
    assert [s.to_json() for s in pspans] == [s.to_json() for s in jspans]
