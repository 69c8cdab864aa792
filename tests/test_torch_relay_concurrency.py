"""Port twin of `tests/test_relay_concurrency.py`: the port's HTTP relay
under concurrent clients, held against the JAX relay store fed the same
messages one request after another.

| JAX test | port test |
|---|---|
| `test_25_concurrent_distinct_owners_match_sequential_oracle` | `test_25_concurrent_distinct_owners_match_the_jax_oracle` (a threaded `RelayServer` over a 4-shard `ShardedRelayStore`; the same workload on a `MultiprocessRelay` is `tests/test_torch_relay_server.py::test_multiprocess_25_concurrent_distinct_owners_match_jax`) |
| `test_single_owner_contention_duplicates_race` | `test_single_owner_contention_duplicates_race_matches_jax` (one `RelayStore`; on a `MultiprocessRelay`: `tests/test_torch_relay_server.py::test_multiprocess_single_owner_duplicates_race_matches_jax`) |
| `test_multiprocess_relay_concurrent_clients_consistent` | `tests/test_torch_relay_server.py::test_multiprocess_concurrent_clients_tables_match_jax` |
| `test_clients_converge_through_multiprocess_relay` | `tests/test_torch_relay_server.py::test_port_clients_converge_through_the_multiprocess_relay` |

Each pull after the race answers the bytes of JAX's
`serve_single_request` on a store fed sequentially. Every threaded run
has its own time limit; tolerance: exact."""

import threading
import urllib.request

from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.server.relay as jrelay
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp

from _torch_port_data import within

BASE = 1_700_000_000_000
FRESH_NODE = "f" * 16  # a node id no message carries
LIMIT_S = 120


def _msgs(proto, node, start, n):
    return tuple(
        proto.EncryptedCrdtMessage(timestamp_to_string(Timestamp(BASE + (start + i) * 1000, 0, node)),
                                   b"ct-%d" % (start + i))
        for i in range(n)
    )


def _post(url, req):
    body = pproto.encode_sync_request(req)
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/octet-stream"}), timeout=30) as r:
        assert r.status == 200
        return r.read()


def _run_threads(workers):
    barrier = threading.Barrier(len(workers))
    errors = []

    def wrap(fn):
        try:
            barrier.wait(timeout=30)
            fn()
        except Exception as e:  # noqa: BLE001 - collected and re-raised
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not any(t.is_alive() for t in threads), "stress thread hung"
    if errors:
        raise errors[0]


def _pull(url, user):
    return _post(url, pproto.SyncRequest((), user, FRESH_NODE, "{}"))


def _jax_pull(store, user):
    return jrelay.serve_single_request(store, jproto.SyncRequest((), user, FRESH_NODE, "{}"))


def test_25_concurrent_distinct_owners_match_the_jax_oracle():
    """25 clients (the reference deployment's concurrency limit), distinct
    owners, 3 rounds each, racing through the threaded server into the
    sharded store; every owner's pull equals the sequential oracle's."""
    server = prelay.RelayServer(prelay.ShardedRelayStore(shards=4), device="cpu").start()
    users = [f"user{i:02d}" for i in range(25)]
    nodes = [f"{i:016x}" for i in range(1, 26)]
    try:
        def client(u, node):
            def run():
                for rnd in range(3):
                    resp = pproto.decode_sync_response(
                        _post(server.url, pproto.SyncRequest(_msgs(pproto, node, rnd * 30, 30), u, node, "{}")))
                    assert resp.merkle_tree  # a tree is always returned
            return run

        within(LIMIT_S, lambda: _run_threads([client(u, n) for u, n in zip(users, nodes)]))
        oracle = jrelay.RelayStore(backend="python")
        try:
            for u, node in zip(users, nodes):
                oracle.add_messages(u, _msgs(jproto, node, 0, 90))
                got = _pull(server.url, u)
                assert got == _jax_pull(oracle, u), u
                assert [m.timestamp for m in pproto.decode_sync_response(got).messages] == [
                    m.timestamp for m in _msgs(pproto, node, 0, 90)], u
        finally:
            oracle.close()
    finally:
        server.stop()


def test_single_owner_contention_duplicates_race_matches_jax():
    """8 writers racing on ONE owner through one SQLite handle, each
    posting its own slice plus a shared slice twice: INSERT OR IGNORE and
    the changes == 1 XOR gate keep the tree exact, duplicates stored
    once."""
    server = prelay.RelayServer(prelay.RelayStore(), device="cpu").start()
    user = "hot-owner"
    shared = _msgs(pproto, "a" * 16, 0, 20)
    try:
        def writer(i):
            node = f"{i + 1:016x}"
            own = _msgs(pproto, node, 100 + i * 20, 20)

            def run():
                _post(server.url, pproto.SyncRequest(shared + own, user, node, "{}"))
                _post(server.url, pproto.SyncRequest(shared, user, node, "{}"))
            return run

        within(LIMIT_S, lambda: _run_threads([writer(i) for i in range(8)]))
        oracle = jrelay.RelayStore(backend="python")
        try:
            expect = _msgs(jproto, "a" * 16, 0, 20) + tuple(
                m for i in range(8) for m in _msgs(jproto, f"{i + 1:016x}", 100 + i * 20, 20))
            oracle.add_messages(user, expect)
            got = _pull(server.url, user)
            assert got == _jax_pull(oracle, user)
            resp = pproto.decode_sync_response(got)
            assert len(resp.messages) == len(expect) == 180  # duplicates stored once
            assert resp.merkle_tree == oracle.get_merkle_tree_string(user)
        finally:
            oracle.close()
    finally:
        server.stop()
