"""Shared drive for the relay-tier parity tests (`test_torch_replication`,
`test_torch_snapshot`, `test_torch_fleet`).

An episode is a function of one `Pkg`: the JAX package's relay tier
(`JAX`) or the port's (`PORT`, every scheduler on `device="cpu"`). Each
test runs the same episode on both and demands that they end in the same
tree strings and rows, byte for byte. Messages are made from plain
timestamp strings, so both packages see the same bytes. A relay set can
bind fixed ports (`free_ports`), so the URLs, and with them a fleet's
placement ring, are the same in both runs.
"""

import dataclasses
import functools
import random
import socket
import time
import types

import evolu_tpu.obs.metrics as jmetrics
import evolu_tpu.server.fleet as jfleet
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.replicate as jrep
import evolu_tpu.server.snapshot as jsnap
import evolu_tpu.sync.client as jclient
import evolu_tpu.sync.protocol as jproto
import evolu_tpu.utils.config as jconfig
import evolu_tpu_torch.server.fleet as pfleet
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.replicate as prep
import evolu_tpu_torch.server.snapshot as psnap
import evolu_tpu_torch.sync.client as pclient
import evolu_tpu_torch.sync.protocol as pproto
import evolu_tpu_torch.utils.config as pconfig
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp

BASE = 1_700_000_000_000
MINUTE = 60_000
LIMIT_S = 60


def _jax_rounds_ok(mgr, url):
    return jmetrics.get_counter("evolu_repl_rounds_total", result="ok", replica=mgr.replica_id,
                                peer=url.rstrip("/"))


def _port_rounds_ok(mgr, url):
    return mgr.peer_counts.get(url.rstrip("/"), {}).get("rounds_ok", 0)


JAX = types.SimpleNamespace(
    name="jax", relay=jrelay, rep=jrep, snap=jsnap, fleet=jfleet, proto=jproto, config=jconfig,
    http_post=jclient._http_post, extra={}, rounds_ok=_jax_rounds_ok)
PORT = types.SimpleNamespace(
    name="port", relay=prelay, rep=prep, snap=psnap, fleet=pfleet, proto=pproto, config=pconfig,
    http_post=pclient._http_post, extra={"device": "cpu"}, rounds_ok=_port_rounds_ok)
PKGS = (JAX, PORT)


def fast_post(pkg):
    return functools.partial(pkg.http_post, retries=0)


def server(pkg, store=None, **kw):
    """The package's RelayServer; the port's schedulers run on the CPU."""
    return pkg.relay.RelayServer(store, **kw, **pkg.extra)


def store(pkg, shards=1, path=":memory:"):
    if shards > 1:
        return pkg.relay.ShardedRelayStore(path, backend="native", shards=shards)
    return pkg.relay.RelayStore(path, backend="native")


def stamps(node, minute, start, n, step=500):
    return [timestamp_to_string(Timestamp(BASE + minute * MINUTE + (start + i) * step, 0, node))
            for i in range(n)]


def msgs(pkg, node, minute, start, n, payload=b""):
    """`n` messages of `node` inside wall-clock minute `minute`."""
    return tuple(pkg.proto.EncryptedCrdtMessage(t, b"ct\x00-%d-%d" % (minute, start + i) + payload)
                 for i, t in enumerate(stamps(node, minute, start, n)))


def write(pkg, url, user, node, messages):
    pkg.http_post(url, pkg.proto.encode_sync_request(pkg.proto.SyncRequest(messages, user, node, "{}")))


def seed(pkg, st, owners, per_minute, minutes, payload=b""):
    for i in range(owners):
        node = f"{i + 1:016x}"
        for m in range(minutes):
            st.add_messages(f"owner{i:03d}", msgs(pkg, node, m, 0, per_minute, payload))


def state(st):
    """Per owner, the stored tree text and every (timestamp, content) row,
    as plain values comparable across the packages."""
    return {u: (st.get_merkle_tree_string(u),
                tuple((m.timestamp, bytes(m.content)) for m in st.replica_messages(u, "")))
            for u in sorted(st.user_ids())}


def wait_for(pred, what, deadline_s=20.0):
    """Poll `pred` until true (its own timeout, no fixed sleep)."""
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def wait_converged(stores, owners, deadline_s=20.0):
    out = {}

    def ok():
        states = [state(s) for s in stores]
        out["s"] = states[0]
        return set(states[0]) == set(owners) and all(s == states[0] for s in states[1:])

    wait_for(ok, f"convergence on {sorted(owners)}", deadline_s)
    return out["s"]


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def stop_all(servers):
    for s in servers:
        if s is not None:
            s.stop()


def decode_both(name, data):
    """Both packages' decoder on `data`: → the decoded value as plain
    tuples, or "ValueError"; any other exception propagates."""
    out = []
    for pkg in PKGS:
        try:
            out.append(dataclasses.astuple(getattr(pkg.proto, name)(data)))
        except ValueError:
            out.append("ValueError")
    return out


def hostile_cases(valid, seed_, step):
    rng = random.Random(seed_)
    cases = [b"\xff", b"\x08", b"\x0a\x05ab", b"\x08\x01", b"\x0d\x01\x02\x03\x04", b"\x0a\x02\x08\x01",
             b"\x22\x02\x08\x01"]
    for blob in valid:
        cases.extend(blob[:k] for k in range(1, len(blob), step))
        for _ in range(40):
            b = bytearray(blob)
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            cases.append(bytes(b))
        cases.extend(bytes(rng.randrange(256) for _ in range(n)) for n in (3, 17, 64))
    return cases + list(valid)
