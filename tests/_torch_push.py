"""Shared drive for the push and connection-tier parity tests
(`test_torch_push`, `test_torch_conn_tier`).

An episode is a function of one `Pkg`: the JAX package's relay (`JAX`) or
the port's (`PORT`, every scheduler on `device="cpu"`). Each test runs the
same episode on both and demands equal results. Messages are made from
plain timestamp strings, so both packages see the same bytes. The JAX
package counts push and connection events in its process-wide metrics
registry; `push_stats` reads a JAX hub's `/stats` section as the change
since `push_base()`, which is what the port's per-hub counts hold.
"""

import contextlib
import re
import socket
import time
import types

import evolu_tpu.obs.metrics as jmetrics
import evolu_tpu.server.conn as jconn
import evolu_tpu.server.push as jpush
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.replicate as jrep
import evolu_tpu.sync.client as jclient
import evolu_tpu.sync.protocol as jproto
import evolu_tpu.utils.config as jconfig
import evolu_tpu_torch.server.conn as pconn
import evolu_tpu_torch.server.push as ppush
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.replicate as prep
import evolu_tpu_torch.sync.client as pclient
import evolu_tpu_torch.sync.protocol as pproto
import evolu_tpu_torch.utils.config as pconfig
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp

BASE = 1_730_000_000_000
NODE_A = "a" * 16
NODE_B = "b" * 16
SUB = "5" * 16  # the subscriber's node
FRESH = "f" * 16

JAX = types.SimpleNamespace(name="jax", relay=jrelay, push=jpush, conn=jconn, rep=jrep, client=jclient,
                            proto=jproto, config=jconfig, extra={})
PORT = types.SimpleNamespace(name="port", relay=prelay, push=ppush, conn=pconn, rep=prep, client=pclient,
                             proto=pproto, config=pconfig, extra={"device": "cpu"})


def server(pkg, store=None, **kw):
    """The package's RelayServer on a native store; the port's schedulers
    run on the CPU."""
    return pkg.relay.RelayServer(store or pkg.relay.RelayStore(backend="native"), **kw, **pkg.extra)


def ts(node: str, i: int) -> str:
    return timestamp_to_string(Timestamp(BASE + i * 1000, 0, node))


def msgs(pkg, node: str, start: int, n: int):
    return tuple(pkg.proto.EncryptedCrdtMessage(ts(node, start + i), b"c%d" % (start + i)) for i in range(n))


def sync_body(pkg, owner, node, messages, tree="{}") -> bytes:
    return pkg.proto.encode_sync_request(pkg.proto.SyncRequest(messages, owner, node, tree))


def raw_request(method: str, path: str, body: bytes = b"", headers=()) -> bytes:
    lines = [f"{method} {path} HTTP/1.0", "Content-Length: " + str(len(body))]
    lines += [f"{k}: {v}" for k, v in headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def exchange(addr, raw: bytes, timeout: float = 30.0) -> bytes:
    """Send one raw request, read the FULL raw response to EOF."""
    with socket.create_connection(addr, timeout=timeout) as s:
        s.sendall(raw)
        out = bytearray()
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return bytes(out)
            out += chunk


_DATE_RE = re.compile(rb"\r\nDate: [^\r\n]*")


def normalize(resp: bytes) -> bytes:
    """Drop the only legitimately nondeterministic header."""
    return _DATE_RE.sub(b"\r\nDate: -", resp)


def dump_store(store):
    rows = store.db.exec_sql_query(
        'SELECT "timestamp", "userId", "content" FROM "message" ORDER BY "userId", "timestamp"', ())
    trees = store.db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY "userId"', ())
    return ([(r["timestamp"], r["userId"], bytes(r["content"])) for r in rows],
            [(r["userId"], r["merkleTree"]) for r in trees])


def addr(srv):
    return srv._httpd.server_address[:2]


_JAX_COUNTERS = (
    [("wakeups_total", r, "evolu_push_wakeups_total", {"reason": r}) for r in ppush.WAKE_REASONS]
    + [("timeouts_total", None, "evolu_push_timeouts_total", {}),
       ("rejected_total", None, "evolu_push_rejected_total", {})])


def push_base():
    """The JAX registry's push counters now (what `push_stats` subtracts)."""
    return {(k, r): jmetrics.get_counter(name, **labels) for k, r, name, labels in _JAX_COUNTERS}


def push_stats(pkg, stats: dict, base=None) -> dict:
    """A hub's `stats_payload()` (or `/stats` `push` section) with the JAX
    package's process-wide counters taken as their change since `base`."""
    if pkg is PORT:
        return stats
    out = {**stats, "wakeups_total": dict(stats["wakeups_total"])}
    for k, r, _name, _labels in _JAX_COUNTERS:
        if r is None:
            out[k] -= base[(k, r)]
        else:
            out[k][r] -= base[(k, r)]
    return out


@contextlib.contextmanager
def config(pkg, **fields):
    """The package's process `default_config` with `fields` set, restored
    after."""
    old = pkg.config.default_config
    pkg.config.set_config(pkg.config.Config(**fields))
    try:
        yield
    finally:
        pkg.config.set_config(old)


def wait_for(pred, what, deadline_s=10.0):
    """Poll `pred` until true (its own timeout, no fixed sleep)."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def subscriptions(srv) -> int:
    return srv.push_hub.stats_payload()["subscriptions"]
