"""Port parity: the sync transport and its end-to-end encryption
(`sync.protocol.decode_content`, `sync.crypto`, `sync.aead`,
`sync.client`) against the JAX package's.

- `decode_content` round trips with the JAX codec both ways and raises
  the same error types on malformed bytes.
- OpenPGP: each package decrypts the other's ciphertext; with
  `os.urandom` seeded alike the ciphertexts are byte-identical; the
  GnuPG fixtures decrypt; tamper and wrong passwords raise PgpError
  with the JAX package's messages.
- aead-batch-v1 records: the same, both ways.
- Clients converge: a port client and a JAX client through the port's
  relay (an injected `http_post` into `BatchReconciler.run_batch_wire`),
  and through the JAX `RelayServer` on localhost, where v2 is
  negotiated and then downgraded on a fleet failover.
- `_http_post`'s backoff on 503 and 429 and the transport's offline
  state and reconnect probe, each against the JAX transport.

Tolerance: exact everywhere. Every threaded test runs inside its own
time limit (`within`)."""

import email.message
import os
import pathlib
import random
import threading
import urllib.error
import urllib.request

import pytest

import evolu_tpu.core.types as jt
import evolu_tpu.sync.aead as jaead
import evolu_tpu.sync.client as jclient
import evolu_tpu.sync.crypto as jcrypto
import evolu_tpu.sync.protocol as jproto
from evolu_tpu.runtime.messages import SyncRequestInput as JRequest

import evolu_tpu_torch.core.types as pt
import evolu_tpu_torch.sync.aead as paead
import evolu_tpu_torch.sync.client as pclient
import evolu_tpu_torch.sync.crypto as pcrypto
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.runtime.messages import SyncRequestInput as PRequest

from _torch_port_data import within

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
TS = "2023-11-14T22:13:20.000Z-0000-0f1e2d3c4b5a6978"
LIMIT_S = 120
VALUES = [None, "", "text ✓ café", 0, 1, -1, 2**31 - 1, -(2**31), 2**31, -(2**31) - 1, 2**62,
          -(2**63), 2**63 - 1, 0.5, -2.25, 1e300, float("inf"), True, False]


@pytest.mark.parametrize("value", VALUES, ids=[repr(v) for v in VALUES])
def test_decode_content_round_trips_with_jax(value):
    for enc, dec in ((jproto.encode_content, pproto.decode_content),
                     (pproto.encode_content, jproto.decode_content),
                     (pproto.encode_content, pproto.decode_content)):
        data = enc("todo", "row ✓", "title", value)
        assert data == jproto.encode_content("todo", "row ✓", "title", value)
        got, want = dec(data), jproto.decode_content(data)
        assert got == want and type(got[3]) is type(want[3])


def test_decode_content_errors_match_jax():
    rng = random.Random(7)
    base = jproto.encode_content("todo", "r", "c", "value")
    cases = [b"\x0a", b"\x0a\x05ab", b"\xff" * 11, b"\x22\x02\xff\xfe", b"\x2d\x00", b"\x31\x00\x00"]
    for _ in range(300):
        b = bytearray(base)
        for _ in range(rng.randint(1, 3)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        cases.append(bytes(b[: rng.randint(0, len(b))]))
    for data in cases:
        outcomes = []
        for dec in (jproto.decode_content, pproto.decode_content):
            try:
                outcomes.append(("ok", dec(data)))
            except Exception as e:  # noqa: BLE001 - the error type is the outcome
                outcomes.append(("raises", type(e)))
        assert outcomes[1] == outcomes[0], data
        assert outcomes[0][0] == "ok" or issubclass(outcomes[0][1], ValueError)


def _seeded(seed):
    rng = random.Random(seed)
    return lambda n: bytes(rng.getrandbits(8) for _ in range(n))


@pytest.mark.parametrize("payload", [b"", b"x", b"\x00\x01" * 10000,
                                     jproto.encode_content("todo", "r", "title", "Buy milk")],
                         ids=["empty", "one", "20k", "content"])
def test_openpgp_interoperates_both_ways_and_byte_for_byte(payload, monkeypatch):
    for enc, dec in ((pcrypto.encrypt_symmetric, jcrypto.decrypt_symmetric),
                     (jcrypto.encrypt_symmetric, pcrypto.decrypt_symmetric)):
        assert dec(enc(payload, MNEMONIC), MNEMONIC) == payload
    cts = []
    for mod in (jcrypto, pcrypto):
        monkeypatch.setattr(os, "urandom", _seeded(11))
        cts.append(mod.encrypt_symmetric(payload, MNEMONIC))
    assert cts[0] == cts[1]


@pytest.mark.parametrize("name", ["gpg_aes256_s2k1024_none.pgp", "gpg_aes256_s2k1024_zip.pgp",
                                  "gpg_aes256_s2k1024_zlib.pgp"])
def test_gnupg_fixtures_decrypt(name):
    password = (FIXTURES / "gpg_password.txt").read_text().strip()
    plaintext = (FIXTURES / "gpg_plaintext.bin").read_bytes()
    assert pcrypto.decrypt_symmetric((FIXTURES / name).read_bytes(), password) == plaintext
    assert pproto.decode_content(plaintext) == jproto.decode_content(plaintext)


def _pgp_outcome(mod, data, password):
    try:
        return ("ok", mod.decrypt_symmetric(data, password))
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return (type(e).__name__, str(e))


def test_tamper_and_wrong_password_match_jax():
    ct = jcrypto.encrypt_symmetric(b"payload", MNEMONIC)
    cases = [(ct, "wrong password")]
    for i in range(len(ct)):
        b = bytearray(ct)
        b[i] ^= 0xFF
        cases.append((bytes(b), MNEMONIC))
    cases += [(ct[:n], MNEMONIC) for n in range(0, len(ct), 7)]
    seen = set()
    for data, pw in cases:
        want = _pgp_outcome(jcrypto, data, pw)
        assert _pgp_outcome(pcrypto, data, pw) == want
        seen.add(want[1].split(" (")[0] if want[0] == "PgpError" else want[0])
    assert {"MDC integrity check failed", "session key check failed"} <= {s.split(" (")[0] for s in seen} | seen
    assert issubclass(pcrypto.PgpError, ValueError)


def test_aead_records_interoperate_and_match_byte_for_byte(monkeypatch):
    content = jproto.encode_content("todo", "r", "title", "v2 ✓")
    for a, b in ((paead, jaead), (jaead, paead)):
        a.reset_sessions()
        s = a.get_session(MNEMONIC, records=1)
        rec = a.encrypt_record(s.key, s.salt, content)
        assert b.is_v2_record(rec) and b.decrypt_record(rec, MNEMONIC) == content
        assert b.decrypt_content(rec, MNEMONIC) == content
    assert paead.decrypt_content(jcrypto.encrypt_symmetric(content, MNEMONIC), MNEMONIC) == content
    recs = []
    for mod in (jaead, paead):
        mod.reset_sessions()
        monkeypatch.setattr(os, "urandom", _seeded(5))
        s = mod.get_session(MNEMONIC, records=2)
        recs.append(mod.encrypt_record(s.key, s.salt, content))
    assert recs[0] == recs[1]
    assert paead.hkdf_sha256(b"secret", b"salt" * 4) == jaead.hkdf_sha256(b"secret", b"salt" * 4)
    assert (paead.MAGIC, paead.RECORD_OVERHEAD, paead.SESSION_RECORD_LIMIT) == \
        (jaead.MAGIC, jaead.RECORD_OVERHEAD, jaead.SESSION_RECORD_LIMIT)


def test_aead_errors_and_rotation_match_jax():
    content = b"payload"
    jaead.reset_sessions()
    s = jaead.get_session(MNEMONIC)
    rec = jaead.encrypt_record(s.key, s.salt, content)
    cases = [(rec, "wrong"), (rec[:20], MNEMONIC), (b"not v2", MNEMONIC)]
    for i in range(len(rec)):
        b = bytearray(rec)
        b[i] ^= 0x01
        cases.append((bytes(b), MNEMONIC))
    before = paead.counts["auth_failures"]
    for data, pw in cases:
        out = []
        for mod in (jaead, paead):
            try:
                out.append(("ok", mod.decrypt_record(data, pw)))
            except Exception as e:  # noqa: BLE001
                out.append((type(e).__name__, str(e)))
        assert out[1] == out[0]
    assert paead.counts["auth_failures"] > before
    # A session that would cross the record bound is retired for a fresh salt.
    paead.reset_sessions()
    first = paead.get_session(MNEMONIC, records=paead.SESSION_RECORD_LIMIT)
    assert paead.get_session(MNEMONIC, records=0) is first
    second = paead.get_session(MNEMONIC, records=1)
    assert second is not first and second.salt != first.salt and second.used == 1


def _jax_messages():
    return [jt.CrdtMessage(f"2023-11-14T22:13:20.{i:03d}Z-0000-0f1e2d3c4b5a6978", "todo", f"r{i}", "title",
                           v) for i, v in enumerate(["a", 7, 2.5, None, -(2**40)])]


def test_message_pipelines_interoperate():
    jm = _jax_messages()
    pm = [pt.CrdtMessage(*(getattr(m, f) for f in ("timestamp", "table", "row", "column", "value"))) for m in jm]
    for enc, dec, src in ((pclient.encrypt_messages, jclient.decrypt_messages, pm),
                          (pclient.encrypt_messages_v2, jclient.decrypt_messages, pm),
                          (jclient.encrypt_messages, pclient.decrypt_messages, jm),
                          (jclient.encrypt_messages_v2, pclient.decrypt_messages, jm)):
        out = dec(enc(src, MNEMONIC), MNEMONIC)
        assert [tuple(vars(m).values()) for m in out] == [tuple(vars(m).values()) for m in jm]
    # The first failing message raises, as the JAX pure loop does.
    enc = list(jclient.encrypt_messages(jm, MNEMONIC))
    enc[3] = jproto.EncryptedCrdtMessage(enc[3].timestamp, enc[3].content[:-3])
    enc[4] = jproto.EncryptedCrdtMessage(enc[4].timestamp, b"\x45\x32\x01short")
    penc = [pproto.EncryptedCrdtMessage(e.timestamp, e.content) for e in enc]
    errs = []
    for fn, arg in ((jclient.decrypt_messages, enc), (pclient.decrypt_messages, penc)):
        with pytest.raises(ValueError) as e:
            fn(arg, MNEMONIC)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[1] == errs[0]
    with pytest.raises(TypeError):
        pclient.encrypt_messages([pt.CrdtMessage(TS, "t", "r", "c", b"bytes")], MNEMONIC)


# --- clients converging ---

SCHEMA = {"todo": ("title", "isCompleted")}


def _pair_through(post, jax_cfg, port_cfg, rounds=4):
    """A JAX client and a port client (one mnemonic) exchanging through
    `post`, each writing, then pulling until both hold the same rows."""
    from evolu_tpu.runtime.client import create_evolu as jcreate
    from evolu_tpu_torch.runtime.client import create_evolu as pcreate

    j = jcreate(SCHEMA, config=jax_cfg)
    p = pcreate(SCHEMA, config=port_cfg, mnemonic=j.owner.mnemonic, device="cpu")
    try:
        tj = jclient.SyncTransport(jax_cfg, on_receive=j.receive, sync_lock=j.worker.sync_lock, http_post=post)
        tp = pclient.SyncTransport(port_cfg, on_receive=p.receive, sync_lock=p.worker.sync_lock, http_post=post)
        j.attach_transport(tj)
        p.attach_transport(tp)
        with j.batching():
            for i in range(40):
                j.create("todo", {"title": f"j{i}", "isCompleted": i % 2 == 0})
        with p.batching():
            for i in range(40):
                p.create("todo", {"title": f"p{i}", "isCompleted": 1.5 if i % 3 else None})
        for _ in range(rounds):
            for c, t in ((j, tj), (p, tp)):
                c.sync()
                c.worker.flush(); t.flush(); c.worker.flush()
        from evolu_tpu.core.merkle import merkle_tree_to_string
        from evolu_tpu.storage.clock import read_clock

        q = 'SELECT "id", "title", "isCompleted" FROM "todo" ORDER BY "id"'
        dump = 'SELECT * FROM "__message" ORDER BY "timestamp"'
        trees = [merkle_tree_to_string(read_clock(c.db).merkle_tree) for c in (j, p)]
        return (j.query_once(q), p.query_once(q), j.db.exec(dump), p.db.exec(dump), tp.counts,
                j.get_error(), p.get_error(), j.owner.id, trees)
    finally:
        j.dispose()
        p.dispose()


def test_port_and_jax_clients_converge_through_the_port_relay():
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.utils.config import Config

    store = RelayStore(backend="python")
    engine = BatchReconciler(store, device="cpu")
    lock = threading.Lock()

    def post(url, body):
        with lock:
            return engine.run_batch_wire([pproto.decode_sync_request(body)])[0]

    from evolu_tpu.utils.config import Config as JConfig

    rj, rp, mj, mp, counts, ej, ep, owner, trees = within(LIMIT_S, lambda: _pair_through(
        post, JConfig(), Config(backend="cuda")))
    assert ej is None and ep is None
    assert rj == rp and len(rj) == 80
    assert mj == mp and len(mj) == 80 * 4  # title, isCompleted, createdAt, createdBy
    assert counts["requests"] >= 4 and counts["response_messages"] >= 160
    # The port relay echoes no capabilities: the wire stays v1.
    assert counts.get("v2_push_legs", 0) == 0 and counts["v1_fallback_not_negotiated"] >= 1
    assert trees[0] == trees[1] == store.get_merkle_tree_string(owner) != merkle_tree_to_string({})


def _fleet_round_trip(evolu, tr):
    evolu.worker.flush(); tr.flush(); evolu.worker.flush()


def _v2_then_failover():
    """The JAX relay echoes capabilities: a port client negotiates v2,
    then fails over to a v1 replica and re-emits the round as v1; a JAX
    client converges with it through the current relay."""
    from evolu_tpu.runtime.client import create_evolu as jcreate
    from evolu_tpu.server.relay import RelayServer, RelayStore
    from evolu_tpu.utils.config import Config as JConfig
    from evolu_tpu.utils.config import FleetConfig
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.utils.config import Config

    def stored(server):
        return [bytes(r["content"]) for r in server.store.db.exec_sql_query('SELECT content FROM "message"')]

    a = RelayServer(RelayStore(), peers=[], replication_interval_s=30).start()
    b = RelayServer(RelayStore(), capabilities=(), peers=[], replication_interval_s=30).start()
    cfg = FleetConfig(relays=(a.url, b.url), replication_factor=2, version=1)
    a.enable_fleet(cfg)
    b.enable_fleet(cfg)
    evolu = other = None
    obs = {}
    try:
        evolu = create_evolu(SCHEMA, config=Config(sync_url=b.url, backend="cuda"), device="cpu")
        tr = pclient.connect(evolu)
        owner = evolu.owner.id
        tr._routes[owner] = a.url + "/"
        evolu.create("todo", {"title": "r1", "isCompleted": False})
        _fleet_round_trip(evolu, tr)
        obs["negotiated"] = pproto.CAP_AEAD_BATCH in tr.negotiated_capabilities[a.url + "/"]
        obs["round 1 v2"] = any(jaead.is_v2_record(c) for c in stored(a))
        evolu.create("todo", {"title": "r2", "isCompleted": False})
        _fleet_round_trip(evolu, tr)
        obs["round 2 v2"] = any(jaead.is_v2_record(c) for c in stored(a))
        # A JAX client on relay A decrypts the mixed v1 + v2 log.
        other = jcreate(SCHEMA, config=JConfig(sync_url=a.url + "/"), mnemonic=evolu.owner.mnemonic)
        jtr = jclient.connect(other)
        for _ in range(4):
            other.sync(refresh_queries=False)
            _fleet_round_trip(other, jtr)
        obs["jax rows"] = other.query_once('SELECT "title" FROM "todo" ORDER BY "title"')
        # rf=2: A also replicates its log to B, byte for byte, v2 records
        # included. What the client itself sent to B is what A never held.
        held_by_a = set(stored(a))
        a.stop()
        errors = []
        evolu.subscribe_error(errors.append)
        evolu.create("todo", {"title": "r3", "isCompleted": False})
        _fleet_round_trip(evolu, tr)
        obs["errors"] = errors
        obs["dropped"] = a.url + "/" not in tr.negotiated_capabilities
        contents = [c for c in stored(b) if c not in held_by_a]
        obs["b got the round"] = bool(contents)
        obs["b v2"] = any(jaead.is_v2_record(c) for c in contents)
        obs["counts"] = dict(tr.counts)
        for _ in range(3):
            evolu.sync(refresh_queries=False)
            _fleet_round_trip(evolu, tr)
        obs["port rows"] = evolu.query_once('SELECT "title" FROM "todo" ORDER BY "title"')
    finally:
        for c in (evolu, other):
            if c is not None:
                c.dispose()
        b.stop()
        try:
            a.stop()
        except Exception:  # noqa: BLE001,S110 - already stopped above
            pass
    return obs


def test_v2_negotiated_then_downgraded_on_failover_through_the_jax_relay():
    obs = within(LIMIT_S, _v2_then_failover)
    assert obs["negotiated"] and not obs["round 1 v2"] and obs["round 2 v2"]
    assert obs["jax rows"] == [{"title": "r1"}, {"title": "r2"}]
    assert obs["errors"] == [] and obs["dropped"]
    assert obs["b got the round"] and not obs["b v2"], "v2 record sent to a relay that never advertised it"
    c = obs["counts"]
    assert c["v1_fallback_failover"] == 1 and c["v2_push_legs"] == 1 and c["route_invalidations"] == 1
    assert c["capability_invalidations"] == 1
    assert obs["port rows"] == [{"title": "r1"}, {"title": "r2"}, {"title": "r3"}]


# --- backoff, offline and reconnect ---


class _Response:
    def __init__(self, body):
        self._body = body

    def read(self):
        return self._body

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _http_error(code, headers):
    msg = email.message.Message()
    for k, v in headers.items():
        msg[k] = v
    return urllib.error.HTTPError("http://x/", code, "err", msg, None)


def _script(steps):
    """A urlopen that plays `steps` (an exception or response bytes each)."""
    it = iter(steps)

    def urlopen(req, timeout=None):
        step = next(it)
        if isinstance(step, Exception):
            raise step
        return _Response(step)

    return urlopen


BACKOFF = {
    "503 with Retry-After": ([_http_error(503, {"Retry-After": "2"}), b"pong"], {}),
    "429 jittered": ([_http_error(429, {}), _http_error(429, {"Retry-After": "x"}), b"ok"], {"base_delay": 0.1}),
    "503 until the retries are spent": ([_http_error(503, {})] * 4, {"base_delay": 0.1}),
    "Retry-After above the cap": ([_http_error(503, {"Retry-After": "60"}), b"ok"], {}),
    "connection errors": ([urllib.error.URLError(OSError("refused"))] * 2 + [b"ok"], {}),
    "connection down": ([urllib.error.URLError(OSError("down"))] * 3, {"retries": 2}),
    "404 is not retried": ([_http_error(404, {})], {}),
}


@pytest.mark.parametrize("case", list(BACKOFF))
def test_http_post_backoff_matches_jax(case, monkeypatch):
    steps, kw = BACKOFF[case]
    out = []
    for mod in (jclient, pclient):
        monkeypatch.setattr(urllib.request, "urlopen", _script(steps))
        slept = []
        try:
            got = ("ok", mod._http_post("http://x/", b"b", sleep=slept.append, rng=lambda: 0.5, **kw))
        except Exception as e:  # noqa: BLE001 - the error is the outcome
            got = (type(e).__name__, getattr(e, "code", None))
        out.append((got, slept))
    assert out[1] == out[0]


def test_transport_http_errors_match_jax():
    """A 503 that outlasts the backoff is a real error (on_error); a
    refused connection is the offline state, not an error."""
    from evolu_tpu.utils.config import Config as JConfig
    from evolu_tpu_torch.utils.config import Config

    def post_503(url, body):
        raise urllib.error.HTTPError(url, 503, "busy", {}, None)

    def post_offline(url, body):
        raise OSError("refused")

    for post in (post_503, post_offline):
        got = []
        for tmod, cfg, req in ((jclient, JConfig(reconnect_probe_interval=None),
                                JRequest((), TS, "{}", jt.Owner("o", MNEMONIC))),
                               (pclient, Config(reconnect_probe_interval=None),
                                PRequest((), TS, "{}", pt.Owner("o", MNEMONIC)))):
            errors = []
            t = tmod.SyncTransport(cfg, on_receive=lambda *a: None, on_error=errors.append, http_post=post)
            within(LIMIT_S, lambda: (t.request_sync(req), t.flush(), t.stop()))
            got.append([(type(e).__name__, str(e)) for e in errors])
            if tmod is pclient:
                assert t.counts.get("http_errors", 0) + t.counts.get("offline_rounds", 0) == 1
        assert got[1] == got[0]


def _offline_then_back(tmod, cfg, req):
    """Rounds fail offline; the probe fails once, then succeeds: the
    reconnect hook fires once and the next round goes through."""
    events, up = [], threading.Event()

    def post(url, body):
        if not up.is_set():
            raise OSError("offline")
        events.append("post")
        return jproto.encode_sync_response(jproto.SyncResponse((), "{}"))

    probes = []

    def probe(url):
        probes.append(url)
        if len(probes) == 1:
            raise OSError("still down")
        up.set()

    fired = threading.Event()
    t = tmod.SyncTransport(cfg, on_receive=lambda *a: events.append("receive"), http_post=post,
                           http_probe=probe, on_reconnect=lambda: (events.append("reconnect"), fired.set()))
    try:
        t.request_sync(req)
        t.flush()
        events.append(("offline", t._offline))
        assert fired.wait(30)
        t.request_sync(req)
        t.flush()
        events.append(("offline", t._offline))
    finally:
        t.stop()
    return events, probes[0], len(probes)


def test_offline_then_reconnect_probe_matches_jax():
    from evolu_tpu.utils.config import Config as JConfig
    from evolu_tpu_torch.utils.config import Config

    got = []
    for tmod, cfg, req in ((jclient, JConfig(reconnect_probe_interval=0.01, sync_url="http://relay:4000/x"),
                            JRequest((), TS, "{}", jt.Owner("o", MNEMONIC))),
                           (pclient, Config(reconnect_probe_interval=0.01, sync_url="http://relay:4000/x"),
                            PRequest((), TS, "{}", pt.Owner("o", MNEMONIC)))):
        got.append(within(LIMIT_S, lambda: _offline_then_back(tmod, cfg, req)))
    assert got[1] == got[0]
    events, url, n = got[1]
    assert events == [("offline", True), "reconnect", "post", "receive", ("offline", False)]
    assert url == "http://relay:4000/ping" and n == 2


def test_reconnect_hook_skips_a_disposed_client():
    """connect's reconnect hook fires the client's listeners and a pull,
    except after dispose (the straggler-probe window)."""
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.utils.config import Config

    def run():
        e = create_evolu(SCHEMA, config=Config(backend="cpu", reconnect_probe_interval=None), device="cpu")
        t = pclient.connect(e)

        def down(url, body):
            raise OSError("down")

        t._http_post = down
        seen = []
        e.subscribe_reconnect(lambda: seen.append("listener"))
        e.subscribe_reconnect(lambda: 1 / 0)  # a raising listener does not block the pull
        t.on_reconnect()
        e.worker.flush(); t.flush()
        first = (list(seen), t.counts.get("offline_rounds", 0))
        e.dispose()
        t.on_reconnect()
        return first, list(seen)

    (seen, offline), after = within(LIMIT_S, run)
    assert seen == ["listener"] and offline == 1 and after == ["listener"]


def test_unported_routes_raise_before_any_side_effect():
    """The scope clause is refused before any thread starts; nothing
    reaches the transport or the relay. The push leg, ported, is accepted:
    `connect` attaches a `PushSubscriber` whose thread starts only when a
    successful round binds it."""
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.utils.config import Config

    e = create_evolu(SCHEMA, config=Config(backend="cpu"), device="cpu")
    try:
        threads = threading.active_count()
        with pytest.raises(NotImplementedError, match="scoped-sync"):
            pclient.SyncTransport(Config(sync_scope=object()), on_receive=lambda *a: None)
        assert threading.active_count() == threads and e._transport is None
        t = pclient.connect(e, Config(push_subscribe=True, sync_url="http://127.0.0.1:9"))
        assert isinstance(t.push_subscriber, pclient.PushSubscriber)
        assert t.push_subscriber._thread is None and e._transport is t
    finally:
        e.dispose()
