"""Port parity: push subscriptions (`server/push.py`, the relay's
`/push/poll`, the client's `PushSubscriber` and `connect`'s push leg)
against the JAX package's.

Every episode of `tests/test_push.py` runs on the JAX objects and on the
port's with the same inputs: the hub's poll bodies and wake sets, its
`stats_payload` (the JAX package's process-wide counters as their change
over the episode), the relay's wakeups against the changed-set oracle on
both of the port's tiers, the fleet's 307 `Location` (both fleets bound to
the same ports, so the rings agree), and the client's cursor resume and
backoff schedule with the jitter RNG seeded. Long-polls time out within a
second; every relay and hub is closed in `finally`.

Tolerance: exact everywhere."""

import json
import random
import threading
import time
import urllib.error
import urllib.request
from email.message import Message

import pytest

from _torch_push import (JAX, NODE_A, NODE_B, PORT, SUB, msgs, push_base, push_stats, server,
                         subscriptions, sync_body, ts, wait_for)
from _torch_relay_tier import free_ports


def _poll(hub, results, name, node, cursor, timeout, owner="o"):
    results[name] = json.loads(hub.poll_blocking(owner, node, cursor, timeout))


def _parked(hub, n):
    wait_for(lambda: hub.stats_payload()["subscriptions"] == n, f"{n} parked polls")


# -- the hub --


def _wake_episode(pkg):
    base = push_base()
    hub = pkg.push.PushHub()
    try:
        results, woke = {}, []
        t = threading.Thread(target=_poll, args=(hub, results, "sub", SUB, 0, 5.0))
        t.start()
        _parked(hub, 1)
        woke.append(hub.notify("o", [ts(SUB, 0)]))  # self-authored: no wake
        woke.append(hub.notify("o", [ts(NODE_A, 1)]))
        t.join(timeout=5)
        bodies = [results["sub"]]
        bodies.append(json.loads(hub.poll_blocking("o", SUB, 2, 0.1)))
        hub.notify("o", [ts(SUB, 2)])
        bodies.append(json.loads(hub.poll_blocking("o", SUB, 2, 0.1)))
        t2 = threading.Thread(target=_poll, args=(hub, results, "sub2", SUB, 3, 5.0))
        t2.start()
        _parked(hub, 1)
        woke.append(hub.notify("o", [ts(SUB, 3), ts(NODE_B, 4)]))  # mixed: wakes
        t2.join(timeout=5)
        bodies.append(results["sub2"])
        return woke, bodies, push_stats(pkg, hub.stats_payload(), base)
    finally:
        hub.close()


def test_hub_wake_and_own_write_exclusion_matches_jax():
    got, want = (_wake_episode(p) for p in (PORT, JAX))
    assert got == want
    assert got[0] == [0, 1, 1]
    assert got[1] == [{"wake": True, "cursor": 2}, {"wake": False, "cursor": 2},
                      {"wake": False, "cursor": 3}, {"wake": True, "cursor": 4}]
    assert got[2]["wakeups_total"]["write"] == 2 and got[2]["timeouts_total"] == 2


def _immediate_episode(pkg):
    base = push_base()
    hub = pkg.push.PushHub()
    try:
        out = []
        hub.notify("o", [ts(NODE_A, 0)])
        out.append(json.loads(hub.poll_blocking("o", SUB, 0, 5.0)))
        hub.notify("o", None)  # unknown authors wake even the author's node
        out.append(json.loads(hub.poll_blocking("o", NODE_A, 1, 5.0)))
        for i in range(pkg.push.EVENT_RING + 10):
            hub.notify("o", [ts(SUB, i)])  # all self-authored
        out.append(json.loads(hub.poll_blocking("o", SUB, 1, 5.0)))  # out-ringed: conservative
        return out, push_stats(pkg, hub.stats_payload(), base)
    finally:
        hub.close()


def test_hub_immediate_answers_and_stale_cursor_match_jax():
    got, want = (_immediate_episode(p) for p in (PORT, JAX))
    assert got == want
    assert [b["wake"] for b in got[0]] == [True, True, True]
    assert got[1]["wakeups_total"]["ready"] == 2 and got[1]["wakeups_total"]["stale_cursor"] == 1


def _capacity_episode(pkg):
    base = push_base()
    hub = pkg.push.PushHub(max_subscriptions=2)
    try:
        results = {}
        threads = [threading.Thread(target=_poll, args=(hub, results, o, SUB, 0, 5.0), kwargs={"owner": o})
                   for o in ("o1", "o2")]
        for t in threads:
            t.start()
        _parked(hub, 2)
        with pytest.raises(pkg.push.HubFull) as ei:
            hub.poll_blocking("o3", SUB, 0, 5.0)
        full = push_stats(pkg, hub.stats_payload(), base)
        hub.close()  # resolves both parks with wake=false
        for t in threads:
            t.join(timeout=5)
        closed = json.loads(hub.poll_blocking("o4", SUB, 7, 5.0))  # a closed hub answers at once
        return (ei.value.retry_after, full, results, closed, push_stats(pkg, hub.stats_payload(), base),
                any(t.is_alive() for t in threads))
    finally:
        hub.close()


def test_hub_capacity_and_close_match_jax():
    got, want = (_capacity_episode(p) for p in (PORT, JAX))
    assert got == want
    assert got[1]["subscriptions"] == 2 and got[1]["rejected_total"] == 1
    assert got[2] == {"o1": {"wake": False, "cursor": 0}, "o2": {"wake": False, "cursor": 0}}
    assert got[3] == {"wake": False, "cursor": 7} and got[4]["subscriptions"] == 0 and not got[5]


QUERIES = [f"owner=o&node={SUB}&cursor=3", f"owner=o&node={SUB}&cursor=0&timeout=2.5",
           f"owner=o%2Fx&node={SUB}&cursor=-4&timeout=0", f"owner=o&node={SUB}&tags=a,b,,c",
           f"owner=o&node={SUB}&tags=" + ",".join("t%d" % i for i in range(17)),
           f"owner=o&node={SUB}&tags=" + "x" * 129,
           "", "owner=o", "owner=o&node=XYZ&cursor=0", f"owner=o&node={SUB}&cursor=x",
           f"owner=o&node={SUB}&cursor=0&timeout=nan", f"owner=o&node={SUB}&cursor=0&timeout=-1",
           f"owner=o&node={'A' * 16}&cursor=0", f"owner=&node={SUB}", f"owner=o&node={SUB}&timeout=inf"]


@pytest.mark.parametrize("query", QUERIES)
def test_parse_poll_query_matches_jax(query):
    def parse(pkg):
        try:
            return pkg.push.parse_poll_query(query)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(PORT) == parse(JAX)


def _epoch_and_install_episode(pkg):
    hub = pkg.push.PushHub()
    try:
        out = []
        hub.notify("o", [ts(NODE_A, 0)])
        out.append(json.loads(hub.poll_blocking("o", SUB, 999, 5.0)))  # newer epoch: wake
        results = {}
        t = threading.Thread(target=_poll, args=(hub, results, "fresh", SUB, 999, 5.0), kwargs={"owner": "fresh"})
        t.start()
        _parked(hub, 1)
        out.append(hub.notify("fresh", [ts(NODE_A, 0)]))
        t.join(timeout=5)
        out.append(results["fresh"])
        hub.notify("known", [ts(SUB, 0)])
        cursor = json.loads(hub.poll_blocking("known", SUB, 0, 0.05))["cursor"]
        hub.notify_all()
        out.append(json.loads(hub.poll_blocking("known", SUB, cursor, 5.0)))
        first = json.loads(hub.poll_blocking("unseen", SUB, 0, 5.0))
        out += [first, json.loads(hub.poll_blocking("unseen", SUB, first["cursor"], 0.05))]
        return out
    finally:
        hub.close()


def test_cursor_epochs_and_notify_all_match_jax():
    got, want = (_epoch_and_install_episode(p) for p in (PORT, JAX))
    assert got == want
    assert got[0] == {"wake": True, "cursor": 1} and got[1] == 1
    assert got[3]["wake"] and got[4]["wake"] and not got[5]["wake"]


def _expiry_episode(pkg):
    base = push_base()
    hub = pkg.push.PushHub()
    try:
        resolved = []
        hub.on_wake = lambda token, body: resolved.append((token, json.loads(body)))
        kinds = [hub.park(f"o{i}", SUB, 0, 0.05 + i * 0.01, token=f"t{i}")[0] for i in range(50)]
        deadline = hub.next_deadline()
        hub.cancel("t3")
        hub.notify("o40", [ts(NODE_A, 0)])
        end = time.monotonic() + 10
        while len(resolved) < 49:
            hub.expire_due()
            assert time.monotonic() < end, len(resolved)
            time.sleep(0.01)
        return (kinds, deadline is not None, sorted(resolved, key=lambda r: int(r[0][1:])),
                push_stats(pkg, hub.stats_payload(), base))
    finally:
        hub.close()


def test_expiry_heap_and_cancel_match_jax():
    got, want = (_expiry_episode(p) for p in (PORT, JAX))
    assert got == want
    woken = dict(got[2])
    assert woken["t40"]["wake"] and "t3" not in woken and len(woken) == 49
    assert got[3]["timeouts_total"] == 48 and got[3]["subscriptions"] == 0


# -- wakeup == changed-set oracle, through a live relay --


def _oracle_episode(pkg, tier):
    rng = random.Random(20260804)
    base = push_base()
    srv = server(pkg, connection_tier=tier).start()
    wakes, bodies = [], []
    stop = threading.Event()

    def subscriber():
        cursor = 0
        while not stop.is_set():
            url = f"{srv.url}/push/poll?owner=ow&node={SUB}&cursor={cursor}&timeout=1.0"
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    body = json.loads(r.read())
            except Exception:  # noqa: BLE001 - the relay stopping
                return
            bodies.append(body)
            cursor = body["cursor"]
            if body["wake"]:
                wakes.append(body["cursor"])

    th = threading.Thread(target=subscriber)
    th.start()
    try:
        steps, i = [], 0
        for step in range(12):
            author = rng.choice([SUB, NODE_A, NODE_B])
            n = rng.randint(1, 4)
            wait_for(lambda: subscriptions(srv) == 1, "a parked subscriber")
            before = len(wakes)
            with urllib.request.urlopen(urllib.request.Request(
                    srv.url + "/", data=sync_body(pkg, "ow", author, msgs(pkg, author, i, n))), timeout=10) as r:
                assert r.status == 200
            i += n
            if author != SUB:
                wait_for(lambda: len(wakes) > before, f"the wake of step {step}", 5)
            else:
                time.sleep(0.1)  # a wrongful wake would show here
            steps.append((author, n, len(wakes) - before))
        wait_for(lambda: subscriptions(srv) == 1, "a parked subscriber")
        stats = json.loads(urllib.request.urlopen(srv.url + "/stats", timeout=10).read())
        return steps, wakes, push_stats(pkg, stats["push"], base), dump_rows(srv)
    finally:
        stop.set()
        srv.stop()
        th.join(timeout=5)


def dump_rows(srv):
    rows = srv.store.db.exec_sql_query('SELECT "timestamp", "content" FROM "message" ORDER BY "timestamp"', ())
    return [(r["timestamp"], bytes(r["content"])) for r in rows], srv.store.get_merkle_tree_string("ow")


def test_wakeups_match_the_changed_set_oracle_on_both_tiers_and_jax():
    """A seeded mutation schedule against a live relay: the subscriber wakes
    exactly once after every foreign-authored batch, never for its own;
    the wake cursors, `/stats` `push` sections and stores agree between the
    port's two tiers and a JAX relay."""
    want = _oracle_episode(JAX, "threaded")
    for tier in ("threaded", "eventloop"):
        assert _oracle_episode(PORT, tier) == want, tier
    steps, wakes, stats, _rows = want
    assert [w for _a, _n, w in steps] == [int(a != SUB) for a, _n, _w in steps]
    assert len(wakes) == sum(a != SUB for a, _n, _w in steps) > 0
    assert stats["subscriptions"] == 1 and stats["wakeups_total"]["write"] == len(wakes)
    assert stats["timeouts_total"] == 0


# -- fleet interplay: the subscription follows placement --


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


def _fleet_episode(pkg, ports, forward, tier):
    a = server(pkg, port=ports[0], connection_tier=tier)
    b = server(pkg, port=ports[1], connection_tier=tier)
    cfg = pkg.config.FleetConfig(relays=(a.url, b.url), replication_factor=1, forward=forward)
    a.enable_fleet(cfg)
    b.enable_fleet(cfg)
    a.start(), b.start()
    opener = urllib.request.build_opener(_NoRedirect)
    try:
        owner = next(f"own-{i}" for i in range(1000) if a.fleet.ring.placement(f"own-{i}")[0] == b.url)
        path = f"/push/poll?owner={owner}&node={SUB}&cursor=0&timeout=5"
        with pytest.raises(urllib.error.HTTPError) as ei:
            opener.open(a.url + path, timeout=10)
        redirect = (ei.value.code, ei.value.headers["Location"])
        result = {}

        def poll():
            with urllib.request.urlopen(b.url + path, timeout=15) as r:
                result["body"] = json.loads(r.read())

        th = threading.Thread(target=poll)
        th.start()
        wait_for(lambda: subscriptions(b) == 1, "the poll parked at the placed relay")
        body = sync_body(pkg, owner, NODE_A, msgs(pkg, NODE_A, 0, 2))
        if forward:
            codes = [urllib.request.urlopen(urllib.request.Request(a.url + "/", data=body), timeout=10).status]
        else:
            with pytest.raises(urllib.error.HTTPError) as ei:
                opener.open(urllib.request.Request(a.url + "/", data=body), timeout=10)
            codes = [ei.value.code,
                     urllib.request.urlopen(urllib.request.Request(b.url + "/", data=body), timeout=10).status]
        th.join(timeout=10)
        return owner, redirect, codes, result["body"], dump_rows_all(b.store), dump_rows_all(a.store)
    finally:
        a.stop(), b.stop()


def dump_rows_all(store):
    rows = store.db.exec_sql_query('SELECT "timestamp", "userId" FROM "message" ORDER BY 1, 2', ())
    return [(r["timestamp"], r["userId"]) for r in rows]


@pytest.mark.parametrize("forward", [False, True])
def test_push_poll_follows_fleet_placement_as_jax(forward):
    """A poll at a non-placed relay answers 307 naming the placed one (in
    forward mode too), and a write routed to the placed relay wakes the
    subscription parked there: same Location, codes, body and rows."""
    ports = free_ports(2)
    want = _fleet_episode(JAX, ports, forward, "eventloop")
    for tier in ("eventloop", "threaded"):
        assert _fleet_episode(PORT, ports, forward, tier) == want, tier
    owner, redirect, codes, body, placed_rows, other_rows = want
    assert redirect == (307, f"http://127.0.0.1:{ports[1]}/push/poll?owner={owner}&node={SUB}&cursor=0&timeout=5")
    assert codes == ([200] if forward else [307, 200]) and body == {"wake": True, "cursor": 1}
    assert len(placed_rows) == 2 and other_rows == []


# -- the client subscriber --


def _resume_episode(sub_pkg, relay_pkg):
    srv = server(relay_pkg, connection_tier="eventloop").start()
    woken = threading.Event()
    sub = sub_pkg.client.PushSubscriber(sub_pkg.config.Config(sync_url=srv.url), woken.set, poll_timeout_s=1.0)
    try:
        cursors = []
        sub.ensure("ow", SUB, srv.url)
        for start in (0, 10):
            wait_for(lambda: subscriptions(srv) == 1, "the subscriber's poll")
            with urllib.request.urlopen(urllib.request.Request(
                    srv.url + "/", data=sync_body(relay_pkg, "ow", NODE_A, msgs(relay_pkg, NODE_A, start, 1))),
                    timeout=10) as r:
                assert r.status == 200
            assert woken.wait(5), "push wake never fired"
            woken.clear()
            wait_for(lambda: sub.cursor == start // 10 + 1, "the adopted cursor")
            cursors.append(sub.cursor)
        return cursors, sub.wakes
    finally:
        sub.stop()
        srv.stop()


@pytest.mark.parametrize("relay", ["jax", "port"])
def test_client_subscriber_wakes_and_resumes_as_jax(relay):
    """The port's subscriber against either package's relay resumes from
    the same cursors as the JAX subscriber against the JAX relay."""
    relay_pkg = PORT if relay == "port" else JAX
    assert _resume_episode(PORT, relay_pkg) == _resume_episode(JAX, JAX) == ([1, 2], 2)


class _ScriptedStop:
    """Stands in for a subscriber's stop Event: every wait is recorded and
    returns at once; the script's end stops the loop."""

    def __init__(self, trace, limit):
        self.trace, self.limit, self._set = trace, limit, False

    def wait(self, seconds=None):
        self.trace.append(("wait", round(seconds, 12)))
        if len(self.trace) >= self.limit:
            self._set = True
        return self._set

    def is_set(self):
        return self._set

    def set(self):
        self._set = True


def _http_error(url, code, location=None, retry_after=None):
    hdrs = Message()
    if location:
        hdrs["Location"] = location
    if retry_after:
        hdrs["Retry-After"] = retry_after
    return urllib.error.HTTPError(url, code, "scripted", hdrs, None)


SCRIPT = ["offline", "offline", "offline", "offline", {"wake": True, "cursor": 7}, "307", "307",
          {"wake": False, "cursor": 7}, "307", "307:b", "503:0.25", "503", "404", b"not json",
          {"wake": True, "cursor": 2}, "429:3", "offline", {"wake": False, "cursor": 2}]


def _schedule_episode(pkg, seed):
    """The subscriber's requests, waits and wakes over SCRIPT, with the
    full-jitter RNG seeded: its whole backoff schedule."""
    trace = []
    script = iter(SCRIPT)

    def fake_get(url, timeout):
        trace.append(("get", url, timeout))
        step = next(script, None)
        if step is None:
            sub._stop.set()
            raise OSError("script over")
        if step == "offline":
            raise OSError("refused")
        if isinstance(step, bytes):
            return step
        if isinstance(step, dict):
            return json.dumps(step).encode()
        code, _, arg = step.partition(":")
        if code == "307":
            other = "http://b:1" if (arg or not url.startswith("http://b:1")) else "http://a:1"
            raise _http_error(url, 307, location=other + "/push/poll?x=1")
        raise _http_error(url, int(code), retry_after=arg or None)

    sub = pkg.client.PushSubscriber(pkg.config.Config(sync_url="http://a:1"), lambda: trace.append(("wake",)),
                                    http_get=fake_get, poll_timeout_s=0.5)
    sub._stop = _ScriptedStop(trace, 10_000)
    random.seed(seed)
    sub._owner, sub._node, sub._base = "o w", SUB, "http://a:1"
    sub._loop()
    return trace, sub.cursor, sub.wakes


@pytest.mark.parametrize("seed", [7, 20260804])
def test_client_backoff_schedule_matches_jax(seed):
    """Offline polls back off with full jitter, a 307 is followed once and
    its route cached, a second one backs off, 429/503 honour Retry-After,
    404 and a malformed body back off, cursors are adopted: the same
    requests, waits and wakes, with the jitter RNG seeded alike."""
    got, want = _schedule_episode(PORT, seed), _schedule_episode(JAX, seed)
    assert got == want
    trace, cursor, wakes = got
    assert cursor == 2 and wakes == 2
    offline = [w for (kind, *w) in trace[:9] if kind == "wait"]
    assert len(offline) == 4 and all(0.01 <= w[0] <= 0.06 for w in offline[:1])
    gets = [t[1] for t in trace if t[0] == "get"]
    assert gets[0] == "http://a:1/push/poll?owner=o%20w&node=" + SUB + "&cursor=0&timeout=0.5"
    assert any(g.startswith("http://b:1/push/poll") for g in gets)


def _connect_episode(pkg, relay_pkg):
    from importlib import import_module

    create_evolu = import_module(f"{'evolu_tpu' if pkg is JAX else 'evolu_tpu_torch'}.runtime.client").create_evolu
    table = import_module(f"{'evolu_tpu' if pkg is JAX else 'evolu_tpu_torch'}.api.query").table
    schema = {"todo": ("title", "isCompleted", "createdAt", "updatedAt", "isDeleted", "createdBy")}
    srv = server(relay_pkg, connection_tier="eventloop").start()
    cfg = pkg.config.Config(sync_url=srv.url, push_subscribe=True)
    kw = {"device": "cpu"} if pkg is PORT else {}
    a = create_evolu(schema, config=cfg, **kw)
    b = create_evolu(schema, config=cfg, mnemonic=a.owner.mnemonic, **kw)
    ta, tb = pkg.client.connect(a), pkg.client.connect(b)
    try:
        for e, t in ((a, ta), (b, tb)):
            e.sync(refresh_queries=False)
            e.worker.flush(), t.flush()
        wait_for(lambda: subscriptions(srv) == 2, "both subscribers parked")
        q = table("todo").select("title").serialize()
        a.create("todo", {"title": "pushed", "isCompleted": False})
        a.worker.flush(), ta.flush()
        rows = []
        end = time.monotonic() + 10
        while time.monotonic() < end and not rows:
            rows = b.query_once(q)
            time.sleep(0.02)
        return rows, tb.push_subscriber.wakes >= 1, ta.push_subscriber.wakes
    finally:
        a.dispose(), b.dispose(), srv.stop()


@pytest.mark.parametrize("relay", ["jax", "port"])
def test_connect_wires_push_subscribe_as_jax(relay):
    """`Config.push_subscribe`: a mutation on one handle becomes visible on
    the other through a push wake alone (no timer, no explicit sync), and
    the author's own subscriber does not wake."""
    relay_pkg = PORT if relay == "port" else JAX
    assert _connect_episode(PORT, relay_pkg) == _connect_episode(JAX, JAX) == ([{"title": "pushed"}], True, 0)


def _replication_wake_episode(pkg):
    """A relay's gossip pull that lands rows for an owner wakes the
    subscription parked there (reason "replication"), and a snapshot
    bootstrap wakes every parked subscription (reason "conservative")."""
    base = push_base()
    donor = server(pkg, peers=[]).start()
    fresh = server(pkg, peers=[], batching=True, replication_interval_s=3600).start()
    try:
        pkg.client._http_post(donor.url, sync_body(pkg, "ow", NODE_A, msgs(pkg, NODE_A, 0, 3)))
        fresh.replication.add_peer(donor.url)
        results = {}
        t = threading.Thread(target=_poll, args=(fresh.push_hub, results, "sub", SUB, 0, 5.0), kwargs={"owner": "ow"})
        t.start()
        _parked(fresh.push_hub, 1)
        fresh.replication.run_once()
        t.join(timeout=5)
        t2 = threading.Thread(target=_poll, args=(fresh.push_hub, results, "other", SUB, 0, 5.0),
                              kwargs={"owner": "x"})
        t2.start()
        _parked(fresh.push_hub, 1)
        fresh.replication.bootstrap_from(donor.url)
        t2.join(timeout=5)
        stats = push_stats(pkg, fresh.push_hub.stats_payload(), base)
        return results, stats, dump_rows(fresh)
    finally:
        fresh.stop(), donor.stop()


def test_replication_and_bootstrap_wake_as_jax():
    got, want = (_replication_wake_episode(p) for p in (PORT, JAX))
    assert got == want
    results, stats, _rows = got
    assert results["sub"] == {"wake": True, "cursor": 1} and results["other"]["wake"]
    assert stats["wakeups_total"]["replication"] == 1 and stats["wakeups_total"]["conservative"] == 1
