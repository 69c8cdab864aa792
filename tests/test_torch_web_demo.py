"""Port twin of `tests/test_web_demo.py`: the port's web demo
(`evolu_tpu_torch.examples.web_todo`) driven over its JSON API on the
CPU — CRUD with soft-delete and categories, long-poll reactivity, owner
reset, and two demo instances converging through a live port relay. The
same episodes and assertions as the JAX test
(`test_web_demo_crud_longpoll_and_reset`,
`test_two_demos_converge_through_relay`); tolerance: exact."""

import json
import threading
import time
import urllib.request

from evolu_tpu_torch.examples.web_todo import DemoApp, DemoServer
from evolu_tpu_torch.server.relay import RelayServer


def _api(base, path, body=None):
    if body is None:
        r = urllib.request.urlopen(base + path, timeout=30)
    else:
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"content-type": "application/json"},
        )
        r = urllib.request.urlopen(req, timeout=30)
    return json.loads(r.read())


def test_port_web_demo_crud_longpoll_and_reset():
    server = DemoServer(DemoApp(device="cpu")).start()
    base = server.url
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "TodoMVC" in page
        cat = _api(base, "/api/mutate", {"table": "todoCategory", "values": {"name": "home"}})["id"]
        t1 = _api(base, "/api/mutate", {"table": "todo",
                  "values": {"title": "Buy milk", "isCompleted": False, "categoryId": cat}})["id"]
        s1 = _api(base, "/api/state?since=-1")
        assert [t["title"] for t in s1["todos"]] == ["Buy milk"]
        assert s1["todos"][0]["categoryId"] == cat
        assert s1["owner"]["mnemonic"]

        # Long-poll wakes on mutation (the reactive-store contract).
        got = {}
        th = threading.Thread(
            target=lambda: got.update(_api(base, f"/api/state?since={s1['version']}"))
        )
        th.start()
        time.sleep(0.3)
        _api(base, "/api/mutate", {"table": "todo", "values": {"id": t1, "isCompleted": True}})
        th.join(timeout=10)
        assert not th.is_alive() and got["version"] > s1["version"]
        assert got["todos"][0]["isCompleted"] == 1

        _api(base, "/api/mutate", {"table": "todo", "values": {"id": t1, "isDeleted": True}})
        assert _api(base, "/api/state?since=-1")["todos"] == []

        _api(base, "/api/reset", {})
        s = _api(base, "/api/state?since=-1")
        assert s["todos"] == [] and s["categories"] == []
    finally:
        server.stop()


def test_two_port_demos_converge_through_relay():
    relay = RelayServer(device="cpu").start()
    a = DemoServer(DemoApp(sync_url=relay.url, device="cpu")).start()
    mnemonic = a.app.evolu.owner.mnemonic
    b = DemoServer(DemoApp(sync_url=relay.url, mnemonic=mnemonic, device="cpu")).start()
    try:
        _api(a.url, "/api/mutate", {"table": "todo",
             "values": {"title": "from A", "isCompleted": False}})
        # B never syncs explicitly: the demo's periodic auto-pull (the
        # reference's load/online/focus trigger analog) must converge
        # an IDLE instance on its own.
        deadline = time.time() + 25
        titles = []
        while time.time() < deadline:
            titles = [t["title"] for t in _api(b.url, "/api/state?since=-1")["todos"]]
            if titles:
                break
            time.sleep(0.4)
        assert titles == ["from A"]
    finally:
        try:
            a.stop()
        finally:
            try:
                b.stop()
            finally:
                relay.stop()
