"""Port parity: the system's entry points (`evolu_tpu_torch.examples`) as
processes, against the JAX package's `examples/`.

- `todo_cli`: the same scripted session (categories, todos, assign,
  toggle, rename, soft-delete, sync, the mnemonic, then a second device
  restoring it) through the port's CLI against a port relay and through
  JAX's `examples/todo_cli.py` against a JAX relay; the lists `ls`
  renders (titles, completion marks, categories; the ids are random) and
  the refusals are equal.
- `relay_server`: `GET /ping` and one `POST /` answer the JAX relay's
  bytes.
- `pod_server`: at one process it prints JAX's `examples/pod_server.py`
  line (answered requests, response bytes, pod digest); at two processes
  over gloo each prints the same pod digest, and the two answer every
  request once with the same response bytes in all. This is the port's
  twin of `tests/test_multihost_cluster.py::test_pod_server_across_two_processes`
  as an entry point; `tests/test_torch_multihost.py::test_two_process_pod_matches_jax`
  holds the pod's answers byte for byte.
- Every entry point raises without a card unless given `--device cpu`.

Tolerance: exact (equal text lines and bytes). Every process runs inside
its own time limit."""

import os
import re
import signal
import socket
import subprocess
import sys
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": _REPO, "JAX_PLATFORMS": "cpu"}
LIMIT_S = 240
# The pod digest of the demo batch, as JAX's examples/pod_server.py prints it.
POD_DIGEST = "0x9eac93cd"
POD_LINE = (f"proc 0/1: answered 8/8 requests [0, 1, 2, 3, 4, 5, 6, 7] (5312 response bytes), "
            f"pod digest {POD_DIGEST}")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_cmd(name, *args):
    return [sys.executable, "-m", f"evolu_tpu_torch.examples.{name}", *args]


def _jax_cmd(name, *args):
    return [sys.executable, os.path.join(_REPO, "examples", f"{name}.py"), *args]


def _run(cmd, stdin=None, cwd=None):
    out = subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=LIMIT_S, env=_ENV,
                         cwd=cwd or _REPO)
    return out


# -- todo_cli --------------------------------------------------------------------

# Each `sync` drains the client's worker, so the commands after it see the
# rows the commands before it wrote (the CLI reads its list from the
# query subscription, which the worker refreshes).
_SESSION = """cat work
cat home
add buy milk
add write report
add call mom
sync
assign 1 home
assign 2 work
toggle 1
rename 3 call dad
sync
rm 2
toggle 9
assign 1 garden
sync
ls
owner
quit
"""

_RESTORE = """sync
ls
toggle 2
sync
ls
quit
"""


def _renders(stdout):
    """The rendered lists of a session: each `-- todos --` block's lines."""
    blocks, cur = [], None
    for line in stdout.splitlines():
        if line == "-- todos --":
            cur = []
            blocks.append(cur)
        elif cur is not None and re.match(r"^ +\d+\. \[", line):
            cur.append(line)
        else:
            cur = None
    return blocks


def _session(cmd, relay_url, db_dir, script, mnemonic=None):
    args = ["--db", os.path.join(db_dir, "a.db" if mnemonic is None else "b.db"), "--sync-url", relay_url + "/"]
    if mnemonic:
        args += ["--mnemonic", mnemonic]
    out = _run(cmd(*args), stdin=script)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _cli_sessions(cmd, relay_url, db_dir):
    """→ the list `ls` rendered last in each session, and the refusals.
    The subscription's own renders run on the worker thread, as many as
    its refreshes, so only the quiesced `ls` is compared."""
    first = _session(cmd, relay_url, db_dir, _SESSION)
    mnemonic = next(l for l in first.splitlines() if len(l.split()) == 12 and l.islower())
    second = _session(cmd, relay_url, db_dir, _RESTORE, mnemonic)
    errors = [l for l in (first + second).splitlines() if l.startswith("!")]
    return _renders(first)[-1], _renders(second)[-1], errors


def test_todo_cli_renders_jax_lists(tmp_path):
    import evolu_tpu.server.relay as jrelay
    import evolu_tpu_torch.server.relay as prelay

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jax_relay = jrelay.RelayServer(jrelay.RelayStore(str(jdir / "relay.db"))).start()
    port_relay = prelay.RelayServer(prelay.RelayStore(str(pdir / "relay.db")), device="cpu").start()
    try:
        want = _cli_sessions(lambda *a: _jax_cmd("todo_cli", *a), jax_relay.url, str(jdir))
        got = _cli_sessions(lambda *a: _port_cmd("todo_cli", *a, "--device", "cpu"), port_relay.url, str(pdir))
    finally:
        jax_relay.stop()
        port_relay.stop()
    assert got == want
    first, second, errors = got
    assert first == ["  1. [x] buy milk  [home]", "  2. [ ] call dad"]
    assert second == ["  1. [x] buy milk  [home]", "  2. [x] call dad"]
    # The missing todo and the missing category are refused, in both CLIs.
    assert errors == ["! no todo #9", "! no category 'garden'"]


# -- relay_server ----------------------------------------------------------------


def _start_relay_process(tmp_path, port):
    p = subprocess.Popen(
        _port_cmd("relay_server", "--host", "127.0.0.1", "--port", str(port), "--db", str(tmp_path / "relay.db"),
                  "--device", "cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_ENV, cwd=_REPO)
    line = p.stdout.readline()
    assert line.startswith("relay listening on "), line
    return p


def _request_body(proto):
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    msgs = tuple(proto.EncryptedCrdtMessage(
        timestamp_to_string(Timestamp(1_700_000_000_000 + i * 61_000, i % 3, "ab" * 8)), b"ct-%d" % i)
        for i in range(40))
    return proto.encode_sync_request(proto.SyncRequest(msgs, "owner-relay", "ab" * 8, "{}"))


def test_relay_server_answers_jax_bytes(tmp_path):
    import evolu_tpu.server.relay as jrelay
    import evolu_tpu.sync.protocol as jproto
    import evolu_tpu_torch.sync.protocol as pproto

    port = _free_port()
    proc = _start_relay_process(tmp_path, port)
    try:
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/ping", timeout=30) as r:
            ping = (r.status, r.read())
        body = _request_body(pproto)
        assert body == _request_body(jproto)
        pull = pproto.encode_sync_request(pproto.SyncRequest((), "owner-relay", "f" * 16, "{}"))
        got = []
        for b in (body, pull):
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/", data=b, headers={"Content-Type": "application/octet-stream"}), timeout=30) as r:
                got.append((r.status, r.read()))
    finally:
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=LIMIT_S)
    jax_relay = jrelay.RelayServer(jrelay.RelayStore(str(tmp_path / "jax.db"))).start()
    try:
        with urllib.request.urlopen(jax_relay.url + "/ping", timeout=30) as r:
            assert ping == (r.status, r.read())
        for b, answer in zip((body, pull), got):
            with urllib.request.urlopen(urllib.request.Request(
                    jax_relay.url + "/", data=b, headers={"Content-Type": "application/octet-stream"}),
                    timeout=30) as r:
                assert answer == (r.status, r.read())
    finally:
        jax_relay.stop()
    assert len(pproto.decode_sync_response(got[1][1]).messages) == 40


# -- pod_server ------------------------------------------------------------------


def test_pod_server_prints_jax_line_in_one_process(tmp_path):
    want = _run(_jax_cmd("pod_server"), cwd=str(tmp_path))
    assert want.returncode == 0, want.stderr[-4000:]
    got = _run(_port_cmd("pod_server", "--device", "cpu"), cwd=str(tmp_path))
    assert got.returncode == 0, got.stderr[-4000:]
    assert got.stdout.strip().splitlines()[-1] == want.stdout.strip().splitlines()[-1] == POD_LINE


def test_pod_server_across_two_processes_gives_the_same_digest(tmp_path):
    coordinator = f"file://{tmp_path}/gloo.store"
    procs = [subprocess.Popen(
        _port_cmd("pod_server", "--device", "cpu", "--nproc", "2", "--pid", str(i), "--coordinator", coordinator,
                  "--store", str(tmp_path / "pod")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_ENV, cwd=_REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [next(l for l in out.splitlines() if l.startswith(f"proc {i}/2:")) for i, out in enumerate(outs)]
    answered, total = [], 0
    for line in lines:
        m = re.search(r"answered (\d+)/8 requests \[([\d, ]*)\] \((\d+) response bytes\), pod digest (0x[0-9a-f]+)",
                      line)
        assert m and m.group(4) == POD_DIGEST, line
        answered += [int(x) for x in m.group(2).split(",") if x.strip()]
        total += int(m.group(3))
    assert sorted(answered) == list(range(8)) and total == 5312


# -- without a card ----------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("relay_server", ("--host", "127.0.0.1", "--port", "0", "--db", ":memory:")),
    ("pod_server", ()),
    ("todo_cli", ("--sync-url", "http://127.0.0.1:9/")),
    ("web_todo", ("--port", "0")),
])
def test_entry_point_needs_a_card_unless_given_the_cpu(name, args, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    out = _run(_port_cmd(name, *args), stdin="quit\n", cwd=str(tmp_path))
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA is not available" in out.stderr, out.stderr[-2000:]
