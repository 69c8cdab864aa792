"""`evolu_tpu_torch` imports neither jax, `evolu_tpu` nor `ml_dtypes`
(the card's machine has none of them), directly or transitively, and
importing it does not initialize CUDA."""

import ast
import json
import os
import pathlib
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, pkgutil, sys
import evolu_tpu_torch

names = sorted(
    {"evolu_tpu_torch"}
    | {m.name for m in pkgutil.walk_packages(evolu_tpu_torch.__path__, "evolu_tpu_torch.")}
)
for name in names:
    importlib.import_module(name)
import torch
print("RESULT:" + json.dumps({
    "modules": names,
    "forbidden": sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu", "ml_dtypes")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_port_imports_no_jax_and_touches_no_card():
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=_REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))
    result = json.loads(line[len("RESULT:"):])
    assert "evolu_tpu_torch.parallel.reconcile" in result["modules"]
    assert "evolu_tpu_torch.storage.apply" in result["modules"]
    assert "evolu_tpu_torch.ops.crdt_merge" in result["modules"]
    assert "evolu_tpu_torch.core.crdt_tensor" in result["modules"]
    assert "evolu_tpu_torch.runtime.worker" in result["modules"]
    assert "evolu_tpu_torch.ops.winner_cache" in result["modules"]
    assert "evolu_tpu_torch.server.relay" in result["modules"]
    assert "evolu_tpu_torch.server.engine" in result["modules"]
    for name in ("api", "api.model", "api.query", "api.hooks", "utils.reload", "runtime.client",
                 "sync.crypto", "sync._evp_cfb", "sync.aead", "sync._evp_gcm", "sync.client",
                 "utils.native_loader", "storage.native", "sync.native_crypto", "core.packed",
                 "server.scheduler", "server.snapshot", "server.relay_worker", "server.replicate",
                 "server.fleet", "server.push", "server.conn"):
        assert f"evolu_tpu_torch.{name}" in result["modules"]
    assert result["forbidden"] == []
    assert result["cuda_initialized"] is False


def test_cryptography_only_behind_module_not_found():
    """`cryptography` is optional (the card's machine may not have it):
    every import of it sits in a `try` whose handler catches
    ModuleNotFoundError, as in the reference."""
    found = 0
    for path in pathlib.Path(_REPO, "evolu_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Try) and any(
                    isinstance(h.type, ast.Name) and h.type.id == "ModuleNotFoundError" for h in node.handlers):
                guarded |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == "cryptography" for n in names):
                found += 1
                assert id(node) in guarded, f"{path}:{node.lineno} imports cryptography unguarded"
    assert found == 3  # crypto.py's Cipher; aead.py's AESGCM and InvalidTag


_NO_WHEEL = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] == "cryptography":
            raise ModuleNotFoundError(name)
sys.meta_path.insert(0, Block())
from evolu_tpu_torch.sync import aead, crypto
assert "cryptography" not in sys.modules
assert crypto.Cipher.__module__ == "evolu_tpu_torch.sync._evp_cfb"
assert aead.AESGCM.__module__ == "evolu_tpu_torch.sync._evp_gcm"
ct = crypto.encrypt_symmetric(b"payload", "pw")
assert crypto.decrypt_symmetric(ct, "pw") == b"payload"
s = aead.get_session("pw", records=1)
assert aead.decrypt_content(aead.encrypt_record(s.key, s.salt, b"v2"), "pw") == b"v2"
print("RESULT:ok")
"""


def test_crypto_runs_on_libcrypto_without_the_wheel():
    """With `cryptography` absent, OpenPGP and the v2 records run on the
    system libcrypto through ctypes."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_WHEEL], cwd=_REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    assert "RESULT:ok" in out.stdout


_NATIVE = r"""
import json, os, sys
from evolu_tpu_torch.storage.native import CppSqliteDatabase
from evolu_tpu_torch.sync import native_crypto
from evolu_tpu_torch.utils import native_loader
CppSqliteDatabase().exec("SELECT 1")
assert native_crypto.load_library() is not None
maps = open("/proc/self/maps").read()
print("RESULT:" + json.dumps({
    "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu")),
    "paths": {k: v["path"] for k, v in native_loader.build_info.items()},
    "mapped": sorted({l.split()[-1] for l in maps.splitlines() if "libevolu_" in l}),
}))
"""


def test_native_libraries_load_from_the_port_build_alone():
    """The port's loader imports nothing of `evolu_tpu`, and the native
    libraries the process maps are the port's builds under
    `evolu_tpu_torch/_build/native/`, never `native/*.so`."""
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE], cwd=_REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))
    result = json.loads(line[len("RESULT:"):])
    assert result["forbidden"] == []
    root = os.path.join(_REPO, "evolu_tpu_torch", "_build", "native") + os.sep
    assert set(result["paths"]) == {"libevolu_host.so", "libevolu_crypto.so"}
    assert len(result["mapped"]) == 2
    for path in list(result["paths"].values()) + result["mapped"]:
        assert path.startswith(root), path


_WORKER = r"""
import json, sys, threading, urllib.request
from evolu_tpu_torch.server import relay_worker
port, path = sys.argv[1:3]
sys.argv = ["relay_worker", "127.0.0.1", port, path, "2", "native"]
threading.Thread(target=relay_worker.main, daemon=True).start()
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp
from evolu_tpu_torch.sync import protocol
msgs = tuple(protocol.EncryptedCrdtMessage(timestamp_to_string(Timestamp(1_700_000_000_000 + i, 0, "a" * 16)), b"c")
             for i in range(50))
body = protocol.encode_sync_request(protocol.SyncRequest(msgs, "u", "f" * 16, "{}"))
url = "http://127.0.0.1:" + port
for _ in range(200):
    try:
        urllib.request.urlopen(url + "/ping", timeout=5).read()
        break
    except OSError:
        import time; time.sleep(0.05)
out = urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=30).read()
import torch
print("RESULT:" + json.dumps({
    "messages": len(protocol.decode_sync_response(out).messages),
    "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu", "ml_dtypes")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_relay_worker_serves_without_jax_or_the_card(tmp_path):
    """A `MultiprocessRelay` worker (`python -m
    evolu_tpu_torch.server.relay_worker`'s `main`) serves a sync POST on the
    host path: it imports nothing of JAX or `evolu_tpu` and never
    initializes CUDA."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = subprocess.run(
        [sys.executable, "-c", _WORKER, str(port), str(tmp_path / "relay.db")], cwd=_REPO,
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))
    result = json.loads(line[len("RESULT:"):])
    assert result == {"messages": 50, "forbidden": [], "cuda_initialized": False}


_TIER = r"""
import json, sys
import torch
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp
from evolu_tpu_torch.server import snapshot
from evolu_tpu_torch.server.relay import RelayServer, RelayStore
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.utils.config import FleetConfig

msgs = tuple(protocol.EncryptedCrdtMessage(timestamp_to_string(Timestamp(1_700_000_000_000 + i * 500, 0, "1" * 16)),
                                           b"ct%d" % i) for i in range(30))
donor = RelayServer(RelayStore(backend="native"), peers=[]).start()
donor.store.add_messages("alice", msgs)
fresh = RelayServer(RelayStore(backend="native"), peers=[donor.url], bootstrap_lag_owners=1,
                    replication_interval_s=3600)
fresh.replication.run_once()
fleet = donor.enable_fleet(FleetConfig(relays=(donor.url,), replication_factor=1, version=1))
path = sys.argv[1]
snapshot.write_checkpoint(donor.store, path)
restored = RelayStore(backend="native")
snapshot.restore_checkpoint(restored, path)
donor.stop()
print("RESULT:" + json.dumps({
    "bootstrapped": fresh.store.get_merkle_tree_string("alice") == restored.get_merkle_tree_string("alice") != "{}",
    "placed": fleet.placement("alice") == (donor.url,),
    "forbidden": sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu", "ml_dtypes")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_relay_tier_runs_without_jax_or_the_card(tmp_path):
    """Replication, a snapshot bootstrap, a checkpoint and a fleet on port
    relays on the host path import nothing of JAX or `evolu_tpu` and never
    initialize CUDA."""
    out = subprocess.run(
        [sys.executable, "-c", _TIER, str(tmp_path / "relay.checkpoint")], cwd=_REPO,
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))
    result = json.loads(line[len("RESULT:"):])
    assert result == {"bootstrapped": True, "placed": True, "forbidden": [], "cuda_initialized": False}


_PUSH = r"""
import json, sys, threading
import torch
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp
from evolu_tpu_torch.server.relay import RelayServer, RelayStore
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.sync.client import PushSubscriber, _http_post
from evolu_tpu_torch.utils.config import Config

relay = RelayServer(RelayStore(backend="native"), connection_tier="eventloop").start()
woken = threading.Event()
sub = PushSubscriber(Config(sync_url=relay.url), woken.set, poll_timeout_s=5.0)
sub.ensure("alice", "5" * 16, relay.url)
while relay.push_hub.stats_payload()["subscriptions"] != 1:
    threading.Event().wait(0.01)
msg = protocol.EncryptedCrdtMessage(timestamp_to_string(Timestamp(1_700_000_000_000, 0, "a" * 16)), b"ct")
_http_post(relay.url, protocol.encode_sync_request(protocol.SyncRequest((msg,), "alice", "a" * 16, "{}")))
ok = woken.wait(10)
sub.stop()
relay.stop()
print("RESULT:" + json.dumps({
    "woken": ok, "cursor": sub.cursor,
    "forbidden": sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu", "ml_dtypes")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_push_tier_runs_without_jax_or_the_card():
    """A push wake through an event-tier relay to a `PushSubscriber` on the
    host path imports nothing of JAX or `evolu_tpu` and never initializes
    CUDA."""
    out = subprocess.run(
        [sys.executable, "-c", _PUSH], cwd=_REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))
    result = json.loads(line[len("RESULT:"):])
    assert result == {"woken": True, "cursor": 1, "forbidden": [], "cuda_initialized": False}
