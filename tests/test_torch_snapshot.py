"""Port parity: snapshot bootstrap and checkpoints (`server/snapshot.py`,
the snapshot codecs of `sync/protocol.py`, `bootstrap_lag_owners` and
`checkpoint_interval_s` of `RelayServer`) against the JAX package's.

- Every snapshot codec encodes byte-equal to the JAX codec and decodes the
  other package's bytes; on hostile inputs both decoders give the same
  value or both raise ValueError, and nothing else.
- `capture_shard` on the native and the Python store and the whole
  `capture_snapshot` (manifest and chunks) equal the JAX package's bytes;
  checkpoint files are byte-identical.
- The episodes of `tests/test_snapshot.py` (bootstrap against
  anti-entropy, the watermark handoff, the lagging peer's merge, a
  corrupted chunk, a tampered tree, resume from the persisted watermark,
  the multi-peer resume, the stranded swap, an expired snapshot, a
  mid-install write, a foreign open transaction, checkpoints) end in the
  JAX episode's tree strings and rows.
- A JAX donor's snapshot installs into a port relay and a port donor's
  into a JAX relay.

Tolerance: exact everywhere."""

import dataclasses
import os
import threading
import urllib.error
import uuid
import zlib

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from _torch_port_data import within
from _torch_relay_tier import (
    BASE, JAX, LIMIT_S, MINUTE, PKGS, PORT, decode_both, fast_post, hostile_cases, msgs, seed, server, state, stop_all,
    store, wait_for,
)


def _vectors(p):
    return {
        "manifest": p.SnapshotManifest("snap-1", (100, 7), (0xDEADBEEF, 0),
                                       (("alice", -123456, 42), ("b\x00ob", 0, 0xFFFFFFFF)), 12345, 107),
        "request": p.SnapshotRequest("replica-9", 1 << 20),
        "request_owners": p.SnapshotRequest("rid", 1024, ("o1", "o2")),
        "request_scoped": p.SnapshotRequest("rid", 0, (), 1_700_000_000_000, ("lane-a", "lane-b")),
        "chunk_request": p.SnapshotChunkRequest("snap-1", 3, "replica-9"),
        "chunk": p.SnapshotChunk("snap-1", 3, 0xCAFEBABE, b"\x00\xffpayload"),
    }


_CODECS = {
    "manifest": ("encode_snapshot_manifest", "decode_snapshot_manifest"),
    "request": ("encode_snapshot_request", "decode_snapshot_request"),
    "request_owners": ("encode_snapshot_request", "decode_snapshot_request"),
    "request_scoped": ("encode_snapshot_request", "decode_snapshot_request"),
    "chunk_request": ("encode_snapshot_chunk_request", "decode_snapshot_chunk_request"),
    "chunk": ("encode_snapshot_chunk", "decode_snapshot_chunk"),
}


@pytest.mark.parametrize("kind", list(_CODECS))
def test_snapshot_codecs_encode_byte_equal_and_cross_decode(kind):
    enc, dec = _CODECS[kind]
    jv, pv = _vectors(JAX.proto)[kind], _vectors(PORT.proto)[kind]
    jb, pb = getattr(JAX.proto, enc)(jv), getattr(PORT.proto, enc)(pv)
    assert pb == jb
    assert getattr(PORT.proto, dec)(jb) == pv
    assert getattr(JAX.proto, dec)(pb) == jv


@pytest.mark.parametrize("decoder", sorted({d for _e, d in _CODECS.values()}))
def test_snapshot_decoders_agree_and_raise_valueerror_only(decoder):
    valid = [getattr(JAX.proto, _CODECS[k][0])(v) for k, v in _vectors(JAX.proto).items()]
    for data in hostile_cases(valid, 11, 5):
        got, want = decode_both(decoder, data)
        assert got == want, data


@pytest.mark.parametrize("backend", ["native", "python"])
def test_capture_matches_jax_bytes(backend, monkeypatch):
    """`capture_shard` on each backend, the Python oracle, and the whole
    `capture_snapshot` (manifest with a fixed id, and chunks) equal the JAX
    package's bytes on the same store contents."""
    fixed = uuid.UUID(int=7)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    out = {}
    for pkg in PKGS:
        st = pkg.relay.RelayStore(backend=backend)
        seed(pkg, st, owners=5, per_minute=9, minutes=3, payload=b"\x00\xff" * 20)
        st.add_messages("ünicode-owner", msgs(pkg, "c" * 16, 7, 0, 4))
        with pkg.snap._exclusive_txn(st.db):
            shard = pkg.snap.capture_shard(st.db)
            oracle = pkg.snap._capture_shard_py(st.db)
        manifest, chunks = pkg.snap.capture_snapshot(st, chunk_bytes=2048)
        out[pkg.name] = (shard, oracle, dataclasses.astuple(manifest), chunks)
        st.close()
    assert out["port"] == out["jax"]
    shard, oracle, manifest, chunks = out["port"]
    assert shard == oracle and b"".join(chunks) == shard and len(chunks) > 3
    assert all(len(c) <= 2048 for c in chunks)


def test_chunks_split_at_record_boundaries_and_reassemble():
    """Every port chunk parses alone and the records reassemble to the JAX
    package's records."""
    recs = {}
    for pkg in PKGS:
        st = store(pkg)
        seed(pkg, st, owners=4, per_minute=20, minutes=2, payload=b"z" * 300)
        _manifest, chunks = pkg.snap.capture_snapshot(st, chunk_bytes=4096)
        recs[pkg.name] = [r for c in chunks for r in pkg.snap.iter_records(c)]
        st.close()
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 4 * 40 + 4
    with pytest.raises(ValueError):
        list(PORT.snap.iter_records(b"\x4d\x05\x00"))
    with pytest.raises(ValueError):
        list(PORT.snap.iter_records(b"\x99"))


def _round_trips(pkg, mgr):
    if pkg is PORT:
        return sum(mgr.round_trips.values())
    return sum(JAX.rep.metrics.get_counter("evolu_repl_round_trips_total", replica=mgr.replica_id, leg=leg)
               for leg in ("summary", "pull", "snapshot", "snapshot/chunk"))


def _peer_count(pkg, mgr, url, key):
    """A per-peer count of the port's manager, or the JAX metric it replaces."""
    if pkg is PORT:
        return mgr.peer_counts.get(url, {}).get(key, 0)
    name, labels = {
        "messages_pulled": ("evolu_repl_messages_pulled_total", {}),
        "snapshot_bootstraps": ("evolu_snap_installs_total", {"result": "ok"}),
        "snapshot_errors": ("evolu_snap_installs_total", {"result": "error"}),
        "snapshot_resumes": ("evolu_snap_resumes_total", {}),
    }[key]
    return JAX.rep.metrics.get_counter(name, replica=mgr.replica_id, peer=url, **labels)


def test_fresh_bootstrap_beats_anti_entropy_like_jax():
    """A fresh relay bootstrapping from a donor of 32 owners / 1,536
    messages converges byte-identically in at least 5x fewer round trips
    than pure anti-entropy under the donor's caps, and pulls no message;
    both legs equal the JAX episode's."""

    def drive(pkg):
        donor_store = store(pkg, shards=2)
        seed(pkg, donor_store, owners=32, per_minute=12, minutes=4)
        donor_mgr = pkg.rep.ReplicationManager(donor_store, [], replica_id=f"accept-donor-{pkg.name}",
                                               pull_messages_per_owner=16, pull_messages_per_response=128)
        donor = server(pkg, donor_store, replication=donor_mgr).start()
        try:
            want = state(donor_store)
            dest_a, dest_b = store(pkg), store(pkg)
            mgr_a = pkg.rep.ReplicationManager(dest_a, [donor.url], replica_id=f"accept-anti-{pkg.name}",
                                               http_post=fast_post(pkg))
            for _ in range(60):
                mgr_a.run_once()
                if state(dest_a) == want:
                    break
            mgr_b = pkg.rep.ReplicationManager(dest_b, [donor.url], replica_id=f"accept-snap-{pkg.name}",
                                               http_post=fast_post(pkg), bootstrap_lag_owners=8,
                                               snapshot_chunk_bytes=64 * 1024)
            mgr_b.run_once()  # the bootstrap
            mgr_b.run_once()  # a post-watermark gossip round
            out = (state(dest_a), state(dest_b), _round_trips(pkg, mgr_a), _round_trips(pkg, mgr_b),
                   _peer_count(pkg, mgr_b, donor.url, "messages_pulled"),
                   _peer_count(pkg, mgr_b, donor.url, "snapshot_bootstraps"))
            for m, d in ((mgr_a, dest_a), (mgr_b, dest_b)):
                m.stop()
                d.close()
            return want, out
        finally:
            donor.stop()

    want_j, out_j = within(LIMIT_S, lambda: drive(JAX))
    want_p, out_p = within(LIMIT_S, lambda: drive(PORT))
    assert want_p == want_j and out_p == out_j
    anti, snap_state, anti_rts, snap_rts, pulled, boots = out_p
    assert anti == snap_state == want_p and snap_rts * 5 <= anti_rts and pulled == 0 and boots == 1


def test_bootstrap_hands_off_to_gossip_at_the_watermark_like_jax():
    """Writes landing on the donor after the capture arrive by gossip, the
    pull count shows the tail only, and one new owner stays a ranged pull."""

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=12, per_minute=10, minutes=2)
        donor = server(pkg, donor_store, peers=[]).start()
        dest = store(pkg)
        mgr = pkg.rep.ReplicationManager(dest, [donor.url], replica_id=f"wm-{pkg.name}",
                                         http_post=fast_post(pkg), bootstrap_lag_owners=4)
        try:
            steps = []
            mgr.run_once()
            steps.append(state(dest) == state(donor_store))
            donor_store.add_messages("owner003", msgs(pkg, "4" * 16, 30, 0, 17))
            mgr.run_once()
            steps.append(_peer_count(pkg, mgr, donor.url, "messages_pulled"))
            donor_store.add_messages("brand-new-owner", msgs(pkg, "9" * 16, 31, 0, 6))
            mgr.run_once()
            steps += [_peer_count(pkg, mgr, donor.url, "messages_pulled"),
                      _peer_count(pkg, mgr, donor.url, "snapshot_bootstraps")]
            return state(dest), state(donor_store), steps
        finally:
            mgr.stop()
            donor.stop()
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want
    assert got[0] == got[1] and got[2] == [True, 17, 23, 1]


def test_lagging_peer_bootstrap_merges_local_only_rows_like_jax():
    """A lagging, not empty, peer keeps the rows the donor never had; every
    swapped-in tree is the recompute of its rows."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=20, per_minute=8, minutes=2)
        donor = server(pkg, donor_store, peers=[]).start()
        dest = store(pkg)
        dest.add_messages("owner001", msgs(pkg, f"{2:016x}", 0, 0, 8))
        dest.add_messages("owner001", msgs(pkg, "e" * 16, 40, 0, 5))
        dest.add_messages("local-owner", msgs(pkg, "f" * 16, 41, 0, 3))
        mgr = pkg.rep.ReplicationManager(dest, [donor.url], replica_id=f"lag-{pkg.name}",
                                         http_post=fast_post(pkg), bootstrap_lag_owners=4)
        try:
            mgr.run_once()
            return state(dest), state(donor_store)
        finally:
            mgr.stop()
            donor.stop()
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got, donor_state = within(LIMIT_S, lambda: drive(PORT))
    assert (got, donor_state) == want
    assert set(got) == set(donor_state) | {"local-owner"}
    assert len(got["owner001"][1]) == len(donor_state["owner001"][1]) + 5
    for uid, (tree_text, rows) in got.items():
        deltas, _d = minute_deltas_host([t for t, _c in rows])
        assert tree_text == merkle_tree_to_string(apply_prefix_xors({}, deltas)), uid


def _corrupting_post(pkg):
    def post(url, body):
        out = fast_post(pkg)(url, body)
        if url.endswith("/replicate/snapshot/chunk"):
            chunk = pkg.proto.decode_snapshot_chunk(out)
            bad = bytearray(chunk.payload)
            bad[len(bad) // 2] ^= 0x40
            out = pkg.proto.encode_snapshot_chunk(
                pkg.proto.SnapshotChunk(chunk.snapshot_id, chunk.index, chunk.crc, bytes(bad)))
        return out
    return post


def test_corrupted_chunk_aborts_with_live_tables_untouched_like_jax():
    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=6, per_minute=10, minutes=2)
        donor = server(pkg, donor_store, peers=[]).start()
        dest = store(pkg)
        dest.add_messages("pre-existing", msgs(pkg, "a" * 16, 0, 0, 4))
        before = state(dest)
        mgr = pkg.rep.ReplicationManager(dest, [donor.url], replica_id=f"corrupt-{pkg.name}",
                                         http_post=_corrupting_post(pkg), bootstrap_lag_owners=1)
        try:
            with pytest.raises(pkg.snap.SnapshotInstallError):
                mgr.bootstrap_from(donor.url)
            return (state(dest) == before, state(dest), pkg.snap.SnapshotInstaller(dest).pending(),
                    _peer_count(pkg, mgr, donor.url, "snapshot_errors"))
        finally:
            mgr.stop()
            donor.stop()
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want and got[0] is True and got[2] is None and got[3] == 1


def test_verify_rejects_a_tampered_tree_like_jax():
    """A snapshot whose shipped tree text is not the recompute of its own
    rows aborts, even with manifest digests made to agree with it."""
    from evolu_tpu_torch.core.merkle import merkle_tree_from_string, merkle_tree_to_string
    from evolu_tpu_torch.core.murmur import to_int32

    def drive(pkg):
        st = store(pkg)
        seed(pkg, st, owners=3, per_minute=6, minutes=2)
        manifest, chunks = pkg.snap.capture_snapshot(st)
        out, owners, tampered = [], None, None
        for r in pkg.snap.iter_records(b"".join(chunks)):
            if r[0] == "T" and tampered is None:
                tampered = r[1]
                t = merkle_tree_from_string(r[2])
                t["hash"] = to_int32((t.get("hash") or 0) ^ 1)
                bad_tree = merkle_tree_to_string(t)
                out.append(pkg.snap._frame_tree(r[1], bad_tree))
                owners = tuple((u, merkle_tree_from_string(bad_tree).get("hash") or 0,
                                zlib.crc32(bad_tree.encode())) if u == r[1] else (u, rh, tc)
                               for u, rh, tc in manifest.owners)
            elif r[0] == "T":
                out.append(pkg.snap._frame_tree(r[1], r[2]))
            else:
                out.append(pkg.snap._frame_message(r[1], r[2], r[3]))
        bad_stream = b"".join(out)
        bad = pkg.proto.SnapshotManifest(manifest.snapshot_id, (len(bad_stream),), (zlib.crc32(bad_stream),),
                                         owners, manifest.message_count, len(bad_stream))
        dest = store(pkg)
        with pytest.raises(pkg.snap.SnapshotInstallError, match="tree verification failed"):
            pkg.snap.install_stream(dest, bad, [bad_stream])
        result = (tampered, dest.user_ids(), pkg.snap.SnapshotInstaller(dest).pending())
        st.close()
        dest.close()
        return result

    assert within(LIMIT_S, lambda: drive(PORT)) == within(LIMIT_S, lambda: drive(JAX)) == ("owner000", [], None)


class FlakyTransport:
    """Fails every chunk leg after the first `allow` with a connection-level
    error: an interrupted bootstrap."""

    def __init__(self, post, allow):
        self._post, self.allow, self.chunk_posts, self.failing = post, allow, 0, True

    def post(self, url, body):
        if url.endswith("/replicate/snapshot/chunk"):
            if self.failing and self.chunk_posts >= self.allow:
                raise urllib.error.URLError("flaky (fault injection)")
            self.chunk_posts += 1
        return self._post(url, body)


def _log_chunks(relay_server, served):
    cache = relay_server.replication.snapshot_cache
    orig = cache.chunk
    cache.chunk = lambda sid, i: (served.append(i), orig(sid, i))[1]


@pytest.mark.parametrize("decoy", [False, True])
def test_interrupted_fetch_resumes_from_the_persisted_watermark_like_jax(decoy):
    """A bootstrap cut off after two chunks resumes at the next attempt from
    the persisted watermark (chunks 0 and 1 served once each), also when
    that attempt targets another configured peer (`decoy`): the resume
    sticks to the original donor."""

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=10, per_minute=40, minutes=5, payload=b"x" * 40)
        donor = server(pkg, donor_store, peers=[]).start()
        served, decoy_served = [], []
        _log_chunks(donor, served)
        other = None
        peers = [donor.url]
        if decoy:
            other_store = store(pkg)
            seed(pkg, other_store, owners=2, per_minute=4, minutes=1)
            other = server(pkg, other_store, peers=[]).start()
            _log_chunks(other, decoy_served)
            peers = [other.url, donor.url]
        dest = store(pkg)
        flaky = FlakyTransport(fast_post(pkg), allow=2)
        mgr = pkg.rep.ReplicationManager(dest, peers, replica_id=f"resume-{decoy}-{pkg.name}",
                                         http_post=flaky.post, bootstrap_lag_owners=1,
                                         snapshot_chunk_bytes=64 * 1024)
        try:
            with pytest.raises(urllib.error.URLError):
                mgr.bootstrap_from(donor.url)
            pending = pkg.snap.SnapshotInstaller(dest).pending()
            flaky.failing = False
            mgr.bootstrap_from(other.url if decoy else donor.url)
            return (state(dest) == state(donor_store), state(dest), pending["next_chunk"],
                    len(pending["manifest"].chunk_sizes) > 3, served.count(0), served.count(1), decoy_served,
                    _peer_count(pkg, mgr, donor.url, "snapshot_resumes"))
        finally:
            mgr.stop()
            stop_all([donor, other])
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want and got[0] is True and got[2:] == (2, True, 1, 1, [], 1)


def test_stranded_mid_swap_install_finishes_on_the_next_round_like_jax():
    """A crash between shard swaps (driven by hand: fetched, verified,
    phase=swap, only shard 0 swapped) is finished by any manager's first
    round, even one whose threshold would not re-arm a bootstrap."""

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=10, per_minute=8, minutes=2)
        donor = server(pkg, donor_store, peers=[]).start()
        dest = store(pkg, shards=2)
        try:
            manifest, chunks = pkg.snap.capture_snapshot(donor_store)
            inst = pkg.snap.SnapshotInstaller(dest)
            inst.begin(manifest, donor.url)
            for i, payload in enumerate(chunks):
                inst.install_chunk(i, payload, expected_crc=manifest.chunk_crcs[i])
            inst.verify(manifest)
            inst._state_set(phase="swap")
            db = dest.shards[0].db
            with pkg.snap._exclusive_txn(db):
                db.run('DROP TABLE "message"')
                db.run('ALTER TABLE "messageBsnap" RENAME TO "message"')
                db.run('DROP TABLE "merkleTree"')
                db.run('ALTER TABLE "merkleTreeBsnap" RENAME TO "merkleTree"')
            half = state(dest) != state(donor_store)
            phase = pkg.snap.install_phase(dest)
            mgr = pkg.rep.ReplicationManager(dest, [donor.url], replica_id=f"strand-{pkg.name}",
                                             http_post=fast_post(pkg), bootstrap_lag_owners=50)
            mgr.run_once()
            mgr.stop()
            return half, phase, state(dest), state(dest) == state(donor_store), \
                pkg.snap.SnapshotInstaller(dest).pending()
        finally:
            donor.stop()
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want and got[0] is True and got[1] == "swap" and got[3] is True and got[4] is None


def test_expired_snapshot_restarts_fresh_like_jax():
    """A donor that no longer serves the snapshot id answers 400 on the
    chunk leg: the puller drops its watermark and the next attempt
    bootstraps fresh to byte-identity."""

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=8, per_minute=30, minutes=3, payload=b"y" * 40)
        donor = server(pkg, donor_store, peers=[]).start()
        dest = store(pkg)
        flaky = FlakyTransport(fast_post(pkg), allow=1)
        mgr = pkg.rep.ReplicationManager(dest, [donor.url], replica_id=f"expire-{pkg.name}",
                                         http_post=flaky.post, bootstrap_lag_owners=1,
                                         snapshot_chunk_bytes=64 * 1024)
        try:
            with pytest.raises(urllib.error.URLError):
                mgr.bootstrap_from(donor.url)
            donor.replication.snapshot_cache._entries.clear()  # the donor "restarted"
            flaky.failing = False
            with pytest.raises(urllib.error.HTTPError) as e:
                mgr.bootstrap_from(donor.url)
            dropped = pkg.snap.SnapshotInstaller(dest).pending()
            mgr.bootstrap_from(donor.url)
            return e.value.code, dropped, state(dest), state(dest) == state(donor_store)
        finally:
            mgr.stop()
            donor.stop()
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want and got[0] == 400 and got[1] is None and got[3] is True


def test_write_accepted_mid_install_survives_the_swap_like_jax(monkeypatch):
    """A write the relay takes while an install is in flight is merged into
    the side tables inside the swap's transaction, never lost."""
    entered = {pkg.name: threading.Event() for pkg in PKGS}
    written = {pkg.name: threading.Event() for pkg in PKGS}
    for pkg in PKGS:
        orig = pkg.snap.SnapshotInstaller.install_chunk

        def slow(self, i, p, expected_crc=None, _orig=orig, _pkg=pkg):
            n = _orig(self, i, p, expected_crc)
            if i == 0:
                entered[_pkg.name].set()
                written[_pkg.name].wait(20)
            return n

        monkeypatch.setattr(pkg.snap.SnapshotInstaller, "install_chunk", slow)

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=8, per_minute=40, minutes=4, payload=b"w" * 40)
        donor = server(pkg, donor_store, peers=[]).start()
        dest = store(pkg)
        mgr = pkg.rep.ReplicationManager(dest, [donor.url], replica_id=f"midwrite-{pkg.name}",
                                         http_post=fast_post(pkg), bootstrap_lag_owners=1,
                                         snapshot_chunk_bytes=64 * 1024)
        try:
            t = threading.Thread(target=lambda: mgr.bootstrap_from(donor.url))
            t.start()
            assert entered[pkg.name].wait(20)
            dest.add_messages("mid-install-owner", msgs(pkg, "d" * 16, 99, 0, 3))
            written[pkg.name].set()
            t.join(timeout=30)
            assert not t.is_alive()
            return state(dest), state(donor_store)
        finally:
            mgr.stop()
            donor.stop()
            dest.close()

    want = within(LIMIT_S, lambda: drive(JAX))
    got, donor_state = within(LIMIT_S, lambda: drive(PORT))
    assert (got, donor_state) == want
    assert len(got["mid-install-owner"][1]) == 3 and all(got[u] == donor_state[u] for u in donor_state)


def test_capture_waits_out_a_foreign_open_transaction():
    """A capture landing inside the engine's explicit begin/commit waits for
    the commit and then sees all 11 rows, as the JAX capture does."""

    def drive(pkg):
        st = store(pkg)
        seed(pkg, st, owners=2, per_minute=5, minutes=1)
        db = st.db
        db.begin()
        db.run('INSERT INTO "message" ("timestamp", "userId", "content") VALUES (?, ?, ?)',
               ("t" * 46, "owner000", b"mid-batch"))
        result = {}
        t = threading.Thread(target=lambda: result.update(m=pkg.snap.capture_snapshot(st)[0]))
        t.start()
        t.join(0.3)
        waited = t.is_alive()
        db.commit()
        t.join(10)
        st.close()
        return waited, result["m"].message_count

    assert within(LIMIT_S, lambda: drive(PORT)) == within(LIMIT_S, lambda: drive(JAX)) == (True, 11)


def test_checkpoint_write_and_restore_are_byte_identical_to_jax(tmp_path, monkeypatch):
    """The checkpoint file of a 2-shard store is byte-identical to the JAX
    package's (one fixed snapshot id); restoring it into 4 shards gives the
    source's state; a flipped byte is refused before anything installs; and
    each package restores the other's file."""
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=3))
    files, states = {}, {}
    for pkg in PKGS:
        src = store(pkg, shards=2)
        seed(pkg, src, owners=9, per_minute=11, minutes=3)
        path = str(tmp_path / f"{pkg.name}.checkpoint")
        pkg.snap.write_checkpoint(src, path)
        assert not os.path.exists(path + ".tmp")
        with open(path, "rb") as f:
            files[pkg.name] = f.read()
        states[pkg.name] = state(src)
        src.close()
    assert files["port"] == files["jax"]
    for pkg, other in ((PORT, JAX), (JAX, PORT)):
        dest = store(pkg, shards=4)
        pkg.snap.restore_checkpoint(dest, str(tmp_path / f"{other.name}.checkpoint"))
        assert state(dest) == states[other.name]
        dest.close()
    bad = str(tmp_path / "bad.checkpoint")
    data = bytearray(files["port"])
    data[-20] ^= 0x10
    with open(bad, "wb") as f:
        f.write(bytes(data))
    fresh = store(PORT)
    with pytest.raises(ValueError):
        PORT.snap.restore_checkpoint(fresh, bad)
    assert fresh.user_ids() == []
    fresh.close()


def test_periodic_checkpointer_via_relay_server(tmp_path):
    """`RelayServer(checkpoint_interval_s=...)` writes checkpoints that
    restore the store, for both packages; a `:memory:` store without a
    `checkpoint_path` is refused with ValueError by both."""

    def drive(pkg):
        path = str(tmp_path / f"live-{pkg.name}.checkpoint")
        st = store(pkg)
        seed(pkg, st, owners=3, per_minute=5, minutes=1)
        srv = server(pkg, st, checkpoint_interval_s=0.05, checkpoint_path=path).start()
        try:
            wait_for(lambda: os.path.exists(path), "a periodic checkpoint", 10)
        finally:
            srv.stop()
        restored = store(pkg)
        pkg.snap.restore_checkpoint(restored, path)
        out = state(restored)
        restored.close()
        return out

    assert within(LIMIT_S, lambda: drive(PORT)) == within(LIMIT_S, lambda: drive(JAX))
    for pkg in PKGS:
        with pytest.raises(ValueError, match="checkpoint_path"):
            server(pkg, store(pkg), checkpoint_interval_s=1.0)


def test_config_defaults_flow_into_the_replication_manager():
    """Knobs left at None resolve from `default_config`, explicit arguments
    win, and `checkpoint_interval_s` reaches the RelayServer, as in JAX."""
    for pkg in PKGS:
        old = pkg.config.default_config
        st = store(pkg)
        try:
            pkg.config.set_config(pkg.config.Config(pull_messages_per_owner=77, pull_messages_per_response=555,
                                                    bootstrap_lag_owners=5, checkpoint_interval_s=9.0))
            mgr = pkg.rep.ReplicationManager(st, [], replica_id=f"cfg-{pkg.name}")
            mgr2 = pkg.rep.ReplicationManager(st, [], replica_id=f"cfg2-{pkg.name}", pull_messages_per_owner=11)
            got = (mgr.pull_messages_per_owner, mgr.pull_messages_per_response, mgr.bootstrap_lag_owners,
                   mgr2.pull_messages_per_owner)
            assert got == (77, 555, 5, 11), pkg.name
            with pytest.raises(ValueError, match="checkpoint_path"):
                server(pkg, st)
            mgr.stop()
            mgr2.stop()
        finally:
            pkg.config.set_config(old)
            st.close()


def test_snapshot_stats_surface_matches_jax_keys():
    """A relay with `bootstrap_lag_owners=1` cold-starts from a donor on its
    own loop; /stats shows the bootstrap on the puller and the capture on
    the donor, under the reference's keys."""
    import json
    import urllib.request

    def drive(pkg):
        donor_store = store(pkg)
        seed(pkg, donor_store, owners=5, per_minute=6, minutes=1)
        donor = server(pkg, donor_store, peers=[]).start()
        dest_store = store(pkg)
        dest = server(pkg, dest_store, peers=[donor.url], replication_interval_s=3600,
                      bootstrap_lag_owners=1).start()
        try:
            wait_for(lambda: state(dest_store) == state(donor_store), "the bootstrap")
            with urllib.request.urlopen(dest.url + "/stats", timeout=10) as r:
                (peer,) = json.loads(r.read())["replication"]["peers"]
            with urllib.request.urlopen(donor.url + "/stats", timeout=10) as r:
                snap = json.loads(r.read())["replication"]["snapshot"]
            return state(dest_store), peer, snap
        finally:
            stop_all([dest, donor])

    want, jpeer, jsnap = within(LIMIT_S, lambda: drive(JAX))
    got, peer, snap = within(LIMIT_S, lambda: drive(PORT))
    assert got == want and set(peer) == set(jpeer) and set(snap) == set(jsnap)
    assert peer["snapshot_bootstraps"] == 1 and peer["snapshot_chunks_fetched"] >= 1
    assert peer["snapshot_bytes_fetched"] > 0 and peer["messages_pulled"] == 0
    assert snap["captures"] >= 1 and snap["chunks_served"] >= 1 and snap["capture_rows"] >= 30


def _scoped_donor(pkg):
    """Two owners over two minutes, with lanes recorded for owner000's rows
    (alternating lanes "lane-a" and "lane-b", as a scoped push records
    them); owner001's rows have no lane."""
    from importlib import import_module

    st = store(pkg)
    seed(pkg, st, owners=2, per_minute=6, minutes=2)
    scope = import_module(pkg.relay.__name__.rsplit(".", 1)[0] + ".scope")
    scope.record_push_lanes(st.db, "owner000", [m.timestamp for m in st.replica_messages("owner000", "")],
                            ["lane-a", "lane-b"] * 6)
    return st


def test_scoped_snapshot_is_refused():
    """A scoped capture (a watermark, lane tags, or both), refused until
    scoped sync was ported, equals the JAX package's byte for byte, with
    each owner's tree regenerated from the kept rows, and installs into a
    fresh store as the JAX one does. A scoped `/replicate/snapshot`
    answers the JAX donor's manifest (up to the snapshot id) and chunks;
    the capture counts as scoped."""
    wm = BASE + MINUTE + 1_000
    for kw in ({"watermark_millis": wm}, {"tags": ("lane-a",)}, {"watermark_millis": wm, "tags": ("lane-a",)}):
        got, want = ([pkg.snap.capture_snapshot(_scoped_donor(pkg), snapshot_id="s", **kw) for pkg in (PORT, JAX)])
        assert PORT.proto.encode_snapshot_manifest(got[0]) == JAX.proto.encode_snapshot_manifest(want[0]), kw
        assert got[1] == want[1], kw
        installed = []
        for pkg, (manifest, chunks) in ((PORT, got), (JAX, want)):
            dest = store(pkg)
            pkg.snap.install_stream(dest, manifest, chunks)
            installed.append(state(dest))
        assert installed[0] == installed[1]
        kept = {u: [t for t, _c in rows] for u, (_tree, rows) in installed[0].items()}
        if "watermark_millis" in kw:
            assert all(t >= "2023-11-14T22:14:21" for ts in kept.values() for t in ts)
        if "tags" in kw:  # owner000's lane-b rows withheld; owner001's unknown lanes served
            assert len(kept["owner000"]) < len(kept["owner001"])

    def drive(pkg):
        before = dict(PORT.snap.counts)
        donor = server(pkg, _scoped_donor(pkg), peers=[]).start()
        try:
            post = fast_post(pkg)
            req = pkg.proto.SnapshotRequest("r", 0, (), wm, ("lane-a",))
            manifest = pkg.proto.decode_snapshot_manifest(post(donor.url + "/replicate/snapshot",
                                                               pkg.proto.encode_snapshot_request(req)))
            chunks = [pkg.proto.decode_snapshot_chunk(post(
                donor.url + "/replicate/snapshot/chunk",
                pkg.proto.encode_snapshot_chunk_request(pkg.proto.SnapshotChunkRequest(manifest.snapshot_id, i, "r"))
            )).payload for i in range(len(manifest.chunk_sizes))]
            manifest = pkg.proto.encode_snapshot_manifest(dataclasses.replace(manifest, snapshot_id=""))
            return manifest, chunks, PORT.snap.counts["scoped_captures"] - before["scoped_captures"]
        finally:
            donor.stop()

    want, got = within(LIMIT_S, lambda: drive(JAX)), within(LIMIT_S, lambda: drive(PORT))
    assert got[:2] == want[:2] and PORT.proto.decode_snapshot_manifest(got[0]).message_count > 0
    assert got[2] == 1 and want[2] == 0  # the port's donor captured once, scoped


@pytest.mark.parametrize("donor_pkg,puller_pkg", [(JAX, PORT), (PORT, JAX)], ids=["jax_donor", "port_donor"])
def test_snapshot_installs_across_packages(donor_pkg, puller_pkg):
    """A JAX donor's snapshot installs into a port relay and a port donor's
    into a JAX relay, in chunks of 64 KiB; a later donor write arrives by
    gossip; both end byte-identical."""

    def drive():
        donor_store = store(donor_pkg, shards=2)
        seed(donor_pkg, donor_store, owners=12, per_minute=30, minutes=3, payload=b"q" * 60)
        donor = server(donor_pkg, donor_store, peers=[]).start()
        dest = store(puller_pkg)
        mgr = puller_pkg.rep.ReplicationManager(dest, [donor.url], replica_id="cross",
                                                http_post=fast_post(puller_pkg), bootstrap_lag_owners=1,
                                                snapshot_chunk_bytes=64 * 1024)
        try:
            mgr.run_once()
            first = state(dest) == state(donor_store)
            donor_store.add_messages("owner002", msgs(donor_pkg, "7" * 16, 20, 0, 9))
            mgr.run_once()
            return first, state(dest) == state(donor_store), len(state(dest))
        finally:
            mgr.stop()
            donor.stop()
            dest.close()

    assert within(LIMIT_S, drive) == (True, True, 12)
