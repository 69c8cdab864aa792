"""Port parity: the fused native crypto leg (`sync.native_crypto`).

The port's own build of the unchanged `native/evolu_crypto.cpp` against
the JAX package's: the columnar response decode on bytes the JAX package
encrypted (every `PackedReceive` array, the cells and the tree), the
batch and push encoders decrypted by the other package's pure decoder
and the other way round, the frozen gpg goldens, and every demotion
shape (None, or the same exception as the JAX package). Outputs are
bytes, integers and strings: equality is exact. Ciphertexts carry
random salts and IVs, so they are compared after decryption."""

from pathlib import Path

import numpy as np
import pytest

from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.core.types import CrdtMessage as JaxMessage
from evolu_tpu.sync import aead as jaead
from evolu_tpu.sync import native_crypto as jnc
from evolu_tpu.sync import protocol as jproto
from evolu_tpu.sync.client import decrypt_messages as jax_pure_decrypt_batch
from evolu_tpu.sync.crypto import PgpError as JaxPgpError
from evolu_tpu.sync.crypto import encrypt_symmetric as jax_encrypt_symmetric

from evolu_tpu_torch.core.packed import PackedReceive
from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.sync import aead as paead
from evolu_tpu_torch.sync import client as pclient
from evolu_tpu_torch.sync import native_crypto as pnc
from evolu_tpu_torch.sync import protocol as pproto
from evolu_tpu_torch.sync.crypto import PgpError

FIXTURES = Path(__file__).parent / "fixtures"
MN = "legal winner thank year wave sausage worth useful legal winner thank yellow"
BASE = 1_700_000_000_000
ARRAYS = ("ts_slab", "cell_id", "vkinds", "ivals", "dvals", "vlens", "voffs", "vblob", "cell_blob",
          "cell_lens")


def _tuples(n, seed=0):
    """n messages with unique timestamps: unicode, NUL-bearing, empty and
    int64-extreme values, floats, None, over a few hundred cells."""
    rng = np.random.default_rng(seed)
    values = (None, "título ✓ café", "x\x00y", "", 2**63 - 1, -(2**63), 7, 0.25, -1e300, True)
    out = []
    for i in range(n):
        ts = timestamp_to_string(Timestamp(BASE + 977 * (i // 3), i % 3,
                                           ("a1b2c3d4e5f60718", "ffeeddccbbaa9988")[i % 2]))
        out.append((ts, ("todo", "todoCategory")[int(rng.integers(0, 2))], f"row{int(rng.integers(0, n // 4 + 1))}",
                    ("title", "isCompleted", "ñame")[int(rng.integers(0, 3))],
                    values[int(rng.integers(0, len(values)))]))
    return out


def _jax_response(tuples, tree='{"hash":1}', contents=None):
    enc = contents if contents is not None else jnc.encrypt_batch([JaxMessage(*t) for t in tuples], MN)
    return jproto.encode_sync_response(jproto.SyncResponse(tuple(enc), tree))


def _plain(m):
    return (m.timestamp, m.table, m.row, m.column, m.value)


def test_columnar_decode_matches_jax():
    tuples = _tuples(600)
    body = _jax_response(tuples)
    (ppb, ptree), (jpb, jtree) = pnc.decrypt_response_columns(body, MN), jnc.decrypt_response_columns(body, MN)
    assert isinstance(ppb, PackedReceive) and ptree == jtree == '{"hash":1}'
    assert ppb.n == jpb.n == 600 and ppb.cells == jpb.cells
    for name in ARRAYS:
        g, w = getattr(ppb, name), getattr(jpb, name)
        assert (g == w if isinstance(g, bytes) else np.array_equal(g, w)), name
    assert [_plain(m) for m in ppb.to_messages()] == [_plain(m) for m in jpb.to_messages()] == tuples
    for a, b in ((0, 600), (17, 333), (599, 600)):
        assert [_plain(m) for m in ppb[a:b].to_messages()] == tuples[a:b]
    for g, w in zip(ppb.parse_timestamps(), jpb.parse_timestamps()):
        assert np.array_equal(g, w)
    assert [_plain(m) for m in pnc.decrypt_response(body, MN)[0]] == tuples


def test_cross_decryption_both_ways():
    """Each package's batch encrypt and fused push bodies (v1 and v2)
    decrypt to the same messages through the other package's pure
    decoder."""
    tuples = _tuples(120, seed=1)
    pmsgs, jmsgs = [CrdtMessage(*t) for t in tuples], [JaxMessage(*t) for t in tuples]
    for enc, dec in ((pnc.encrypt_batch(pmsgs, MN), jax_pure_decrypt_batch),
                     (jnc.encrypt_batch(jmsgs, MN), pclient.decrypt_messages_pure)):
        assert [_plain(m) for m in dec(enc, MN)] == tuples
    key_salt = jaead.get_session(MN, records=len(tuples))
    for body, decode, dec in (
        (pnc.encode_push_request(pmsgs, MN, "owner", "n" * 16, "{}"), jproto.decode_sync_request,
         jax_pure_decrypt_batch),
        (pnc.encode_push_request_aead(pmsgs, key_salt.key, key_salt.salt, "owner", "n" * 16, "{}"),
         jproto.decode_sync_request, jax_pure_decrypt_batch),
        (jnc.encode_push_request(jmsgs, MN, "owner", "n" * 16, "{}"), pproto.decode_sync_request,
         pclient.decrypt_messages_pure),
        (jnc.encode_push_request_aead(jmsgs, key_salt.key, key_salt.salt, "owner", "n" * 16, "{}"),
         pproto.decode_sync_request, pclient.decrypt_messages_pure),
    ):
        req = decode(body)
        assert (req.user_id, req.node_id, req.merkle_tree) == ("owner", "n" * 16, "{}")
        assert [_plain(m) for m in dec(req.messages, MN)] == tuples
    # The port's blob lane of the v2 encoder, behind its CPython-ABI lane.
    pnc._PY_PUSH, saved = None, pnc._PY_PUSH
    try:
        body = pnc.encode_push_request_aead(pmsgs, key_salt.key, key_salt.salt, "o", "n" * 16, "{}")
    finally:
        pnc._PY_PUSH = saved
    assert [_plain(m) for m in jax_pure_decrypt_batch(jproto.decode_sync_request(body).messages, MN)] == tuples


def test_gpg_goldens_decrypt_through_the_batch():
    """The frozen gpg fixtures: 'none' on the canonical fast path, zip and
    zlib (compressed data) demoted to the oracle; the same result."""
    expected = pproto.decode_content((FIXTURES / "gpg_plaintext.bin").read_bytes())
    for name in ("gpg_aes256_s2k1024_none.pgp", "gpg_aes256_s2k1024_zip.pgp", "gpg_aes256_s2k1024_zlib.pgp"):
        enc = (pproto.EncryptedCrdtMessage("t", (FIXTURES / name).read_bytes()),)
        (out,) = pnc.decrypt_batch(enc, MN)
        assert (out.table, out.row, out.column, out.value) == expected, name


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the exception is the outcome compared
        return (type(e).__name__, str(e))


def test_demotions_match_jax():
    """Each demotion shape: `decrypt_response_columns` gives None in both
    packages, and the object decoders give the same messages or the same
    exception."""
    tuples = _tuples(8, seed=2)
    good = list(jnc.encrypt_batch([JaxMessage(*t) for t in tuples], MN))
    ts46 = tuples[0][0]
    gpg = (FIXTURES / "gpg_aes256_s2k1024_zip.pgp").read_bytes()
    tampered = bytearray(good[1].content)
    tampered[-1] ^= 1  # inside the MDC trailer
    bad_utf8 = jax_encrypt_symmetric(b"\x0a\x02t\xff" + b"\x12\x01r" + b"\x1a\x01c", MN)
    shapes = {
        "non-46 timestamp": (good[:2] + [jproto.EncryptedCrdtMessage("short-ts", good[2].content)], MN),
        "compressed gpg row": (good[:3] + [jproto.EncryptedCrdtMessage(ts46, gpg)], MN),
        "invalid UTF-8": ([jproto.EncryptedCrdtMessage(ts46, bad_utf8)], MN),
        "wrong password": (good, "not the password"),
        "tampered MDC": (good[:1] + [jproto.EncryptedCrdtMessage(ts46, bytes(tampered))], MN),
    }
    for name, (contents, password) in shapes.items():
        body = _jax_response(None, "{}", contents)
        assert pnc.decrypt_response_columns(body, password) is None, name
        assert jnc.decrypt_response_columns(body, password) is None, name

        def port():
            fused = pnc.decrypt_response(body, password)
            if fused is None:
                resp = pproto.decode_sync_response(body)
                return [_plain(m) for m in pnc.decrypt_batch(resp.messages, password)]
            return [_plain(m) for m in fused[0]]

        def jax():
            fused = jnc.decrypt_response(body, password)
            if fused is None:
                resp = jproto.decode_sync_response(body)
                return [_plain(m) for m in jnc.decrypt_batch(resp.messages, password)]
            return [_plain(m) for m in fused[0]]

        assert _outcome(port) == _outcome(jax), name
    with pytest.raises(PgpError, match="wrong password"):
        pnc.decrypt_batch([pproto.EncryptedCrdtMessage(m.timestamp, m.content) for m in good], "nope")
    with pytest.raises(JaxPgpError, match="wrong password"):
        jnc.decrypt_batch(good, "nope")
    assert pnc.decrypt_response_columns(_jax_response(tuples)[:-1], MN) is None


def test_unencodable_values_leave_the_error_to_the_pure_loop():
    bad = [CrdtMessage(tuples[0], "t", "r", "c", v) for tuples in [_tuples(1)[0]] for v in (b"b", 2**64)]
    for m in bad:
        assert pnc.encrypt_batch([m], MN) is None
        assert pnc.encode_push_request([m], MN, "o", "n" * 16, "{}") is None
        with pytest.raises(TypeError):
            pclient.encrypt_messages([m], MN)


def test_transport_decodes_a_response_through_the_packed_leg():
    """`SyncTransport._decode_response` takes the columnar leg first and
    the object decoders behind it, with the same messages."""
    from evolu_tpu_torch.utils.config import Config

    t = pclient.SyncTransport(Config(), on_receive=lambda *a: None)
    try:
        tuples = _tuples(50, seed=3)
        packed, tree = t._decode_response(_jax_response(tuples, "{}"), MN)
        assert isinstance(packed, PackedReceive) and tree == "{}"
        assert [_plain(m) for m in packed.to_messages()] == tuples
        contents = list(jnc.encrypt_batch([JaxMessage(*x) for x in tuples], MN))
        contents[4] = jproto.EncryptedCrdtMessage(tuples[4][0], (FIXTURES / "gpg_aes256_s2k1024_zip.pgp")
                                                  .read_bytes())
        msgs, _tree = t._decode_response(_jax_response(None, "{}", contents), MN)
        assert isinstance(msgs, tuple) and len(msgs) == 50
        v2 = jaead.get_session(MN, records=1)
        rec = jaead.encrypt_record(v2.key, v2.salt, jproto.encode_content("t", "r", "c", 5))
        body = _jax_response(None, "{}", [jproto.EncryptedCrdtMessage(tuples[0][0], rec)])
        packed, _tree = t._decode_response(body, MN)  # v2 records decode columnar too
        assert paead.is_v2_record(rec) and isinstance(packed, PackedReceive)
        assert [_plain(m) for m in packed.to_messages()] == [(tuples[0][0], "t", "r", "c", 5)]
    finally:
        t.stop()
