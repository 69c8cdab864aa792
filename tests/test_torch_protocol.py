"""The port's sync wire codecs against the JAX package's.

The same requests and responses, drawn by hypothesis (derandomized),
encode to the same bytes in both packages and decode back to the same
fields; arbitrary bytes decode to the same fields in both or raise
ValueError in both."""

from hypothesis import given, settings
from hypothesis import strategies as st

import evolu_tpu.sync.protocol as jp
import evolu_tpu_torch.sync.protocol as pp

_text = st.text(max_size=12)
_ts = st.text(alphabet="0123456789-:.TZABCDEFabcdef", min_size=0, max_size=46)
_msgs = st.lists(st.tuples(_ts, st.binary(max_size=40)), max_size=6)
_caps = st.lists(st.sampled_from(pp.KNOWN_CAPABILITIES + ("x-unknown",)), max_size=4)
_scope = st.one_of(st.none(), st.tuples(st.integers(0, 2**62), st.lists(_text, max_size=3)))


def _pair(msgs, user, node, tree, caps, scope):
    """The same SyncRequest in both packages."""
    out = []
    for m in (jp, pp):
        sc = None
        if scope is not None:
            wm, tags = scope
            sc = m.ScopeClause(wm, tuple(tags), tuple("" for _ in msgs) if tags else ())
        out.append(m.SyncRequest(tuple(m.EncryptedCrdtMessage(t, c) for t, c in msgs),
                                 user, node, tree, tuple(caps), sc))
    return out


def _fields(obj):
    """A decoded message of either package as plain tuples."""
    if obj is None or isinstance(obj, (str, bytes, int)):
        return obj
    if isinstance(obj, tuple):
        return tuple(_fields(x) for x in obj)
    return (type(obj).__name__, *(_fields(v) for v in vars(obj).values()))


@settings(derandomize=True, max_examples=150, deadline=None)
@given(_msgs, _text, _text, _text, _caps, _scope)
def test_sync_request_bytes_and_round_trip(msgs, user, node, tree, caps, scope):
    jr, pr = _pair(msgs, user, node, tree, caps, scope)
    data = pp.encode_sync_request(pr)
    assert data == jp.encode_sync_request(jr)
    assert pp.decode_sync_request(data) == pr
    assert _fields(pp.decode_sync_request(data)) == _fields(jp.decode_sync_request(data))


@settings(derandomize=True, max_examples=150, deadline=None)
@given(_msgs, _text, _caps)
def test_sync_response_bytes_and_round_trip(msgs, tree, caps):
    jr = jp.SyncResponse(tuple(jp.EncryptedCrdtMessage(t, c) for t, c in msgs), tree, tuple(caps))
    pr = pp.SyncResponse(tuple(pp.EncryptedCrdtMessage(t, c) for t, c in msgs), tree, tuple(caps))
    data = pp.encode_sync_response(pr)
    assert data == jp.encode_sync_response(jr)
    assert pp.decode_sync_response(data) == pr
    assert pp.scan_sync_response_capabilities(data) == jp.scan_sync_response_capabilities(data)
    for m in pr.messages:
        enc = pp.encode_encrypted_message(m)
        assert enc == jp.encode_encrypted_message(jp.EncryptedCrdtMessage(m.timestamp, m.content))
        assert pp.decode_encrypted_message(enc) == m


def _decode_both(fn_name, data):
    out = []
    for m in (jp, pp):
        try:
            out.append(_fields(getattr(m, fn_name)(data)))
        except ValueError:
            out.append(ValueError)
    return out


@settings(derandomize=True, max_examples=300, deadline=None)
@given(st.binary(max_size=64))
def test_decoders_agree_on_arbitrary_bytes(data):
    for name in ("decode_sync_request", "decode_sync_response", "decode_encrypted_message",
                 "decode_scope_clause", "scan_sync_response_capabilities"):
        j, p = _decode_both(name, data)
        assert p == j, name


def test_decoders_refuse_what_the_jax_package_refuses():
    """Hostile shapes: a varint content field, too many capabilities,
    push tags that do not match the messages, a negative watermark."""
    cases = {
        "decode_encrypted_message": pp._tag(2, 0) + pp._varint(10**9),
        "decode_sync_response": b"".join(pp._string(3, "c") for _ in range(pp._MAX_CAPABILITIES + 1)),
        "decode_sync_request": pp._len_delimited(6, pp._string(3, "tag")),
        "decode_scope_clause": pp._tag(1, 0) + pp._varint(-5),
    }
    for name, data in cases.items():
        assert _decode_both(name, data) == [ValueError, ValueError], name
