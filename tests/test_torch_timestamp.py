"""Port parity: the HLC send and receive rules and the batch receive fold.

`send_timestamp`, `receive_timestamp` and `receive_timestamps_batch` of
the port against the JAX package's on the same inputs: equal timestamps,
or the same error type with the same payload (drift, counter overflow,
duplicate node). Small hypothesis cases, derandomized so every run draws
the same examples."""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

import evolu_tpu.core.timestamp as jts
import evolu_tpu.core.types as jt
import evolu_tpu_torch.core.timestamp as pts
import evolu_tpu_torch.core.types as pt

SETTINGS = settings(max_examples=150, derandomize=True, deadline=None)
NOW = 1_700_000_000_000
NODES = ("0000000000000001", "00000000000000ab", "ffffffffffffffff", "00000000000000AB")
# Millis near `now` so ties, drift and counter rules all come up.
millis = st.integers(NOW - 3, NOW + 70_000)
counter = st.one_of(st.integers(0, 4), st.integers(65_530, 65_535))
node = st.sampled_from(NODES)


def outcome(fn, *args):
    """(result fields) or (error type, payload) of one call."""
    try:
        t = fn(*args)
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return ("error", type(e).__name__, e.to_dict() if hasattr(e, "to_dict") else str(e))
    return ("ok", t.millis, t.counter, t.node)


@SETTINGS
@given(millis, counter, node, st.integers(NOW - 2, NOW + 2), st.sampled_from((60_000, 0, 5)))
def test_send_timestamp_matches_jax(m, c, n, now, drift):
    assert outcome(pts.send_timestamp, pt.Timestamp(m, c, n), now, drift) == \
        outcome(jts.send_timestamp, jt.Timestamp(m, c, n), now, drift)


@SETTINGS
@given(millis, counter, node, millis, counter, node, st.integers(NOW - 2, NOW + 2))
def test_receive_timestamp_matches_jax(lm, lc, ln, rm, rc, rn, now):
    assert outcome(pts.receive_timestamp, pt.Timestamp(lm, lc, ln), pt.Timestamp(rm, rc, rn), now) == \
        outcome(jts.receive_timestamp, jt.Timestamp(lm, lc, ln), jt.Timestamp(rm, rc, rn), now)


@SETTINGS
@given(millis, counter, node,
       st.lists(st.tuples(millis, counter, node), min_size=0, max_size=12),
       st.integers(NOW - 2, NOW + 70_000), st.sampled_from((60_000, 100)))
def test_receive_batch_matches_jax(lm, lc, ln, remote, now, drift):
    r_millis = np.array([r[0] for r in remote], np.int64)
    r_counter = np.array([r[1] for r in remote], np.int64)
    r_nodes = [r[2] for r in remote]
    got = outcome(pts.receive_timestamps_batch, pt.Timestamp(lm, lc, ln), r_millis, r_counter, r_nodes,
                  now, drift)
    assert got == outcome(jts.receive_timestamps_batch, jt.Timestamp(lm, lc, ln), r_millis, r_counter,
                          r_nodes, now, drift)


def test_receive_batch_errors_and_closed_form():
    """The three errors through the batch fold, and a long tied run that
    the closed form serves, each equal to JAX."""
    local = ("0000000000000001", NOW, 5)
    cases = {
        "drift": ([NOW + 120_000], [0], ["00000000000000ab"]),
        "counter overflow": ([NOW, NOW], [65_535, 3], ["00000000000000ab"] * 2),
        "duplicate node": ([NOW - 5, NOW], [0, 0], ["00000000000000ab", "0000000000000001"]),
        "closed form": (list(range(NOW - 500, NOW + 500)), [7] * 1000, ["00000000000000ab"] * 1000),
    }
    seen = set()
    for name, (m, c, n) in cases.items():
        m, c = np.array(m, np.int64), np.array(c, np.int64)
        got = outcome(pts.receive_timestamps_batch, pt.Timestamp(local[1], local[2], local[0]), m, c, n, NOW)
        want = outcome(jts.receive_timestamps_batch, jt.Timestamp(local[1], local[2], local[0]), m, c, n, NOW)
        assert got == want, name
        seen.add(got[1] if got[0] == "error" else "ok")
    assert seen == {"TimestampDriftError", "TimestampCounterOverflowError",
                    "TimestampDuplicateNodeError", "ok"}


def test_initial_and_sync_timestamps():
    assert pts.create_sync_timestamp(12345) == pt.Timestamp(12345, 0, jts.SYNC_NODE_ID)
    t = pts.create_initial_timestamp()
    assert (t.millis, t.counter, len(t.node)) == (0, 0, 16)
    assert pts.timestamp_to_string(pts.create_initial_timestamp("0123456789abcdef")) == \
        jts.timestamp_to_string(jts.create_initial_timestamp("0123456789abcdef"))
