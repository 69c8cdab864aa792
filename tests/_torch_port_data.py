"""Shared inputs for the `evolu_tpu_torch` parity tests.

Messages are made once as plain tuples from a numpy seed and then built
as each package's own `CrdtMessage`, so the JAX reference and the port
see the same batches.
"""

import numpy as np
import evolu_tpu.core.types as jt
import evolu_tpu_torch.core.types as pt
from evolu_tpu_torch.core.timestamp import timestamp_to_string

BASE_MILLIS = 1_700_000_000_000
COLUMNS = {"todo": ("title", "isCompleted"), "todoCategory": ("name",)}


def ts_string(millis, counter, node, upper_node=False):
    node_hex = f"{int(node):016x}"
    return timestamp_to_string(
        pt.Timestamp(int(millis), int(counter), node_hex.upper() if upper_node else node_hex)
    )


def message_tuples(rng, n, n_rows=8, n_nodes=4, span_ms=3_600_000, upper_node=False,
                   dup_frac=0.1, millis=BASE_MILLIS):
    """n (timestamp, table, row, column, value) tuples with cell
    contention, HLC ties and exact re-deliveries."""
    out = []
    nodes = rng.integers(0, 2**64, n_nodes, dtype=np.uint64)
    for _ in range(n):
        if out and rng.random() < dup_frac:
            out.append(out[int(rng.integers(0, len(out)))])
            continue
        table = ("todo", "todoCategory")[int(rng.integers(0, 2))]
        column = COLUMNS[table][int(rng.integers(0, len(COLUMNS[table])))]
        row = f"row{int(rng.integers(0, n_rows)):017d}ab"
        ts = ts_string(millis + int(rng.integers(0, span_ms)), int(rng.integers(0, 4)),
                       nodes[int(rng.integers(0, n_nodes))], upper_node=upper_node)
        value = (None, "x", int(rng.integers(0, 100)), 1.5)[int(rng.integers(0, 4))]
        out.append((ts, table, row, column, value))
    return out


def stored_winners(rng, tuples, frac=0.6, upper_node=False):
    """{cell: timestamp} for about `frac` of the cells in `tuples`, drawn
    from the same time window (so about half the messages lose)."""
    cells = sorted({(t, r, c) for _, t, r, c, _ in tuples})
    out = {}
    for cell in cells:
        if rng.random() < frac:
            out[cell] = ts_string(BASE_MILLIS + int(rng.integers(0, 3_600_000)),
                                  int(rng.integers(0, 4)), rng.integers(0, 2**64, dtype=np.uint64),
                                  upper_node=upper_node)
    return out


def jax_messages(tuples):
    return [jt.CrdtMessage(*t) for t in tuples]


def port_messages(tuples):
    return [pt.CrdtMessage(*t) for t in tuples]


def as_tuples(messages):
    return [(m.timestamp, m.table, m.row, m.column, m.value) for m in messages]


# --- typed-CRDT traffic (counter, awset, list, tensor) ---

TYPED_TABLE = "board"
TYPED_COLUMNS = ("title", "votes:counter", "tags:awset", "body:list",
                 "w:tensor:sum:f32:2", "avg:tensor:mean:bf16:2", "peak:tensor:max:f32:2")
_MALFORMED = ("x", "[]", '["z",1]', '["d","%%%"]', 2**40, True, None, '["i",5,"v"]', '["r","e",5]')


def _tensor_value(rng, monoid, kind):
    """A tensor op value for width 2, built by hand (base64 of the
    declared dtype's bytes) so both packages decode the same string."""
    import base64
    import json

    v = np.round(rng.uniform(-100, 100, 2), 2)
    if monoid == "mean":  # bf16 column: bf16-representable values
        v = v.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
        payload = (v >> np.uint32(16)).astype("<u2").tobytes()
        return json.dumps([kind, base64.b64encode(payload).decode(), int(rng.integers(1, 5))],
                          separators=(",", ":"))
    payload = v.astype("<f4").tobytes()
    return json.dumps([kind, base64.b64encode(payload).decode()], separators=(",", ":"))


def typed_tuples(rng, n, n_rows=6, malformed_frac=0.05, millis=BASE_MILLIS):
    """n typed-traffic tuples in logical time order, timestamps unique
    per message: counter deltas; set adds and removes that observe
    earlier add tags; list inserts anchored on earlier elements (head,
    or a dangling origin) and deletes of earlier elements; tensor set
    and delta ops; LWW titles; a few malformed values. Shuffling the
    result delivers kills before adds and inserts anchored on deleted
    elements."""
    import json

    nodes = rng.integers(0, 2**64, 4, dtype=np.uint64)
    adds, inserts, out = {}, {}, []
    for i in range(n):
        ts = ts_string(millis + 7 * i, int(rng.integers(0, 4)), nodes[int(rng.integers(0, 4))])
        row = f"r{int(rng.integers(0, n_rows))}"
        col = ("title", "votes", "tags", "body", "w", "avg", "peak")[int(rng.integers(0, 7))]
        cell = (row, col)
        if col != "title" and rng.random() < malformed_frac:
            value = _MALFORMED[int(rng.integers(0, len(_MALFORMED)))]
        elif col == "title":
            value = f"t{i}"
        elif col == "votes":
            value = int(rng.integers(-1000, 1000))
        elif col == "tags":
            elem = ("red", "blue", 7)[int(rng.integers(0, 3))]
            seen = adds.setdefault(cell, [])
            if seen and rng.random() < 0.35:
                observed = sorted({seen[int(k)] for k in rng.integers(0, len(seen), 3)})
                value = json.dumps(["r", elem, observed], separators=(",", ":"))
            else:
                value = json.dumps(["a", elem], separators=(",", ":"))
                seen.append(ts)
        elif col == "body":
            seen = inserts.setdefault(cell, [])
            if seen and rng.random() < 0.3:
                value = json.dumps(["d", seen[int(rng.integers(0, len(seen)))]], separators=(",", ":"))
            else:
                roll = rng.random()
                origin = ("" if roll < 0.2 or not seen else
                          "2099-01-01T00:00:00.000Z-0000-ffffffffffffffff" if roll < 0.3 else
                          seen[int(rng.integers(0, len(seen)))])
                value = json.dumps(["i", origin, f"v{i}"], separators=(",", ":"))
                seen.append(ts)
        else:
            monoid = {"w": "sum", "avg": "mean", "peak": "max"}[col]
            value = _tensor_value(rng, monoid, "s" if rng.random() < 0.15 else "d")
        out.append((ts, TYPED_TABLE, row, col, value))
    return out


def typed_batches(seed, n=600, n_batches=4):
    """Shuffled typed traffic cut into batches, then a re-delivery batch
    of messages already applied."""
    rng = np.random.default_rng(seed)
    msgs = typed_tuples(rng, n)
    order = rng.permutation(len(msgs))
    msgs = [msgs[i] for i in order]
    cut = len(msgs) // n_batches
    batches = [msgs[i * cut:(i + 1) * cut] for i in range(n_batches - 1)]
    batches.append(msgs[(n_batches - 1) * cut:])
    batches.append([msgs[int(i)] for i in rng.integers(0, len(msgs), len(msgs) // 5)])
    return batches


def within(seconds, fn):
    """Run `fn` on a daemon thread and return its result; fail if it has
    not returned after `seconds`, so a hung worker, transport or watcher
    thread fails its test rather than the whole run."""
    import threading

    import pytest

    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised on the test thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"did not finish within {seconds} s")
    if "error" in box:
        raise box["error"]
    return box["value"]
