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
