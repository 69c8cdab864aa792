"""Port parity: SQLite end state of the batched apply.

The port's `apply_messages(planner=plan_batch_device_full)` against the
JAX package's same call, and against the port's own sequential oracle,
on separate in-memory databases: every table dump and the Merkle tree
string must be byte-identical."""

import functools

import jax
import numpy as np
import pytest

from evolu_tpu.core.merkle import merkle_tree_to_string as jax_tree_string
from evolu_tpu.core.types import TableDefinition as JaxTable
from evolu_tpu.ops.merge import plan_batch_device_full as jax_planner
from evolu_tpu.storage import init_db_model as jax_init
from evolu_tpu.storage import update_db_schema as jax_update
from evolu_tpu.storage.apply import apply_messages as jax_apply
from evolu_tpu.storage.sqlite import PySqliteDatabase as JaxDb
from evolu_tpu_torch.core.merkle import merkle_tree_to_string
from evolu_tpu_torch.core.types import TableDefinition
from evolu_tpu_torch.ops.merge import plan_batch_device_full
from evolu_tpu_torch.storage import (
    PySqliteDatabase,
    apply_messages,
    apply_messages_sequential,
    init_db_model,
    update_db_schema,
)

from _torch_port_data import BASE_MILLIS, COLUMNS, jax_messages, message_tuples, port_messages, ts_string

MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
PORT_PLANNER = functools.partial(plan_batch_device_full, device="cpu")


def _port_db():
    db = PySqliteDatabase()
    init_db_model(db, MNEMONIC)
    update_db_schema(db, [TableDefinition.of(t, c) for t, c in COLUMNS.items()])
    return db


def _jax_db():
    db = JaxDb()
    jax_init(db, MNEMONIC)
    jax_update(db, [JaxTable.of(t, c) for t, c in COLUMNS.items()])
    return db


def _dump(db):
    return {t: db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2')
            for t in ("__message", *COLUMNS)}


def _batches(seed, non_canonical_batch=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(5):
        out.append(message_tuples(rng, int(rng.integers(20, 300)), n_rows=10,
                                  upper_node=i == non_canonical_batch, dup_frac=0.15))
    # Re-deliver part of the first batch: stored winners meet duplicates.
    out.append(out[0][::3])
    return out


@pytest.mark.parametrize("seed,non_canonical", [(0, None), (1, 2), (2, None)])
def test_apply_end_state_matches_jax(seed, non_canonical):
    batches = _batches(seed, non_canonical)
    pdb, jdb = _port_db(), _jax_db()
    ptree, jtree = {}, {}
    for b in batches:
        ptree = apply_messages(pdb, ptree, port_messages(b), planner=PORT_PLANNER)
        with jax.enable_x64(True):
            jtree = jax_apply(jdb, jtree, jax_messages(b), planner=jax_planner)
    assert _dump(pdb) == _dump(jdb)
    assert merkle_tree_to_string(ptree) == jax_tree_string(jtree)


@pytest.mark.parametrize("seed,non_canonical", [(3, None), (4, 1)])
def test_apply_end_state_matches_sequential_oracle(seed, non_canonical):
    batches = _batches(seed, non_canonical)
    db, oracle = _port_db(), _port_db()
    tree, oracle_tree = {}, {}
    for b in batches:
        tree = apply_messages(db, tree, port_messages(b), planner=PORT_PLANNER)
        oracle_tree = apply_messages_sequential(oracle, oracle_tree, port_messages(b))
    assert _dump(db) == _dump(oracle)
    assert merkle_tree_to_string(tree) == merkle_tree_to_string(oracle_tree)


def test_host_planner_matches_sequential_oracle():
    batches = _batches(5)
    db, oracle = _port_db(), _port_db()
    tree, oracle_tree = {}, {}
    for b in batches:
        tree = apply_messages(db, tree, port_messages(b))
        oracle_tree = apply_messages_sequential(oracle, oracle_tree, port_messages(b))
    assert _dump(db) == _dump(oracle)
    assert merkle_tree_to_string(tree) == merkle_tree_to_string(oracle_tree)


@pytest.mark.parametrize("device_planner", [False, True])
def test_redelivered_loser_is_xored_again_as_in_jax(device_planner):
    """A pinned fault of the reference that the port keeps (ROADMAP queue
    3 item 2): re-delivering a message that lost its cell XORs its hash
    into the client's tree a second time, so the tree leaves the relay's
    (which stores by timestamp and XORs each once). A re-delivered winner
    leaves the tree as it is. Port and JAX trees and tables stay equal at
    each step; exact comparison."""
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync.protocol import EncryptedCrdtMessage

    row = "row00000000000000001ab"
    loser = (ts_string(BASE_MILLIS, 0, 1), "todo", row, "title", "old")
    winner = (ts_string(BASE_MILLIS + 1_000, 0, 2), "todo", row, "title", "new")
    port_planner, jax_plan = (PORT_PLANNER, jax_planner) if device_planner else (None, None)
    pdb, jdb = _port_db(), _jax_db()
    ptree, jtree, trees = {}, {}, []
    for batch in ([loser, winner], [loser], [winner]):
        ptree = apply_messages(pdb, ptree, port_messages(batch), planner=port_planner)
        with jax.enable_x64(True):
            jtree = jax_apply(jdb, jtree, jax_messages(batch), planner=jax_plan)
        assert _dump(pdb) == _dump(jdb)
        assert merkle_tree_to_string(ptree) == jax_tree_string(jtree)
        trees.append(merkle_tree_to_string(ptree))
    relay = RelayStore(backend="python")
    relay.add_messages("owner", [EncryptedCrdtMessage(t[0], b"x") for t in (loser, winner, loser)])
    assert trees[0] == relay.get_merkle_tree_string("owner")
    assert trees[1] != trees[0], "the re-delivered loser no longer changes the tree"
    assert trees[2] == trees[1]
