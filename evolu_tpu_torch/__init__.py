"""evolu_tpu_torch — `evolu_tpu` on PyTorch and CUDA, for one NVIDIA
Hopper card.

A local-first data framework: reactive SQLite storage, a last-write-wins
CRDT over (table, row, column) cells with typed columns (counters,
add-wins sets, RGA lists, tensors), hybrid logical clocks, Merkle-tree
anti-entropy sync, end-to-end encryption, mnemonic-derived identity, and
a blind relay server with replication, snapshots, an owner-sharded
fleet, push subscriptions, write-behind storage and scoped sync. It
mirrors `evolu_tpu`'s public surface and gives its results: bit-identical
device arrays, byte-identical wire responses, Merkle trees and SQLite end
state.

The merge hot path runs on the card. The reconcile pass packs each
batch into one owner|cell|idx|flags sort key; two segmented lexicographic
max scans give the xor and upsert masks; each xor-masked row is hashed
(murmur3 of its canonical timestamp); an (owner, minute) segmented XOR
fold gives the Merkle deltas. Its kernels are hand-written CUDA C++
under `csrc/`, built with nvcc at first use: the segmented lex-max, XOR
and modular sum scans (`ops.cuda_scan`) and the timestamp hash
(`ops.cuda_hash`). The client worker (`runtime.worker.DbWorker`) plans
its batches through them, with each cell's stored winner kept in device
memory (`ops.winner_cache`); the relay's engine (`server.engine`) runs
the Merkle leg of every batch of sync requests through them; owners may
shard over a mesh of cards or processes (`parallel`).

Entry points:
- `create_evolu(schema, config=Config(...))` — the client handle;
  `connect(evolu)` attaches the encrypted sync transport;
- `RelayServer(RelayStore(path))` — the relay over HTTP;
- `python -m evolu_tpu_torch.examples.{relay_server,pod_server,todo_cli,
  web_todo}` — the deployable relay, the pod pass, the TodoMVC client and
  the web demo, each with `--device`.

Every entry point takes `device=None`, which means CUDA: without a card
it raises unless the caller passes `device="cpu"`, which runs the plain
PyTorch version of every kernel instead. The package imports neither
jax nor `evolu_tpu`; it keeps its own copies of the host helpers it
needs, under the same module names. Importing it loads nothing but this
file: each exported name loads its module on first use.
"""

from evolu_tpu_torch.utils.lazy import lazy_getattr

# The reference package's version: the relay's `evolu_build_info` reports it.
__version__ = "0.1.0"

# Every name loads on first access. The host-only core (timestamps,
# Merkle trees, types, ids, `Config`) could load eagerly as the
# reference's does, but `evolu_tpu_torch.obs` and `utils.log` are
# imported by processes that must load nothing else of the port (the
# relay's pre-forked workers; tests/test_torch_import_hygiene.py), and
# importing them runs this file first. The runtime, the relay and torch
# load only with their names, so the bare import starts no thread and
# initializes no CUDA.
_LAZY = {
    "Timestamp": ("evolu_tpu_torch.core.timestamp", "Timestamp"),
    "timestamp_to_string": ("evolu_tpu_torch.core.timestamp", "timestamp_to_string"),
    "timestamp_from_string": ("evolu_tpu_torch.core.timestamp", "timestamp_from_string"),
    "timestamp_to_hash": ("evolu_tpu_torch.core.timestamp", "timestamp_to_hash"),
    "send_timestamp": ("evolu_tpu_torch.core.timestamp", "send_timestamp"),
    "receive_timestamp": ("evolu_tpu_torch.core.timestamp", "receive_timestamp"),
    "create_initial_timestamp": ("evolu_tpu_torch.core.timestamp", "create_initial_timestamp"),
    "create_sync_timestamp": ("evolu_tpu_torch.core.timestamp", "create_sync_timestamp"),
    "create_initial_merkle_tree": ("evolu_tpu_torch.core.merkle", "create_initial_merkle_tree"),
    "insert_into_merkle_tree": ("evolu_tpu_torch.core.merkle", "insert_into_merkle_tree"),
    "diff_merkle_trees": ("evolu_tpu_torch.core.merkle", "diff_merkle_trees"),
    "merkle_tree_to_string": ("evolu_tpu_torch.core.merkle", "merkle_tree_to_string"),
    "merkle_tree_from_string": ("evolu_tpu_torch.core.merkle", "merkle_tree_from_string"),
    "CrdtMessage": ("evolu_tpu_torch.core.types", "CrdtMessage"),
    "NewCrdtMessage": ("evolu_tpu_torch.core.types", "NewCrdtMessage"),
    "CrdtClock": ("evolu_tpu_torch.core.types", "CrdtClock"),
    "TimestampDriftError": ("evolu_tpu_torch.core.types", "TimestampDriftError"),
    "TimestampCounterOverflowError": ("evolu_tpu_torch.core.types", "TimestampCounterOverflowError"),
    "TimestampDuplicateNodeError": ("evolu_tpu_torch.core.types", "TimestampDuplicateNodeError"),
    "SyncError": ("evolu_tpu_torch.core.types", "SyncError"),
    "EvoluError": ("evolu_tpu_torch.core.types", "EvoluError"),
    "create_id": ("evolu_tpu_torch.core.ids", "create_id"),
    "create_node_id": ("evolu_tpu_torch.core.ids", "create_node_id"),
    "mnemonic_to_owner_id": ("evolu_tpu_torch.core.ids", "mnemonic_to_owner_id"),
    "Config": ("evolu_tpu_torch.utils.config", "Config"),
    "Evolu": ("evolu_tpu_torch.runtime.client", "Evolu"),
    "create_evolu": ("evolu_tpu_torch.runtime.client", "create_evolu"),
    "create_hooks": ("evolu_tpu_torch.api.hooks", "create_hooks"),
    "Hooks": ("evolu_tpu_torch.api.hooks", "Hooks"),
    "QueryView": ("evolu_tpu_torch.api.hooks", "QueryView"),
    "QueryBuilder": ("evolu_tpu_torch.api.query", "QueryBuilder"),
    "table": ("evolu_tpu_torch.api.query", "table"),
    "fn": ("evolu_tpu_torch.api.query", "fn"),
    "model": ("evolu_tpu_torch.api", "model"),
    "connect": ("evolu_tpu_torch.sync.client", "connect"),
    "RelayServer": ("evolu_tpu_torch.server.relay", "RelayServer"),
    "RelayStore": ("evolu_tpu_torch.server.relay", "RelayStore"),
    "generate_mnemonic": ("evolu_tpu_torch.core.mnemonic", "generate_mnemonic"),
    "validate_mnemonic": ("evolu_tpu_torch.core.mnemonic", "validate_mnemonic"),
    "resolve_device": ("evolu_tpu_torch.ops", "resolve_device"),
}

__getattr__ = lazy_getattr(__name__, _LAZY)


__all__ = [
    "Timestamp",
    "timestamp_to_string",
    "timestamp_from_string",
    "timestamp_to_hash",
    "send_timestamp",
    "receive_timestamp",
    "create_initial_timestamp",
    "create_sync_timestamp",
    "create_initial_merkle_tree",
    "insert_into_merkle_tree",
    "diff_merkle_trees",
    "merkle_tree_to_string",
    "merkle_tree_from_string",
    "CrdtMessage",
    "NewCrdtMessage",
    "CrdtClock",
    "TimestampDriftError",
    "TimestampCounterOverflowError",
    "TimestampDuplicateNodeError",
    "SyncError",
    "EvoluError",
    "create_id",
    "create_node_id",
    "mnemonic_to_owner_id",
    "Config",
    "__version__",
    "Evolu",
    "create_evolu",
    "create_hooks",
    "Hooks",
    "QueryView",
    "QueryBuilder",
    "table",
    "fn",
    "model",
    "connect",
    "RelayServer",
    "RelayStore",
    "generate_mnemonic",
    "validate_mnemonic",
    "resolve_device",
]
