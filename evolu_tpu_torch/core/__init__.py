"""Host-side CRDT primitives: types, HLC timestamps, murmur3, Merkle trie."""
