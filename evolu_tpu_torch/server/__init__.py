"""The relay: message and Merkle storage for many owners (`relay`), and
the batched reconcile engine whose Merkle leg runs on the card
(`engine`)."""
