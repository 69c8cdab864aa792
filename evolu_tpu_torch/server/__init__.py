"""The relay: message and Merkle storage for many owners and the HTTP
server (`relay`, with `relay_worker` for its pre-forked processes), the
batched reconcile engine whose Merkle leg runs on the card (`engine`),
the continuous-batching scheduler between them (`scheduler`), and the
install state that `/health` reads (`snapshot`)."""
