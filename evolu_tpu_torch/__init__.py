"""evolu_tpu_torch — the LWW reconcile pass, the typed-CRDT apply and
the client worker on PyTorch and CUDA.

A port of `evolu_tpu`'s merge hot path to one NVIDIA Hopper card: the
packed owner|cell|idx|flags sort, the two segmented lexicographic max
scans that give the xor and upsert masks, the murmur3 hash of each
canonical timestamp, the (owner, minute) segmented XOR fold that gives
the Merkle deltas, and the batch XOR digest. The kernels of that path
(segmented lex-max scan, segmented XOR scan, timestamp hash, and the
segmented sum scan of the typed folds) are hand-written CUDA C++ under
`csrc/`, built with nvcc at first use. The client worker
(`runtime.worker.DbWorker`) plans its batches through them, with each
cell's stored winner kept in device memory (`ops.winner_cache`).

Every entry point takes `device=None`, which means CUDA: without a card
it raises unless the caller passes `device="cpu"`, which runs the plain
PyTorch version of every kernel instead. The package imports neither
jax nor `evolu_tpu`; it keeps its own copies of the host helpers it
needs, under the same module names.
"""

from evolu_tpu_torch.ops import resolve_device

__all__ = ["resolve_device"]
