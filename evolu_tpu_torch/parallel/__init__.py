"""The multi-owner reconcile pass (one card, so one shard)."""

from evolu_tpu_torch.parallel.reconcile import build_owner_columns, reconcile_owner_batches

__all__ = ["build_owner_columns", "reconcile_owner_batches"]
