"""Replicate sweeps: the replicate axis as a leading batch dimension."""

from .replicates import (auto_replicates_per_batch, replicate_sweep,
                         replicate_sweep_packed, worker_filter)

__all__ = ["auto_replicates_per_batch", "replicate_sweep",
           "replicate_sweep_packed", "worker_filter"]
