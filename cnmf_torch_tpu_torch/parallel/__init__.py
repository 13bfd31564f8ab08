"""The parallel layer: replicate sweeps, the row-sharded solver, the mesh
and its layouts (the exports of the JAX package's ``parallel/__init__.py``
that the port has; ``clear_sweep_cache`` and ``warm_sweep_programs`` manage
compiled XLA programs and have no counterpart)."""

from .grid2d import (measure_collectives, mesh_grid2d, nmf_fit_grid2d,
                     stage_x_grid)
from .mesh import Mesh
from .multihost import (HostBarrierTimeout, initialize_distributed,
                        is_coordinator, mesh_2d, replicate_sweep_2d,
                        sync_hosts)
from .replicates import (auto_replicates_per_batch, default_mesh,
                         replicate_sweep, replicate_sweep_packed,
                         worker_filter)
from .rowshard import fit_h_rowsharded, nmf_fit_rowsharded, pad_rows_to_mesh
from .streaming import (ShardStallError, ShardUploadError, StreamStats,
                        stream_to_device)

__all__ = [
    "HostBarrierTimeout",
    "Mesh",
    "ShardStallError",
    "ShardUploadError",
    "StreamStats",
    "stream_to_device",
    "auto_replicates_per_batch",
    "default_mesh",
    "initialize_distributed",
    "is_coordinator",
    "mesh_2d",
    "replicate_sweep",
    "replicate_sweep_packed",
    "replicate_sweep_2d",
    "sync_hosts",
    "worker_filter",
    "fit_h_rowsharded",
    "nmf_fit_rowsharded",
    "pad_rows_to_mesh",
    "mesh_grid2d",
    "nmf_fit_grid2d",
    "stage_x_grid",
    "measure_collectives",
]
