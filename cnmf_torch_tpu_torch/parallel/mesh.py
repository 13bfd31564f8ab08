"""A mesh of devices over one or more processes, and its sums.

The port's counterpart of ``jax.sharding.Mesh`` and of the per-shard body
of ``cnmf_torch_tpu/utils/jax_compat.py:shard_map``. The JAX package runs
one controller over a mesh of devices, ``jax.distributed`` joining
processes; the port keeps that model so that the replicate axis, the
row-sharded solve, the (replicates x cells) mesh, the (cells x genes) grid
and the elastic re-mesh keep their JAX semantics:

* :class:`Mesh` holds an ndarray of ``torch.device`` entries, global over
  processes, and the rank that owns each entry. A device may appear more
  than once (a CPU test builds ``Mesh(["cpu"] * 8, ...)`` as the JAX tests
  build 8 virtual CPU devices; the one-card smoke builds shards on
  ``cuda:0``): an entry is a shard, not a card. Entries are numbered
  ``0 .. size-1`` in row-major order; that number is the entry's ``id``
  (the JAX device id's role in the elastic layer).
* :meth:`Mesh.psum` sums one tensor a local shard along an axis in two
  steps: the process's local shards are added in shard order on the first
  local shard's device; where the axis spans processes the sum then goes
  through ``torch.distributed.all_reduce`` on that axis's process group.
  The sum is copied back to each local shard's device. The order is fixed
  and no atomics are used, so two runs give the same bits. A fiber with
  one local shard and no peer process returns its tensor as it is.
* The collective backend is chosen once by
  ``parallel/multihost.py:initialize_distributed`` (:func:`backend`):
  ``nccl`` when every process owns distinct cards, ``gloo`` on the CPU or
  when two processes share a card. A gloo sum of a CUDA tensor goes
  through a host copy.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

__all__ = ["Mesh", "process_index", "process_count", "backend",
           "visible_devices", "single_device_mesh", "global_devices"]

# the cross-process backend, decided once before the first collective
# (parallel/multihost.py:initialize_distributed); None in one process
_BACKEND: dict = {"name": None}


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def backend() -> str | None:
    """The cross-process collective backend (``nccl``/``gloo``), or None
    in a single process."""
    return _BACKEND["name"] if _dist() is not None else None


def visible_devices(device="cuda") -> list:
    """This process's devices of ``device``'s type: every visible card for
    ``cuda`` (each once), the one CPU for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """Devices on named axes, global over processes.

    ``devices``: a nested sequence or ndarray of devices (strings or
    ``torch.device``) whose shape is the mesh's. ``owners``: the rank that
    owns each entry (same shape); default: this process owns every entry
    (one controller). Every process builds the same mesh, in the same
    order, so the process groups of its fibers match."""

    def __init__(self, devices, axis_names, owners=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not match "
                             f"axes {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.rank = process_index()
        self.owners = (np.full(arr.shape, self.rank, dtype=np.int64)
                       if owners is None
                       else np.asarray(owners, np.int64).reshape(arr.shape))
        self.ids = np.arange(arr.size).reshape(arr.shape)
        self._groups: dict = {}
        self.stats = {"all_reduces": 0, "nbytes": 0, "wall_s": 0.0}
        if len(set(self.owners.flat)) > 1:
            self._make_groups()

    # -- shape --------------------------------------------------------
    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]}, "
                f"owners={list(self.owners.flat)})")

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners.flat)) > 1

    def local_ids(self) -> list[int]:
        return [int(i) for i in self.ids.flat
                if self.owners.flat[i] == self.rank]

    def device_of(self, i: int) -> torch.device:
        return self.devices.flat[int(i)]

    def coords(self, i: int) -> tuple:
        return np.unravel_index(int(i), self.devices.shape)

    # -- fibers and process groups -----------------------------------
    def _fiber_key(self, axis, i):
        """The entries along ``axis`` through entry ``i`` (flat ids in axis
        order)."""
        a = self.axis_names.index(axis)
        c = list(self.coords(i))
        out = []
        for j in range(self.devices.shape[a]):
            c[a] = j
            out.append(int(self.ids[tuple(c)]))
        return tuple(out)

    def _make_groups(self):
        """One process group per distinct set of ranks a fiber spans, made
        in the same order on every process (``new_group`` is collective)."""
        dist = _dist()
        if dist is None:
            raise RuntimeError("a mesh that spans processes needs "
                               "torch.distributed initialized "
                               "(parallel/multihost.py)")
        name = _BACKEND["name"] or "gloo"
        world = list(range(dist.get_world_size()))
        for axis in self.axis_names:
            seen = set()
            for i in range(self.size):
                ranks = tuple(sorted({int(self.owners.flat[j])
                                      for j in self._fiber_key(axis, i)}))
                if len(ranks) < 2 or ranks in seen:
                    continue
                seen.add(ranks)
                self._groups[(axis, ranks)] = (
                    dist.group.WORLD if list(ranks) == world
                    and name == "gloo"
                    else dist.new_group(list(ranks), backend=name))

    def fiber(self, axis, i=None) -> "Mesh":
        """The 1-D mesh along ``axis`` through entry ``i`` (default: the
        first local entry), with its process group."""
        if i is None:
            i = self.local_ids()[0]
        ids = self._fiber_key(axis, i)
        sub = Mesh.__new__(Mesh)
        sub.axis_names = (axis,)
        sub.devices = np.asarray([self.device_of(j) for j in ids],
                                 dtype=object)
        sub.rank = self.rank
        sub.owners = np.asarray([self.owners.flat[j] for j in ids],
                                np.int64)
        sub.ids = np.arange(len(ids))
        ranks = tuple(sorted(set(int(r) for r in sub.owners)))
        sub._groups = ({(axis, ranks): self._groups[(axis, ranks)]}
                       if len(ranks) > 1 else {})
        sub.stats = self.stats
        return sub

    def _group(self, axis, through=None):
        """The process group of the fiber along ``axis`` through entry
        ``through`` (default the first local entry); None when the fiber
        is within this process."""
        key = self._fiber_key(axis, self.local_ids()[0] if through is None
                              else through)
        ranks = tuple(sorted({int(self.owners.flat[j]) for j in key}))
        return self._groups.get((axis, ranks)) if len(ranks) > 1 else None

    def local_shards(self, axis=None) -> list[int]:
        """Positions along ``axis`` of this process's entries of its local
        fiber (a 1-D mesh: its local entries' positions)."""
        axis = self.axis_names[0] if axis is None else axis
        key = self._fiber_key(axis, self.local_ids()[0])
        return [p for p, j in enumerate(key)
                if self.owners.flat[j] == self.rank]

    def local_devices(self, axis=None) -> list:
        axis = self.axis_names[0] if axis is None else axis
        key = self._fiber_key(axis, self.local_ids()[0])
        return [self.device_of(key[p]) for p in self.local_shards(axis)]

    # -- collectives --------------------------------------------------
    def psum(self, parts, axis=None, through=None):
        """Sum one tensor a local shard of the fiber along ``axis`` through
        entry ``through`` (default the first local entry; a list in shard
        order): the local shards in order on the first local shard's
        device, then the ``all_reduce`` of the fiber's process group where
        it spans processes. Returns the sum on each local shard's device
        (one list entry a shard)."""
        axis = self.axis_names[0] if axis is None else axis
        parts = list(parts)
        acc = parts[0]
        d0 = acc.device
        for p in parts[1:]:
            acc = acc + p.to(d0)
        group = self._group(axis, through)
        if group is not None:
            acc = self._all_reduce(acc, group)
        return [acc if p.device == d0 else acc.to(p.device) for p in parts]

    def _all_reduce(self, t, group):
        import torch.distributed as dist

        t0 = time.perf_counter()
        host = t.is_cuda and _BACKEND["name"] != "nccl"
        buf = t.detach().to("cpu", copy=True) if host else t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = buf.to(t.device) if host else buf
        self.stats["all_reduces"] += 1
        self.stats["nbytes"] += int(buf.numel() * buf.element_size())
        self.stats["wall_s"] += time.perf_counter() - t0
        return out

    def gather(self, obj, axis=None) -> list:
        """Every process's ``obj`` along the local fiber of ``axis``, in
        rank order (``all_gather_object`` on the axis's group; ``[obj]``
        within one process)."""
        axis = self.axis_names[0] if axis is None else axis
        group = self._group(axis)
        if group is None:
            return [obj]
        import torch.distributed as dist

        n = dist.get_world_size(group)
        out = [None] * n
        dist.all_gather_object(out, obj, group=group)
        return out

    def gather_all(self, obj) -> list:
        """``obj`` of every process of the mesh, in rank order."""
        if not self.spans_processes:
            return [obj]
        import torch.distributed as dist

        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        ranks = sorted(set(int(r) for r in self.owners.flat))
        return [out[r] for r in ranks]


def single_device_mesh(device, axis_name="cells") -> Mesh:
    """The trivial one-entry mesh on ``device``."""
    return Mesh([torch.device(device)], (axis_name,))


def global_devices(local, n_proc: int | None = None):
    """``(devices, owners)`` of a mesh over every process, each process
    contributing the same local device list (the same command runs on
    every host): process 0's entries first, as ``jax.devices()`` lists
    them."""
    n_proc = process_count() if n_proc is None else int(n_proc)
    local = [torch.device(d) for d in local]
    devices = list(itertools.chain.from_iterable([local] * n_proc))
    owners = [r for r in range(n_proc) for _ in local]
    return devices, owners
