"""Several processes, and the 2-D (replicates x cells) mesh.

Port of ``cnmf_torch_tpu/parallel/multihost.py``. The JAX package runs
one single-controller program over every host's devices, joined by
``jax.distributed``; the port joins its processes with
``torch.distributed`` on a TCP store and keeps the model:

* :func:`initialize_distributed` — idempotent ``init_process_group`` from
  explicit arguments or ``CNMF_COORDINATOR_ADDRESS`` /
  ``CNMF_NUM_PROCESSES`` / ``CNMF_PROCESS_ID``, with the collective
  backend chosen by rule before the first collective: ``nccl`` when every
  process owns distinct cards, ``gloo`` on the CPU or when two processes
  share a card (NCCL refuses that). The choice is recorded
  (``parallel/mesh.py:backend``) and never switches.
* :func:`local_devices` — this process's mesh entries: every visible card,
  or on the CPU ``CNMF_SIM_CPU_DEVICES`` entries (the launcher's pod
  simulation).
* :func:`mesh_2d` — the (replicates, cells) mesh, one replicate row a
  process where the processes divide the entries (the replicate axis
  crosses processes, the per-pass cells sums stay within one).
* :func:`replicate_sweep_2d` — every replicate is the row-sharded solve
  of ``parallel/rowshard.py`` over its row's cells fiber (the same init
  mapping and pass loop), the replicates spread over the rows; results
  are gathered on every process (``all_gather`` where JAX calls
  ``process_allgather``).
* :func:`sync_hosts` — a barrier under a watchdog
  (``CNMF_TPU_BARRIER_TIMEOUT_S``) that raises :class:`HostBarrierTimeout`
  naming the silent peers from their heartbeats.

Host-side IO stays the coordinator's (process 0) job.
"""

from __future__ import annotations

import math
import threading
import warnings
from datetime import timedelta

import numpy as np
import torch

from . import mesh as _mesh
from .mesh import Mesh, global_devices, process_count, process_index

__all__ = [
    "initialize_distributed",
    "is_coordinator",
    "local_devices",
    "mesh_2d",
    "replicate_sweep_2d",
    "stage_x_2d",
    "sync_hosts",
    "HostBarrierTimeout",
    "barrier_timeout_s",
]

_ENV_COORD = "CNMF_COORDINATOR_ADDRESS"
_ENV_NPROC = "CNMF_NUM_PROCESSES"
_ENV_PID = "CNMF_PROCESS_ID"
_ENV_SIM = "CNMF_SIM_CPU_DEVICES"
BARRIER_TIMEOUT_ENV = "CNMF_TPU_BARRIER_TIMEOUT_S"
# how long a collective of the process group waits for its peers
COLLECTIVE_TIMEOUT_S = 600.0


class HostBarrierTimeout(RuntimeError):
    """A cross-process barrier did not complete within
    ``CNMF_TPU_BARRIER_TIMEOUT_S``: a peer is dead or wedged. Relaunch the
    same command on every host; factorize resumes from its artifacts and
    pass checkpoints. ``culprits`` names the peers whose heartbeats went
    stale or were never stamped (``runtime/elastic.py``)."""

    def __init__(self, message: str, culprits: list | None = None):
        super().__init__(message)
        self.culprits = list(culprits or [])


def barrier_timeout_s() -> float:
    """Cross-process barrier watchdog in seconds
    (``CNMF_TPU_BARRIER_TIMEOUT_S``, default 0 = wait forever)."""
    from ..utils.envknobs import env_float

    return env_float(BARRIER_TIMEOUT_ENV, 0.0, lo=0.0)


# one abandonment warning per barrier name per process
_abandoned_lock = threading.Lock()
_abandoned_names: set = set()


def _wait_with_timeout(fn, timeout_s: float, name: str):
    """Run a blocking collective under a wall-clock watchdog: it runs on a
    daemon thread and the caller waits ``timeout_s`` for it. Only a
    collective still running at expiry abandons its thread (a wedged
    collective cannot be cancelled), logged once a barrier name; every
    other path joins the thread. ``timeout_s <= 0`` runs inline."""
    if not timeout_s or timeout_s <= 0:
        fn()
        return
    done = threading.Event()
    errs: list = []

    def run():
        try:
            fn()
        except BaseException as exc:  # surfaced to the caller below
            errs.append(exc)
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"cnmf-barrier-{name}",
                         daemon=True)
    t.start()
    if not done.wait(timeout_s):
        with _abandoned_lock:
            first = name not in _abandoned_names
            _abandoned_names.add(name)
        if first:
            warnings.warn(
                "abandoning wedged barrier thread %r after %gs — a hung "
                "collective cannot be cancelled, only diagnosed; it exits "
                "with the process" % (f"cnmf-barrier-{name}", timeout_s),
                RuntimeWarning, stacklevel=2)
        raise HostBarrierTimeout(
            "barrier %r did not complete within %gs (%s) — a peer host is "
            "likely dead. Aborting with state checkpointed; relaunch the "
            "same command on every host to resume from the newest valid "
            "checkpoint." % (name, timeout_s, BARRIER_TIMEOUT_ENV))
    t.join()
    if errs:
        raise errs[0]


def local_devices(device="cuda") -> list:
    """This process's mesh entries: ``CNMF_SIM_CPU_DEVICES`` CPU entries
    when set (a simulated pod host; ``device`` must then be the CPU), else
    every visible device of ``device``'s type
    (``parallel/mesh.py:visible_devices``)."""
    from ..utils.envknobs import env_int

    sim = env_int(_ENV_SIM, 0, lo=0)
    if sim:
        if torch.device(device).type != "cpu":
            raise ValueError(
                f"{_ENV_SIM}={sim} simulates CPU mesh entries, but the "
                f"run asks for {device!s} devices: unset it, or run on "
                "the CPU")
        return [torch.device("cpu")] * sim
    return _mesh.visible_devices(device)


def _card_ids(devices) -> list:
    """A host-independent identity of each local card (its UUID), or
    None for the CPU."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            return []
        props = torch.cuda.get_device_properties(d)
        out.append(str(getattr(props, "uuid", f"{d.index}")))
    return out


def _choose_backend(device) -> str:
    """The backend rule, over the default (gloo) group: ``nccl`` when
    every process owns cards and no card is owned twice, else ``gloo``."""
    import torch.distributed as dist

    mine = _card_ids(local_devices(device))
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    flat = [u for ids in every for u in (ids or [])]
    if all(every) and len(flat) == len(set(flat)):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           auto: bool = False, device="cuda") -> tuple:
    """Idempotent ``torch.distributed.init_process_group`` and
    ``(process_id, count)``.

    Coordinates resolve from the arguments, then the ``CNMF_*`` env vars.
    With none and ``auto=False`` this is a no-op single-process setup;
    ``auto=True`` (the CLI's ``--distributed``) with none raises: the port
    detects no cluster. Partial coordinates raise. The process group
    rendezvous is ``tcp://<coordinator_address>``; the default group is
    gloo (barriers, object gathers), and the mesh's sums run on the
    backend the rule picks (``nccl`` or ``gloo``), recorded before the
    first collective."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    from ..utils.envknobs import env_int, env_str

    coordinator_address = coordinator_address or env_str(_ENV_COORD) or None
    if num_processes is None:
        num_processes = env_int(_ENV_NPROC, None, lo=1)
    if process_id is None:
        process_id = env_int(_ENV_PID, None, lo=0)
    given = {"coordinator_address": coordinator_address,
             "num_processes": num_processes, "process_id": process_id}
    missing = [k for k, v in given.items() if v is None]
    if len(missing) == 3:
        if auto:
            raise RuntimeError(
                "distributed initialization was requested (--distributed) "
                "but no CNMF_COORDINATOR_ADDRESS / CNMF_NUM_PROCESSES / "
                "CNMF_PROCESS_ID are set (the port detects no cluster)")
        return 0, 1
    if missing:
        raise ValueError(
            "distributed launch needs all three coordinates; missing "
            f"{missing} (set the CNMF_COORDINATOR_ADDRESS / "
            "CNMF_NUM_PROCESSES / CNMF_PROCESS_ID env vars together, or "
            "unset them all for single-process runs)")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    _mesh._BACKEND["name"] = _choose_backend(device)
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    """True on the process that owns host-side IO (artifact writes)."""
    return process_index() == 0


def sync_hosts(name: str = "cnmf", timeout_s: float | None = None,
               heartbeat=None) -> None:
    """Barrier across processes (no-op in one process), bounded by
    ``CNMF_TPU_BARRIER_TIMEOUT_S`` (or ``timeout_s``): a barrier a dead
    peer can never join raises :class:`HostBarrierTimeout`. With a
    ``runtime.elastic.Heartbeat`` this process stamps its liveness first,
    and a timeout names the peers whose heartbeats went stale (and emits a
    ``fault`` event of kind ``host_loss`` when the heartbeat carries an
    event log)."""
    if process_count() <= 1:
        return
    import torch.distributed as dist

    if heartbeat is not None:
        heartbeat.beat(phase=f"barrier:{name}", force=True)
    timeout = barrier_timeout_s() if timeout_s is None else timeout_s
    try:
        _wait_with_timeout(dist.barrier, timeout, name)
    except HostBarrierTimeout as exc:
        if heartbeat is None or not heartbeat.enabled:
            raise
        culprits = heartbeat.culprits(process_count())
        detail = heartbeat.describe(culprits)
        if heartbeat.events is not None:
            heartbeat.events.emit(
                "fault", kind="host_loss",
                context={"barrier": name, "culprits": culprits})
        raise HostBarrierTimeout(
            f"{exc} Liveness diagnosis: {detail}.",
            culprits=culprits) from None


def _balanced_rc(n_dev: int, n_proc: int) -> tuple:
    """Factor the device count into (replicate_shards, cell_shards).
    Several processes: one replicate shard a process, cells within it (the
    cells-axis sum, the only per-pass collective, never crosses
    processes). One process: the most-square factorization, cells taking
    the larger factor."""
    if n_proc > 1 and n_dev % n_proc == 0:
        return n_proc, n_dev // n_proc
    r = 1
    for cand in range(int(math.isqrt(n_dev)), 0, -1):
        if n_dev % cand == 0:
            r = cand
            break
    return r, n_dev // r


def mesh_2d(replicate_shards: int | None = None, devices=None,
            owners=None, device="cuda") -> Mesh:
    """The (replicates, cells) mesh over every process's entries
    (:func:`local_devices` of each, process 0's first), or over
    ``devices`` (with their ``owners``). Reshaped to (replicate_shards,
    cell_shards), one replicate row a process where they divide."""
    if devices is None:
        devices, owners = global_devices(local_devices(device))
    devices = list(devices)
    n_dev = len(devices)
    n_proc = (len(set(owners)) if owners is not None else 1)
    if replicate_shards is None:
        r, c = _balanced_rc(n_dev, n_proc)
    else:
        r = int(replicate_shards)
        if n_dev % r:
            raise ValueError(
                f"replicate_shards={r} does not divide {n_dev} devices")
        c = n_dev // r
    arr = np.empty((r, c), dtype=object)
    for i, d in enumerate(devices):
        arr.flat[i] = torch.device(d)
    return Mesh(arr, ("replicates", "cells"),
                owners=None if owners is None
                else np.asarray(owners).reshape(r, c))


def _local_rows(mesh: Mesh) -> list:
    """The replicate rows that hold an entry of this process."""
    return sorted({int(mesh.coords(i)[0]) for i in mesh.local_ids()})


def stage_x_2d(X, mesh: Mesh, events=None, stats=None) -> dict:
    """Stage a host matrix or shard store for repeated 2-D sweeps: rows
    sharded over the cells axis, replicated over the replicate axis (a
    shard whose device another row already holds is shared, not copied);
    a store streams only the slabs that overlap this process's shards.
    Returns ``{row: RowShards}`` for this process's replicate rows."""
    from .rowshard import RowShards, stream_rows_to_mesh

    out: dict = {}
    staged: dict = {}
    for r in _local_rows(mesh):
        fib = mesh.fiber("cells", int(mesh.ids[r, 0]))
        key = tuple(str(d) for d in fib.devices.flat)
        if key in staged:
            first = staged[key]
            out[r] = RowShards(first.parts, fib, first.n, first.g)
            continue
        shards, _ = stream_rows_to_mesh(X, fib, stats=stats, events=events)
        staged[key] = out[r] = shards
    return out


def _replicate_inits(shards, seeds, k, init):
    """The inits of a row's replicates, the row-sharded solver's draws:
    random at the padded matrix's mean, or the gram nndsvd."""
    from ..ops.nmf import nndsvd_init_gram, random_init

    n, g = shards.shape
    dev = shards.mesh.local_devices()[0]
    if init == "random":
        x_mean = float(shards.total_sum() / (n * g))
        for s in seeds:
            H0, W0 = random_init(int(s), n, g, int(k), x_mean, device=dev)
            yield H0, W0
        return
    if init not in ("nndsvd", "nndsvda", "nndsvdar"):
        raise ValueError(f"unknown init {init!r}")
    variant = "nndsvdar" if init == "nndsvd" else init
    Xcat = torch.cat([p.to(dev) for p in shards.parts])
    for s in seeds:
        yield nndsvd_init_gram(Xcat, int(k), variant, seed=int(s))


def replicate_sweep_2d(X, seeds, k: int, mesh: Mesh, beta_loss="frobenius",
                       init: str = "random",
                       tol: float = 1e-4, h_tol: float = 0.05,
                       n_passes: int | None = None,
                       chunk_max_iter: int = 1000,
                       alpha_W: float = 0.0, l1_ratio_W: float = 0.0,
                       alpha_H: float = 0.0, l1_ratio_H: float = 0.0,
                       replicates_per_batch: int | None = None,
                       init_factors=None):
    """Run ``len(seeds)`` replicates over a 2-D (replicates, cells) mesh.

    Each replicate is the row-sharded block-coordinate solve of
    ``parallel/rowshard.py:nmf_fit_rowsharded`` over its replicate row's
    cells fiber (the same init mapping and pass loop, so a replicate
    agrees with the 1-D solve on as many cells shards to reduction
    rounding). The replicates of a slice (``replicates_per_batch`` a row,
    default the per-device budget) are padded to a multiple of the rows
    with copies, split into contiguous blocks a row, and the copies are
    computed and dropped; a ``hostloss`` hook (context ``sweep2d``) fires
    at every slice. ``X``: a host matrix or store (staged by
    :func:`stage_x_2d`) or its result. ``init_factors``: explicit
    ``(H0 (R, n_pad, k), W0 (R, k, g))`` (the tests feed JAX's draws).
    Returns ``(spectra (R, k, g), errs (R,))`` as numpy on every process
    (JAX's ``fetch=False`` device-array return has no counterpart)."""
    from ..ops.nmf import (beta_loss_to_float, resolve_online_schedule,
                           split_regularization)
    from ..runtime.faults import maybe_hostloss
    from .replicates import auto_replicates_per_batch
    from .rowshard import _fit_rowsharded_loop, _split_rows

    beta = beta_loss_to_float(beta_loss)
    _, n_passes, _ = resolve_online_schedule(beta, h_tol, n_passes)
    if beta not in (2.0, 1.0, 0.0):
        raise ValueError(
            f"replicate_sweep_2d supports beta in {{2, 1, 0}}, got {beta}")
    r_dim, c_dim = mesh.devices.shape
    staged = X if isinstance(X, dict) else stage_x_2d(X, mesh)
    any_rows = next(iter(staged.values()))
    n, g = any_rows.shape
    seeds = [int(s) & 0x7FFFFFFF for s in seeds]
    R = len(seeds)
    if R == 0:
        return np.zeros((0, int(k), g), np.float32), np.zeros((0,),
                                                              np.float32)
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    n_local = n // c_dim
    per_row = replicates_per_batch or auto_replicates_per_batch(
        n_local, g, int(k), beta=beta, chunk=n_local,
        device=any_rows.mesh.local_devices()[0])
    slice_r = max(1, int(per_row)) * r_dim
    results: dict = {}
    for start in range(0, R, slice_r):
        maybe_hostloss(context="sweep2d")
        idx = list(range(start, min(start + slice_r, R)))
        r = len(idx)
        idx = idx + [idx[i % r] for i in range((-r) % r_dim)]
        per = len(idx) // r_dim
        mine: dict = {}
        for row, shards in staged.items():
            block = idx[row * per:(row + 1) * per]
            dev = shards.mesh.local_devices()[0]
            inits = (_replicate_inits(shards, [seeds[i] for i in block], k,
                                      init)
                     if init_factors is None else
                     ((np.asarray(init_factors[0][i], np.float32),
                       torch.tensor(np.asarray(init_factors[1][i],
                                               np.float32)).to(dev))
                      for i in block))
            for i, (H0, W0) in zip(block, inits):
                _, W, err, _, _, _ = _fit_rowsharded_loop(
                    shards, _split_rows(H0, shards), W0[None].contiguous(),
                    beta, float(tol), float(h_tol), int(n_passes),
                    int(chunk_max_iter), l1_H, l2_H, l1_W, l2_W)
                mine[i] = (W[0].cpu().numpy(), float(err))
        for part in mesh.gather_all(mine):
            results.update(part)
    spectra = np.stack([results[i][0] for i in range(R)])
    errs = np.asarray([results[i][1] for i in range(R)], np.float32)
    return spectra, errs
