"""Elastic degraded-mesh execution: survive host/device loss mid-run.

Own copy of ``cnmf_torch_tpu/runtime/elastic.py``, the recovery-policy
half of the elastic layer:

* **Liveness** — :class:`Heartbeat`: each mesh participant (a process of
  the mesh, a launcher worker) stamps an atomic JSON heartbeat file at
  pass and stage boundaries (throttled to ``CNMF_TPU_HEARTBEAT_S``).
  :meth:`Heartbeat.culprits` turns a generic barrier timeout into a named
  diagnosis — which peer went silent, how long ago, at which pass — read
  by ``parallel/multihost.py:sync_hosts`` and the launcher's straggler
  containment.
* **Loss detection** — :func:`is_device_loss` recognizes the injected
  :class:`~cnmf_torch_tpu_torch.runtime.faults.HostLossError` and the
  error-string shapes real dead-device and dead-peer failures take
  (collective transport resets, dead peers), so the same recovery path
  handles the fault tests and real losses.
* **Degraded re-mesh** — :func:`plan_degraded_mesh` re-plans a smaller
  mesh over the surviving entries (the 1-D cells mesh, the (replicates x
  cells) layout through ``mesh_2d``, the (cells x genes) grid through
  ``mesh_grid2d``), refusing to shrink below ``CNMF_TPU_MIN_DEVICES``.
  The callers (``models/cnmf.py``) re-stage X from the original input and
  resume each in-flight replicate from its pass checkpoint.

A mesh entry's id (``parallel/mesh.py``) plays the JAX device id's role:
the port's meshes may repeat a device, so an entry, not a card, is what a
loss removes. ``CNMF_TPU_ELASTIC=0`` restores abort-and-relaunch.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = [
    "ELASTIC_ENV",
    "HEARTBEAT_ENV",
    "STRAGGLER_ENV",
    "MIN_DEVICES_ENV",
    "elastic_enabled",
    "heartbeat_s",
    "straggler_deadline_s",
    "min_surviving_devices",
    "DegradedMeshError",
    "Heartbeat",
    "is_device_loss",
    "resolve_lost_devices",
    "plan_degraded_mesh",
]

ELASTIC_ENV = "CNMF_TPU_ELASTIC"
HEARTBEAT_ENV = "CNMF_TPU_HEARTBEAT_S"
STRAGGLER_ENV = "CNMF_TPU_STRAGGLER_S"
MIN_DEVICES_ENV = "CNMF_TPU_MIN_DEVICES"


def elastic_enabled() -> bool:
    """Elastic degraded-mode execution on/off (``CNMF_TPU_ELASTIC``,
    default on): in-process re-mesh onto surviving devices after a
    host/device loss, and launcher work-stealing adoption of dead or
    straggling workers' shards. ``0`` restores abort-and-relaunch."""
    from ..utils.envknobs import env_flag

    return env_flag(ELASTIC_ENV, True)


def heartbeat_s() -> float:
    """Liveness stamp interval in seconds (``CNMF_TPU_HEARTBEAT_S``,
    default 0 = off). A participant is presumed dead or wedged once its
    heartbeat is older than 3x this interval."""
    from ..utils.envknobs import env_float

    return env_float(HEARTBEAT_ENV, 0.0, lo=0.0)


def straggler_deadline_s() -> float:
    """Launcher straggler grace (``CNMF_TPU_STRAGGLER_S``, default 0 =
    off; inert under ``CNMF_TPU_ELASTIC=0`` and requiring
    ``CNMF_TPU_HEARTBEAT_S``): a worker whose own run exceeds the longest
    clean finisher's wall by this many seconds AND whose heartbeat is
    stale is killed and its shard adopted."""
    from ..utils.envknobs import env_float

    return env_float(STRAGGLER_ENV, 0.0, lo=0.0)


def min_surviving_devices() -> int:
    """Degraded-mesh floor (``CNMF_TPU_MIN_DEVICES``, default 1)."""
    from ..utils.envknobs import env_int

    return env_int(MIN_DEVICES_ENV, 1, lo=1)


class DegradedMeshError(RuntimeError):
    """Too few devices survived a topology loss for degraded continuation
    (below ``CNMF_TPU_MIN_DEVICES``): the run aborts cleanly and resumes
    from its checkpoints on relaunch."""


class Heartbeat:
    """One participant's liveness stamp, as an atomic JSON file
    ``<dir>/<prefix>.heartbeat.<index>.json`` holding ``{index, pid, ts,
    phase, cursor}``. Stamps are throttled to ``interval_s`` (default
    ``CNMF_TPU_HEARTBEAT_S``); ``force=True`` bypasses the throttle;
    ``interval_s <= 0`` makes every call a no-op."""

    def __init__(self, directory, prefix: str, index: int,
                 interval_s: float | None = None, events=None):
        self.directory = os.fspath(directory)
        self.prefix = str(prefix)
        self.index = int(index)
        self.interval_s = (heartbeat_s() if interval_s is None
                           else float(interval_s))
        self.events = events
        self._last = 0.0

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    def path_for(self, index: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}.heartbeat.{int(index)}.json")

    @property
    def path(self) -> str:
        return self.path_for(self.index)

    def beat(self, phase: str | None = None, cursor=None,
             force: bool = False) -> bool:
        """Stamp liveness (throttled); True when a file was written. Never
        raises: a full disk degrades liveness to "no heartbeat"."""
        if not self.enabled:
            return False
        now = time.monotonic()
        if not force and now - self._last < self.interval_s:
            return False
        self._last = now
        payload = {"index": self.index, "pid": os.getpid(),
                   "ts": time.time()}
        if phase is not None:
            payload["phase"] = str(phase)
        if cursor is not None:
            payload["cursor"] = int(cursor)
        try:
            from ..utils.io import atomic_artifact

            with atomic_artifact(self.path) as tmp:
                with open(tmp, "w") as f:
                    json.dump(payload, f)
            return True
        except Exception:
            return False

    @staticmethod
    def read(path) -> dict | None:
        """One participant's last stamp, or None (missing or torn)."""
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def probe_peers(self, n: int) -> dict:
        """``{index: age_seconds | None}`` for every index in ``range(n)``
        (None: never stamped)."""
        now = time.time()
        out: dict = {}
        for i in range(int(n)):
            rec = self.read(self.path_for(i))
            out[i] = None if rec is None else max(0.0, now - float(rec["ts"]))
        return out

    def culprits(self, n: int, stale_after_s: float | None = None,
                 include_self: bool = False) -> list:
        """Peers presumed dead or wedged: heartbeat missing or older than
        ``stale_after_s`` (default ``3 x interval_s``), each with its
        ``index``, ``age_s``, and last ``phase`` and ``cursor``."""
        if stale_after_s is None:
            stale_after_s = 3.0 * max(self.interval_s, 1e-9)
        out = []
        for i, age in self.probe_peers(n).items():
            if not include_self and i == self.index:
                continue
            if age is not None and age <= stale_after_s:
                continue
            rec = self.read(self.path_for(i)) or {}
            out.append({"index": i,
                        "age_s": None if age is None else round(age, 1),
                        "phase": rec.get("phase"),
                        "cursor": rec.get("cursor")})
        return out

    @staticmethod
    def describe(culprits: list) -> str:
        """Human-readable culprit list for error messages and warnings."""
        if not culprits:
            return "no stale heartbeats (culprit unknown)"
        parts = []
        for c in culprits:
            where = "" if c.get("phase") is None else (
                " at %s%s" % (c["phase"],
                              "" if c.get("cursor") is None
                              else " (cursor %d)" % c["cursor"]))
            when = ("never stamped" if c.get("age_s") is None
                    else "last beat %.1fs ago" % c["age_s"])
            parts.append("participant %d (%s%s)" % (c["index"], when, where))
        return ", ".join(parts)


# error-string shapes real topology failures take (the JAX package's
# list): dead-device aborts, collective transport resets, distributed
# peer failures. Only RuntimeError qualifies, never OSError: an ordinary
# file or socket error is a retry or abort case, not a topology loss.
_LOSS_MARKERS = (
    "device halted",
    "data_loss",
    "socket closed",
    "connection reset",
    "peer closed",
    "transport closed",
    "remote peer",
    "heartbeat timeout",
)


def is_device_loss(exc: BaseException) -> bool:
    """Whether an exception signals a topology loss that degraded
    continuation can recover from: an injected ``HostLossError``, or a
    ``RuntimeError`` whose message matches a known dead-device or
    dead-peer shape."""
    from .faults import HostLossError

    if isinstance(exc, HostLossError):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc).lower()
    return any(marker in msg for marker in _LOSS_MARKERS)


def resolve_lost_devices(exc: BaseException, mesh) -> list:
    """The mesh entry ids presumed lost. An injected ``HostLossError``
    names ids (or a trailing ``count``); a real loss falls back to the
    trailing-entry convention, and re-staging then validates the
    survivors by using them."""
    from .faults import HostLossError

    ids = [int(i) for i in mesh.ids.flat]
    if isinstance(exc, HostLossError) and exc.lost:
        return [i for i in exc.lost if i in ids]
    count = exc.count if isinstance(exc, HostLossError) else 1
    count = (max(1, min(int(count), len(ids) - 1)) if len(ids) > 1
             else len(ids))
    return ids[-count:]


def plan_degraded_mesh(mesh, lost_ids):
    """Re-plan ``mesh`` over its surviving entries after a loss: a 1-D
    mesh keeps its axis with every survivor on it; the (replicates x
    cells) layout re-plans through ``mesh_2d`` and the (cells x genes)
    grid through ``mesh_grid2d``, the planners that built them. Raises
    :class:`DegradedMeshError` below ``CNMF_TPU_MIN_DEVICES``
    survivors."""
    lost = {int(i) for i in lost_ids}
    keep = [int(i) for i in mesh.ids.flat if int(i) not in lost]
    floor = min_surviving_devices()
    if len(keep) < floor:
        raise DegradedMeshError(
            "host/device loss left %d surviving device(s), below the "
            "degraded-mesh floor %s=%d — aborting instead of continuing "
            "on a mesh that small (relaunch on a repaired topology to "
            "resume from checkpoints)"
            % (len(keep), MIN_DEVICES_ENV, floor))
    from ..parallel.mesh import Mesh

    surviving = [mesh.devices.flat[i] for i in keep]
    owners = [int(mesh.owners.flat[i]) for i in keep]
    axis_names = tuple(mesh.axis_names)
    if axis_names == ("replicates", "cells"):
        from ..parallel.multihost import mesh_2d

        return mesh_2d(devices=surviving, owners=owners)
    if axis_names == ("cells", "genes"):
        from ..parallel.grid2d import mesh_grid2d

        return mesh_grid2d(devices=surviving, owners=owners)
    if len(axis_names) != 1:
        raise DegradedMeshError(
            f"cannot re-plan a degraded mesh over axes {axis_names!r}")
    return Mesh(np.asarray(surviving, dtype=object), axis_names,
                owners=owners)
