"""The sanitizer: a guard that raises on any implicit device-to-host sync.

The solvers read the host only at the places chosen for it (a lane mask's
``any()`` once per objective evaluation, a pass's trace, the result
copies); everything else stays on the card. :func:`sync_guard` checks that
promise at run time, as the JAX package's ``jax.transfer_guard
("disallow")`` does in ``tests/test_sanitize.py``: on a CUDA device it
sets ``torch.cuda.set_sync_debug_mode("error")``, under which every
synchronizing copy or read (``.item()``, ``.cpu()``, ``.tolist()``, a
pageable copy either way, boolean-mask indexing, ``nonzero``,
``torch.unique``, ``repeat_interleave`` without ``output_size``, ``if
tensor:``) raises. A chosen read is marked with :func:`host_read`, which
drops the mode for its body; the lint's ``host-sync`` rule
(``analysis/rules_sync.py``) exempts the same blocks, so one marker serves
the static and the runtime check.

The mode is process-wide, not per thread: while a guard is active, a sync
in any thread raises. The guard is for tests and the smoke, not for the
serving daemon's threads.

``CNMF_TPU_SANITIZE=1`` (:func:`sanitize_enabled`) asks the card tests to
run their designated solver tests under the guard. Torch has no switch
like ``jax_debug_nans``; the guarded tests assert finite outputs instead,
and the solvers keep their ``nonfinite`` record.

On a CPU device the guard does nothing (a CPU has no device-to-host sync
to catch) and says so: its :attr:`SyncGuard.active` is False, and
neither helper touches ``torch.cuda`` (which raises on a build without
CUDA) unless a CUDA guard is active.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["SyncGuard", "sync_guard", "host_read", "sanitize_enabled"]

SANITIZE_ENV = "CNMF_TPU_SANITIZE"

_lock = threading.Lock()
# the active CUDA guards, innermost last
_guards: list = []


class SyncGuard:
    """What :func:`sync_guard` yields: ``active`` (whether a CUDA device
    is guarded) and ``reads``, the :func:`host_read` entries while it was
    active."""

    __slots__ = ("active", "reads")

    def __init__(self, active: bool):
        self.active = active
        self.reads = 0


def sanitize_enabled() -> bool:
    """``CNMF_TPU_SANITIZE`` as a flag (default off)."""
    from .envknobs import env_flag

    return env_flag(SANITIZE_ENV, False)


@contextlib.contextmanager
def sync_guard(device="cuda"):
    """Raise on any implicit device-to-host sync in the body, on a CUDA
    ``device``; restore the previous sync debug mode on exit, after an
    exception too. Guards nest. Yields a :class:`SyncGuard`; on a CPU
    device nothing is guarded and its ``active`` is False. The device
    resolves as every entry point's does: a card asked for without one
    raises."""
    import torch

    from ..device import resolve_device

    guard = SyncGuard(resolve_device(device).type == "cuda")
    if not guard.active:
        yield guard
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    with _lock:
        _guards.append(guard)
    try:
        yield guard
    finally:
        with _lock:
            _guards.remove(guard)
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def host_read():
    """Mark a chosen host read. Inside an active guard the sync debug mode
    is off for the body and restored after it, and every active guard
    counts the read; outside a guard it does nothing."""
    if not _guards:
        yield
        return
    import torch

    with _lock:
        for guard in _guards:
            guard.reads += 1
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
