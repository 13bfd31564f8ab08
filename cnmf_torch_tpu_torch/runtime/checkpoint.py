"""Mid-run pass checkpoints of the row-sharded solver.

Own copy of ``cnmf_torch_tpu/runtime/checkpoint.py``: the same file
layout (one ``.npz`` a ``(k, iter)`` replicate, the same members and
dtypes), the same identity keys and the same H byte budget, so either
package resumes the other's checkpoint of the same solve.

Every ``CNMF_TPU_CKPT_EVERY_PASSES`` passes (default 1; ``0`` turns the
subsystem off) the replicated ``W``, the last pass's ``(A, B)``
statistics (beta=2; zeros otherwise), the pass cursor, the objective
state, the trace and the replicate's identity land atomically. The
usage matrix ``H`` rides along while it fits ``CNMF_TPU_CKPT_H_BYTES``
(default 256 MiB): below the budget a resume is bit for bit the
uninterrupted run; above it the resume re-derives H from the restored W
within solver tolerance. An input digest pins a checkpoint to its
matrix, and every load validates structurally and raises
:class:`TornCheckpointError` otherwise: a torn checkpoint is discarded
and the replicate restarts from scratch.

:class:`PassCheckpointer` is the policy object ``cNMF.factorize`` hands
to ``parallel.rowshard.nmf_fit_rowsharded``; the solver only calls
``load``/``save``. ``checkpoint`` events (``action`` write, resume,
discard) record each step, and the ``kill:stage=pass`` and
``torn:artifact=ckpt`` hooks fire where a real preemption would.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

__all__ = [
    "CKPT_EVERY_ENV",
    "CKPT_H_BUDGET_ENV",
    "CKPT_SCHEMA",
    "ckpt_every_passes",
    "ckpt_h_budget_bytes",
    "TornCheckpointError",
    "input_digest",
    "save_pass_checkpoint",
    "load_pass_checkpoint",
    "probe_pass_checkpoint",
    "PassCheckpointer",
]

CKPT_EVERY_ENV = "CNMF_TPU_CKPT_EVERY_PASSES"
CKPT_H_BUDGET_ENV = "CNMF_TPU_CKPT_H_BYTES"
CKPT_MIN_INTERVAL_ENV = "CNMF_TPU_CKPT_MIN_INTERVAL_S"

CKPT_SCHEMA = 1

_DEFAULT_H_BUDGET = 256 << 20

# identity fields a checkpoint must match before resume trusts it: the
# replicate's ledger coordinates, the derived-seed state, the input
# digest, and the resolved solver-parameter signature — a mismatch on
# any of them means the file describes a different solve (different
# matrix OR different recipe) and is treated exactly like a torn
# artifact. The "params" signature includes the resolved solver recipe
# (ops/recipe.py: SolverRecipe.signature(), folded in by
# models/cnmf.py): a CNMF_TPU_ACCEL/KL_NEWTON flip between runs changes
# the convergence math itself, so a resume across it restarts the
# replicate. "params" is optional in ``meta`` (defaults to "") for
# callers outside the pipeline.
_IDENTITY_KEYS = ("k", "iter", "seed", "attempt", "digest", "beta",
                  "params")

_ARRAY_KEYS = ("W", "A", "B", "trace")


def _env_nonneg_int(name: str, default: int) -> int:
    from ..utils.envknobs import env_int

    return env_int(name, default, lo=0)


def ckpt_every_passes() -> int:
    """Checkpoint cadence in solver passes (``CNMF_TPU_CKPT_EVERY_PASSES``,
    default 1 — after every pass). ``0`` disables mid-run checkpointing;
    the pass loop is the same either way."""
    return _env_nonneg_int(CKPT_EVERY_ENV, 1)


def ckpt_h_budget_bytes() -> int:
    """Byte budget above which the usage matrix H is NOT persisted in the
    checkpoint (``CNMF_TPU_CKPT_H_BYTES``, default 256 MB). Below it
    resume is bit-identical; above it resume re-derives H from W within
    solver tolerance — see the module docstring."""
    return _env_nonneg_int(CKPT_H_BUDGET_ENV, _DEFAULT_H_BUDGET)


def ckpt_min_interval_s() -> float:
    """Wall-clock floor between checkpoint writes
    (``CNMF_TPU_CKPT_MIN_INTERVAL_S``, default 0 = persist every eligible
    pass). On runs whose passes take seconds rather than minutes, a
    nonzero floor (e.g. ``30``) caps the gather+write amplification of
    the default per-pass cadence while keeping the recovery property —
    resume just restarts from a slightly older pass."""
    from ..utils.envknobs import env_float

    return env_float(CKPT_MIN_INTERVAL_ENV, 0.0, lo=0.0)


class TornCheckpointError(RuntimeError):
    """A pass checkpoint exists but cannot be trusted (unreadable,
    truncated, wrong replicate identity, wrong shapes, or nonfinite)."""


def input_digest(X) -> str:
    """Cheap content digest of the factorization input: shape + nnz +
    f64 checksum + a strided 64-element sample, hashed. O(nnz) for the
    sum — microseconds next to a host→device transfer — yet any
    different matrix (other run, re-prepared HVG subset, edited shard)
    collides with negligible probability, so a resumed checkpoint can
    never continue the wrong input."""
    import hashlib

    import scipy.sparse as sp

    buf = X.data if sp.issparse(X) else np.asarray(X).ravel()
    step = max(1, buf.size // 64)
    h = hashlib.sha1()
    h.update(repr((tuple(int(s) for s in X.shape),
                   int(getattr(X, "nnz", buf.size)),
                   float(buf.sum(dtype=np.float64)))).encode())
    h.update(np.ascontiguousarray(buf[::step][:64],
                                  dtype=np.float64).tobytes())
    if sp.issparse(X):
        # the value buffer alone cannot tell two sparsity PATTERNS apart
        # (same values, shifted columns) — fold in the structure arrays
        # so a resumed checkpoint never continues a re-indexed matrix
        for arr in (X.indices, X.indptr):
            a = np.asarray(arr)
            s = max(1, a.size // 64)
            h.update(repr(int(a.sum(dtype=np.int64))).encode())
            h.update(np.ascontiguousarray(a[::s][:64],
                                          dtype=np.int64).tobytes())
    return h.hexdigest()


def save_pass_checkpoint(path, *, k, it, seed, attempt, digest, beta,
                         pass_idx, err_prev, err, trace, W, A, B, H=None,
                         params: str = ""):
    """Atomically persist one replicate's pass state. Objective scalars
    are stored as float32 (the dtype the solver loop carries), so a
    resumed host loop sees bit-identical convergence-test inputs."""
    from ..utils.io import atomic_artifact

    from . import faults

    arrays = {
        "schema": np.int64(CKPT_SCHEMA),
        "k": np.int64(k),
        "iter": np.int64(it),
        "seed": np.int64(seed),
        "attempt": np.int64(attempt),
        "digest": np.asarray(str(digest)),
        "beta": np.float64(beta),
        "params": np.asarray(str(params)),
        "pass_idx": np.int64(pass_idx),
        "err_prev": np.float32(err_prev),
        "err": np.float32(err),
        "trace": np.asarray(trace, np.float32),
        "W": np.asarray(W, np.float32),
        "A": np.asarray(A, np.float32),
        "B": np.asarray(B, np.float32),
    }
    if H is not None:
        arrays["H"] = np.asarray(H, np.float32)
    with atomic_artifact(path) as tmp:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    faults.maybe_tear(path)  # no-op unless CNMF_TPU_FAULT_SPEC


def load_pass_checkpoint(path, *, expect: dict | None = None,
                         n_genes: int | None = None,
                         n_rows: int | None = None,
                         n_rows_min: int | None = None) -> dict:
    """Load + validate a pass checkpoint; :class:`TornCheckpointError` on
    ANY defect. ``expect`` pins the replicate identity (the
    ``_IDENTITY_KEYS`` subset it carries); ``n_genes``/``n_rows`` pin the
    factor shapes of the solve about to resume.

    ``n_rows_min``: accept an ``H`` whose row count is at least this many
    rows instead of exactly ``n_rows`` — the checkpoint's H carries its
    writer's zero row padding (rows past the true cell count are exactly
    zero), which the resuming loop trims or re-pads to its own."""
    try:
        with np.load(path, allow_pickle=False) as f:
            data = {key: np.asarray(f[key]) for key in f.files}
    except Exception as exc:
        raise TornCheckpointError(
            f"{path}: unreadable checkpoint ({type(exc).__name__}: {exc})")
    required = set(_IDENTITY_KEYS) | set(_ARRAY_KEYS) | {
        "schema", "pass_idx", "err_prev", "err"}
    missing = required - set(data)
    if missing:
        raise TornCheckpointError(
            f"{path}: checkpoint missing members {sorted(missing)}")
    if int(data["schema"]) != CKPT_SCHEMA:
        raise TornCheckpointError(
            f"{path}: checkpoint schema {int(data['schema'])} (this build "
            f"understands {CKPT_SCHEMA})")
    state: dict = {
        "pass_idx": int(data["pass_idx"]),
        "err_prev": float(data["err_prev"]),
        "err": float(data["err"]),
        "trace": np.asarray(data["trace"], np.float32),
        "W": np.asarray(data["W"], np.float32),
        "A": np.asarray(data["A"], np.float32),
        "B": np.asarray(data["B"], np.float32),
        "H": (np.asarray(data["H"], np.float32) if "H" in data else None),
    }
    for key in _IDENTITY_KEYS:
        state[key] = (str(data[key]) if key in ("digest", "params")
                      else (float(data[key]) if key == "beta"
                            else int(data[key])))
    if expect:
        for key, want in expect.items():
            have = state.get(key)
            same = (str(want) == str(have) if key in ("digest", "params")
                    else float(want) == float(have))
            if not same:
                raise TornCheckpointError(
                    f"{path}: checkpoint {key}={have!r} does not match the "
                    f"replicate being resumed ({key}={want!r})")
    k = state["k"]
    if state["W"].ndim != 2 or state["W"].shape[0] != k:
        raise TornCheckpointError(
            f"{path}: W shape {state['W'].shape} does not match k={k}")
    if n_genes is not None and state["W"].shape[1] != int(n_genes):
        raise TornCheckpointError(
            f"{path}: W has {state['W'].shape[1]} gene columns, expected "
            f"{int(n_genes)}")
    if state["H"] is not None:
        rows = state["H"].shape[0] if state["H"].ndim == 2 else -1
        bad = state["H"].ndim != 2 or state["H"].shape[1] != k
        if n_rows_min is not None:
            bad = bad or rows < int(n_rows_min)
        elif n_rows is not None:
            bad = bad or rows != int(n_rows)
        if bad:
            raise TornCheckpointError(
                f"{path}: H shape {state['H'].shape} does not match the "
                f"resumed solve ({n_rows_min if n_rows_min is not None else n_rows} x {k})")
    if state["pass_idx"] < 1:
        raise TornCheckpointError(
            f"{path}: pass cursor {state['pass_idx']} < 1")
    finite = (np.isfinite(state["W"]).all()
              and np.isfinite(np.float32(state["err"]))
              and (state["H"] is None or np.isfinite(state["H"]).all()))
    if not finite:
        raise TornCheckpointError(f"{path}: nonfinite checkpoint state")
    return state


def probe_pass_checkpoint(path, **kwargs):
    """Resume-side probe: ``(state, None)`` when present AND valid,
    ``(None, "missing")`` when absent, else ``(None, reason)`` — the
    caller treats anything non-valid as "start this replicate from
    scratch", never trusting a damaged file."""
    if not os.path.exists(path):
        return None, "missing"
    try:
        return load_pass_checkpoint(path, **kwargs), None
    except TornCheckpointError as exc:
        return None, str(exc)


class PassCheckpointer:
    """Per-replicate checkpoint policy handed to the rowsharded solver.

    Holds the path, cadence (``every`` passes; <= 0 is inert), the
    replicate identity (``meta``: k/iter/seed/attempt/digest/beta), and
    the telemetry sink. A FRESH factorize (``resume=False``) discards any
    stale file at construction — a fresh run recomputes every replicate,
    so a prior run's cursor is void (same rule as
    ``resilience.sweep_stale_ledgers``); only ``--skip-completed-runs``
    resumes load.
    """

    def __init__(self, path, every: int, *, meta: dict, events=None,
                 worker=0, resume: bool = False,
                 h_budget_bytes: int | None = None,
                 min_interval_s: float | None = None):
        self.path = os.fspath(path)
        self.every = int(every)
        self.meta = {key: (meta[key] if key != "params"
                           else str(meta.get(key, "")))
                     for key in _IDENTITY_KEYS}
        self.events = events
        self.worker = worker
        self.resume = bool(resume)
        self.h_budget = (ckpt_h_budget_bytes() if h_budget_bytes is None
                         else int(h_budget_bytes))
        self.min_interval_s = (ckpt_min_interval_s()
                               if min_interval_s is None
                               else float(min_interval_s))
        self._last_save: float | None = None
        if not self.resume:
            self.discard()

    def _emit(self, action: str, **ctx):
        if self.events is not None:
            context = {key: val for key, val in self.meta.items()
                       if key != "digest"}
            context.update(path=self.path, **ctx)
            self.events.emit("checkpoint", action=action, context=context)

    def due(self) -> bool:
        """Whether a save at this point would actually persist — lets the
        solver skip the device→host gather entirely when the wall-clock
        floor (``min_interval_s``) says the write would be dropped."""
        if self.every <= 0:
            return False
        if self.min_interval_s > 0 and self._last_save is not None:
            import time

            return (time.monotonic() - self._last_save
                    >= self.min_interval_s)
        return True

    def load(self, n_rows: int | None = None, n_genes: int | None = None,
             n_rows_min: int | None = None):
        """Validated state for a resume, or ``None`` (absent / fresh run /
        torn — a torn checkpoint is discarded, surfaced as a telemetry
        ``fault``, and the replicate restarts from scratch).
        ``n_rows_min`` relaxes the exact H row check to a floor (see
        :func:`load_pass_checkpoint`)."""
        if not self.resume or self.every <= 0:
            return None
        state, reason = probe_pass_checkpoint(
            self.path, expect=self.meta, n_genes=n_genes, n_rows=n_rows,
            n_rows_min=n_rows_min)
        if state is None:
            if reason != "missing":
                warnings.warn(
                    "resume: pass checkpoint failed validation and is "
                    "discarded; the replicate restarts from scratch — %s"
                    % reason, RuntimeWarning, stacklevel=2)
                if self.events is not None:
                    self.events.emit("fault", kind="torn_artifact",
                                     context={"path": self.path,
                                              "reason": reason})
                self.discard(emit=False)
            return None
        self._emit("resume", pass_idx=state["pass_idx"],
                   with_h=state["H"] is not None)
        return state

    def save(self, *, pass_idx, err_prev, err, trace, W, A, B, H=None):
        """Persist the pass state (H only under the byte budget), then run
        the chaos hooks in real-preemption order: tear-after-write
        (``torn:artifact=ckpt``, inside ``save_pass_checkpoint``) before
        kill-at-stage (``kill:stage=pass``). Writes closer together than
        ``min_interval_s`` wall-clock are skipped (resume just restarts
        from the slightly older pass) — the amplification cap for runs
        whose passes take seconds."""
        if self.every <= 0:
            return
        import time

        if (self.min_interval_s > 0 and self._last_save is not None
                and time.monotonic() - self._last_save
                < self.min_interval_s):
            return
        if H is not None and getattr(H, "nbytes", 0) > self.h_budget:
            H = None
        save_pass_checkpoint(
            self.path, pass_idx=pass_idx, err_prev=err_prev, err=err,
            trace=trace, W=W, A=A, B=B, H=H,
            k=self.meta["k"], it=self.meta["iter"], seed=self.meta["seed"],
            attempt=self.meta["attempt"], digest=self.meta["digest"],
            beta=self.meta["beta"], params=self.meta["params"])
        self._last_save = time.monotonic()
        self._emit("write", pass_idx=int(pass_idx), with_h=H is not None)
        from . import faults

        faults.maybe_kill("pass", self.worker)

    def discard(self, emit: bool = True):
        """Remove the checkpoint (replicate completed, superseded, or
        invalid) — missing file is a no-op."""
        if not os.path.exists(self.path):
            return
        try:
            os.unlink(self.path)
        except OSError:
            return
        if emit:
            self._emit("discard")
