"""Out-of-core row-slab shard store of the normalized counts.

Own copy of ``cnmf_torch_tpu/utils/shardstore.py``, with its on-disk
format byte for byte: one ``slab_NNNNN.npz`` a slab (CSR members
``data``/``indices``/``indptr`` or a dense ``block``), ``names.npz``
(``obs``/``var``) and ``manifest.json`` with the same keys, per-slab
sha1 content digests, the names digest, the input digest and the store
digest. A store either package writes opens in the other.

  * :func:`write_shard_store` — the prepare-time writer: values land as
    float32, every object through the transport backend
    (``utils/storebackend.py``), the manifest LAST, so a crash mid-write
    leaves an unopenable store, never a torn one.
  * :class:`ShardStore` — the validated reader: ``read_slab`` verifies
    each slab's digest on every read and re-reads on a mismatch (up to
    ``CNMF_TPU_SHARD_RETRIES``), emitting a ``fault`` event a detection;
    a slab that stays torn raises :class:`TornShardError`.
  * :class:`SlabCursor` — a row-range view the streaming engine
    (``parallel/streaming.py``) consumes as its disk-producer stage.
  * :class:`HostResidency` — the live host-bytes ledger of one staging
    call, whose peak the slab-budget checks read.

Knobs (``utils/envknobs.py``): ``CNMF_TPU_OOC`` (auto|0|1),
``CNMF_TPU_OOC_BUDGET_BYTES`` (host slab budget), ``CNMF_TPU_OOC_SLAB_ROWS``
(write-time slab rows; 0 = from the budget), ``CNMF_TPU_OOC_SHARD_BYTES``
(resident-shard budget of the slab-looped solver,
``parallel/rowshard.py``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import warnings
import zipfile

import numpy as np
import scipy.sparse as sp

from .envknobs import env_int, env_str
from .storebackend import resolve_backend, store_cache_dir

__all__ = [
    "OOC_ENV",
    "OOC_BUDGET_ENV",
    "OOC_SLAB_ROWS_ENV",
    "OOC_SHARD_BYTES_ENV",
    "SHARD_RETRIES_ENV",
    "STORE_SCHEMA",
    "TornShardError",
    "ShardStore",
    "SlabCursor",
    "HostResidency",
    "ooc_mode",
    "ooc_budget_bytes",
    "ooc_shard_bytes",
    "shard_reread_retries",
    "host_matrix_bytes",
    "write_shard_store",
    "open_shard_store",
    "probe_shard_store",
    "sweep_store_temps",
]

OOC_ENV = "CNMF_TPU_OOC"
OOC_BUDGET_ENV = "CNMF_TPU_OOC_BUDGET_BYTES"
OOC_SLAB_ROWS_ENV = "CNMF_TPU_OOC_SLAB_ROWS"
OOC_SHARD_BYTES_ENV = "CNMF_TPU_OOC_SHARD_BYTES"
SHARD_RETRIES_ENV = "CNMF_TPU_SHARD_RETRIES"

STORE_SCHEMA = 1

_MANIFEST = "manifest.json"
_NAMES = "names.npz"

_DEFAULT_BUDGET = 1 << 30


class TornShardError(RuntimeError):
    """A shard-store file exists but cannot be trusted (unreadable,
    truncated, digest mismatch, wrong shapes/schema)."""


def ooc_mode() -> str:
    """``CNMF_TPU_OOC``: ``auto`` (default — store written at prepare when
    the matrix exceeds the slab budget, read whenever present), ``1``
    (store forced AND authoritative: the normalized-counts matrix file is
    skipped), ``0`` (subsystem off)."""
    raw = env_str(OOC_ENV, "auto").strip().lower() or "auto"
    if raw not in ("auto", "0", "1"):
        raise ValueError(
            f"{OOC_ENV}={raw!r}: expected 'auto', '0', or '1'")
    return raw


def ooc_budget_bytes() -> int:
    """Per-worker HOST slab-residency budget (``CNMF_TPU_OOC_BUDGET_BYTES``,
    default 1 GiB): in-flight host slab buffers during store-backed
    ingestion stay under it (a single slab is the irreducible floor), and
    prepare's ``auto`` mode writes the store when the matrix's host
    footprint exceeds it."""
    return env_int(OOC_BUDGET_ENV, _DEFAULT_BUDGET, lo=1)


def ooc_shard_bytes() -> int:
    """Per-DEVICE resident-shard budget (``CNMF_TPU_OOC_SHARD_BYTES``)
    above which the rowsharded solver runs each pass as a loop over
    streamed X slab groups instead of staging the shard resident.
    ``0`` (default) derives from the card's free memory at the dispatch
    site (``parallel/rowshard.py``); on the CPU, a conservative 8 GB."""
    return env_int(OOC_SHARD_BYTES_ENV, 0, lo=0)


def shard_reread_retries() -> int:
    """Shard-layer re-read budget for a torn/digest-mismatched slab read
    (``CNMF_TPU_SHARD_RETRIES``, default 2; ``0`` disables). The same
    knob also bounds the staging pipeline's per-slab upload retries
    (``parallel/streaming.py``)."""
    return env_int(SHARD_RETRIES_ENV, 2, lo=0)


def host_matrix_bytes(X) -> int:
    """Host-RAM footprint of a matrix as loaded (CSR buffers or the dense
    array) — the quantity the slab budget bounds."""
    if sp.issparse(X):
        Xc = X.tocsr()
        return int(Xc.data.nbytes + Xc.indices.nbytes + Xc.indptr.nbytes)
    return int(np.asarray(X).nbytes)


class HostResidency:
    """Thread-safe live-bytes ledger for one staging call: every host slab
    buffer charges on allocation and releases when dropped; ``peak`` is
    the high-water mark the slab-budget tests assert against."""

    def __init__(self):
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0

    def charge(self, nbytes: int):
        with self._lock:
            self.live += int(nbytes)
            if self.live > self.peak:
                self.peak = self.live

    def release(self, nbytes: int):
        with self._lock:
            self.live = max(0, self.live - int(nbytes))


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def _arrays_digest(arrays) -> str:
    """sha1 over the raw bytes of an ordered array list — the per-slab
    content digest verified on every read."""
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype.str).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _slab_arrays(block, fmt: str):
    if fmt == "csr":
        return (block.data, block.indices, block.indptr)
    return (np.ascontiguousarray(block),)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _auto_slab_rows(g: int, itemsize: int, budget: int) -> int:
    """Write-time slab rows: dense-equivalent slab bytes <= budget/4 so
    the reader's depth window (>= 2 slabs in flight plus a commit drain)
    fits the budget, floored at 256 rows so tiny budgets don't explode
    the slab count."""
    rows = env_int(OOC_SLAB_ROWS_ENV, 0, lo=0)
    if rows:
        return rows
    row_bytes = max(int(g) * int(itemsize), 1)
    return max(256, (int(budget) // 4) // row_bytes)


def write_shard_store(store_dir, X, obs_names=None, var_names=None,
                      slab_rows: int | None = None, events=None,
                      backend=None) -> dict:
    """Write the row-slab shard store for matrix ``X`` under ``store_dir``.

    Layout: ``slab_NNNNN.npz`` per slab (CSR triplets ``data``/``indices``/
    ``indptr`` or a dense ``block``), ``names.npz`` (obs/var name arrays),
    and ``manifest.json`` — every object through the transport backend
    (local puts land atomically), manifest
    LAST so readers only ever see complete stores. Values land as float32
    (the solve dtype; prepare's f64 moment accumulators never reach disk).
    Returns the manifest dict.
    """
    store_dir = os.fspath(store_dir)
    if backend is None:
        backend = resolve_backend(store_dir)
    # a previous prepare's slabs are stale the moment this writer starts;
    # remove them up front so a shrinking slab count can't leave orphans
    # a future manifest never references (the manifest-last protocol makes
    # the store unopenable until this write completes)
    _clear_backend(backend)

    fmt = "csr" if sp.issparse(X) else "dense"
    if fmt == "csr":
        X = X.tocsr().astype(np.float32)
    else:
        X = np.asarray(X, dtype=np.float32)
    n, g = X.shape
    if slab_rows is None:
        slab_rows = _auto_slab_rows(g, 4, ooc_budget_bytes())
    slab_rows = max(int(slab_rows), 1)

    slabs = []
    # n == 0 writes ZERO slabs (the reader's contiguity check expects an
    # empty slab list for an empty matrix, never a degenerate [0, 0) slab)
    for i, lo in enumerate(range(0, n, slab_rows)):
        hi = min(lo + slab_rows, n)
        block = X[lo:hi]
        arrays = _slab_arrays(block, fmt)
        fn = "slab_%05d.npz" % i
        # serialize to memory, hand bytes to the transport (the npz
        # bytes never touch disk non-atomically: the local backend
        # lands them atomically)
        buf = io.BytesIO()
        if fmt == "csr":
            np.savez(buf, data=arrays[0], indices=arrays[1],
                     indptr=arrays[2])
        else:
            np.savez(buf, block=arrays[0])
        backend.put(fn, buf.getvalue(), op="slab", events=events)
        if fmt == "csr":
            nnz = int(block.nnz)
            row_nnz = np.diff(block.indptr)
            max_row = int(row_nnz.max()) if row_nnz.size else 0
            value_sum = float(block.data.sum(dtype=np.float64))
            raw_bytes = int(sum(a.nbytes for a in arrays))
        else:
            nnz = int(np.count_nonzero(block))
            max_row = (int(np.count_nonzero(block, axis=1).max())
                       if block.shape[0] else 0)
            value_sum = float(block.sum(dtype=np.float64))
            raw_bytes = int(arrays[0].nbytes)
        slabs.append({
            "i": i, "row0": int(lo), "row1": int(hi), "nnz": nnz,
            "max_row_nnz": max_row, "value_sum": value_sum,
            "raw_bytes": raw_bytes, "digest": _arrays_digest(arrays),
            "file": fn,
        })
        if hi >= n:
            break

    obs = np.asarray([] if obs_names is None
                     else [str(s) for s in obs_names], dtype=object)
    var = np.asarray([] if var_names is None
                     else [str(s) for s in var_names], dtype=object)
    buf = io.BytesIO()
    np.savez(buf, obs=obs, var=var)
    backend.put(_NAMES, buf.getvalue(), op="meta", events=events)
    names_digest = _arrays_digest(
        (obs.astype(str).astype("U"), var.astype(str).astype("U")))

    from ..runtime.checkpoint import input_digest

    manifest = {
        "schema": STORE_SCHEMA,
        "shape": [int(n), int(g)],
        "dtype": "<f4",
        "format": fmt,
        "slab_rows": int(slab_rows),
        "slabs": slabs,
        "names_file": _NAMES,
        "names_digest": names_digest,
        # pins the store to the exact matrix prepare normalized — the
        # worker-0 staleness sweep compares it against the current matrix
        "input_digest": input_digest(X),
    }
    core = json.dumps({k: manifest[k] for k in
                       ("schema", "shape", "dtype", "format", "slab_rows",
                        "input_digest")},
                      sort_keys=True)
    h = hashlib.sha1(core.encode())
    for s in slabs:
        h.update(s["digest"].encode())
    # the checkpoint-identity digest: a re-prepare (new slabs, new input)
    # changes it, so resumes across a re-prepare restart instead of
    # splicing two matrices' trajectories (runtime/checkpoint.py)
    manifest["store_digest"] = h.hexdigest()

    backend.put(_MANIFEST, json.dumps(manifest).encode("utf-8"),
                op="manifest", events=events)
    if events is not None:
        events.emit("dispatch", decision="shard_store_write",
                    context={"slabs": len(slabs), "rows": int(n),
                             "format": fmt, "slab_rows": int(slab_rows),
                             "backend": backend.kind,
                             "store_bytes": int(sum(s["raw_bytes"]
                                                    for s in slabs))})
    return manifest


def _clear_backend(backend):
    """Delete a previous store generation through the transport —
    manifest FIRST, so a crash mid-clear leaves an unopenable store,
    never a manifest referencing deleted slabs."""
    stale = [s for s in backend.list()
             if s == _MANIFEST or s == _NAMES or s.startswith("slab_")
             or ".tmp-" in s]
    for s in sorted(stale, key=lambda fn: fn != _MANIFEST):
        backend.delete(s)


def _clear_store(store_dir: str):
    for fn in os.listdir(store_dir):
        if (fn == _MANIFEST or fn == _NAMES or fn.startswith("slab_")
                or ".tmp-" in fn):
            try:
                os.unlink(os.path.join(store_dir, fn))
            except OSError:
                pass


def remove_store(store_dir) -> None:
    """Delete a LOCAL store directory, its contents, and its read-through
    cache (stale store sweep)."""
    store_dir = os.fspath(store_dir)
    cache_dir = store_cache_dir(store_dir)
    if os.path.isdir(cache_dir):
        for fn in os.listdir(cache_dir):
            try:
                os.unlink(os.path.join(cache_dir, fn))
            except OSError:
                pass
        try:
            os.rmdir(cache_dir)
        except OSError:
            pass
    if not os.path.isdir(store_dir):
        return
    _clear_store(store_dir)
    try:
        os.rmdir(store_dir)
    except OSError:
        pass


def sweep_store_temps(store_dir) -> int:
    """Remove orphaned atomic-write temp files inside a store directory
    AND its read-through cache (killed writers leave pid-suffixed temps
    no reader ever trusts); returns the count removed. Complete stores
    and digest-valid cache entries are left intact."""
    store_dir = os.fspath(store_dir)
    n = 0
    for d in (store_dir, store_cache_dir(store_dir)):
        if not os.path.isdir(d):
            continue
        for fn in os.listdir(d):
            if ".tmp-" in fn:
                try:
                    os.unlink(os.path.join(d, fn))
                    n += 1
                except OSError:
                    pass
    return n


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class ShardStore:
    """Validated reader over a written store. Open via
    :func:`open_shard_store`; every slab read re-verifies its content
    digest (torn reads retry from disk). Thread-safe for concurrent
    reads (the streaming pipeline's disk-producer stage)."""

    def __init__(self, store_dir: str, manifest: dict, backend=None):
        self.dir = store_dir
        self.backend = backend if backend is not None \
            else resolve_backend(store_dir)
        self.manifest = manifest
        self.shape = tuple(int(s) for s in manifest["shape"])
        self.format = str(manifest["format"])
        self.dtype = np.dtype(str(manifest["dtype"]))
        self.slabs = list(manifest["slabs"])
        self.store_digest = str(manifest["store_digest"])
        self.input_digest = str(manifest["input_digest"])
        self.nnz = int(sum(s["nnz"] for s in self.slabs))
        self.max_row_nnz = int(max((s["max_row_nnz"] for s in self.slabs),
                                   default=0))
        self.value_sum = float(sum(s["value_sum"] for s in self.slabs))
        self.store_bytes = int(sum(s["raw_bytes"] for s in self.slabs))
        self.max_slab_bytes = int(max((s["raw_bytes"] for s in self.slabs),
                                      default=0))
        self._names = None
        self._names_lock = threading.Lock()

    # -- metadata ------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_genes(self) -> int:
        return self.shape[1]

    @property
    def density(self) -> float:
        n, g = self.shape
        return self.nnz / max(n * g, 1)

    def _load_names(self):
        with self._names_lock:
            if self._names is None:
                raw = self.backend.get(self.manifest["names_file"],
                                       op="meta")
                with np.load(io.BytesIO(raw), allow_pickle=True) as f:
                    obs = [str(s) for s in f["obs"]]
                    var = [str(s) for s in f["var"]]
                want = self.manifest.get("names_digest")
                if want is not None:
                    got = _arrays_digest(
                        (np.asarray(obs, dtype="U"),
                         np.asarray(var, dtype="U")))
                    if got != want:
                        raise TornShardError(
                            "%s: obs/var names digest mismatch (%s != %s) "
                            "— torn or tampered names file"
                            % (self.backend.describe(
                                self.manifest["names_file"]),
                               got, want))
                self._names = (obs, var)
        return self._names

    def obs_names(self) -> list:
        return self._load_names()[0]

    def var_names(self) -> list:
        return self._load_names()[1]

    # -- slab access ---------------------------------------------------

    def slab_indices_for_rows(self, lo: int, hi: int) -> list[int]:
        """Slabs overlapping global rows [lo, hi) — the "open only your
        own row range" primitive."""
        return [s["i"] for s in self.slabs
                if s["row1"] > lo and s["row0"] < hi]

    def worker_ranges(self, total: int) -> list[tuple[int, int]]:
        """Contiguous, slab-aligned row-range partition for ``total``
        workers/hosts (a range may be empty when slabs < workers): each
        participant then opens ONLY its own slabs."""
        total = max(int(total), 1)
        n_slabs = len(self.slabs)
        out = []
        per = n_slabs / total
        for w in range(total):
            a = int(round(w * per))
            b = int(round((w + 1) * per))
            if a >= b:
                out.append((self.n_rows, self.n_rows))
            else:
                out.append((int(self.slabs[a]["row0"]),
                            int(self.slabs[b - 1]["row1"])))
        return out

    def read_slab(self, i: int, events=None, residency=None):
        """One slab, digest-verified, as CSR (``format='csr'``) or ndarray.

        A digest mismatch / unreadable file is a TORN READ: it re-reads
        from disk up to ``CNMF_TPU_SHARD_RETRIES`` times (emitting a
        ``fault`` event per detection) before raising
        :class:`TornShardError` — a damaged slab is healed by a clean
        re-read or failed loudly, never handed to the solver. The
        ``shard_read`` chaos clause (``runtime/faults.py``) injects the
        corruption deterministically. ``residency`` (a
        :class:`HostResidency`) is charged with the slab's raw bytes —
        the caller releases when the buffer is dropped."""
        from ..runtime import faults

        meta = self.slabs[i]
        path = self.backend.describe(meta["file"])
        retries = shard_reread_retries()
        attempt = 0
        refresh = False
        while True:
            try:
                arrays = self._load_arrays(meta["file"], refresh=refresh,
                                           events=events)
                if faults.maybe_shard_read(context="slab:%d" % i):
                    # injected torn read: damage what we just loaded so
                    # the digest check below must catch it
                    arrays = tuple(a.copy() for a in arrays)
                    if arrays[0].size:
                        arrays[0].view(np.uint8)[0] ^= 0xFF
                got = _arrays_digest(arrays)
                if got != meta["digest"]:
                    raise TornShardError(
                        "%s: slab %d content digest mismatch (%s != %s) — "
                        "torn or corrupted read" % (path, i, got,
                                                    meta["digest"]))
                break
            except (TornShardError, OSError, ValueError, KeyError,
                    zipfile.BadZipFile) as exc:
                attempt += 1
                # a failed validation must re-read AUTHORITATIVE bytes:
                # bypass the read-through cache from here on (a fetched
                # clean copy re-lands in the cache, healing it)
                refresh = True
                if events is not None:
                    try:
                        events.emit("fault", kind="shard_read_torn",
                                    context={"path": path, "slab": int(i),
                                             "attempt": attempt,
                                             "error": str(exc)})
                    except Exception:
                        pass
                if attempt > retries:
                    raise TornShardError(
                        "%s: slab %d failed validation after %d read "
                        "attempt(s): %s" % (path, i, attempt, exc))
                warnings.warn(
                    "shard store: slab %d read failed validation (%s); "
                    "re-reading from disk (attempt %d/%d)"
                    % (i, exc, attempt, retries),
                    RuntimeWarning, stacklevel=2)
        rows = int(meta["row1"] - meta["row0"])
        if residency is not None:
            residency.charge(meta["raw_bytes"])
        if self.format == "csr":
            return sp.csr_matrix(
                (arrays[0], arrays[1], arrays[2]),
                shape=(rows, self.n_genes))
        return arrays[0]

    def _load_arrays(self, name, refresh=False, events=None):
        raw = self.backend.get(name, op="slab", refresh=refresh,
                               events=events)
        with np.load(io.BytesIO(raw), allow_pickle=False) as f:
            if self.format == "csr":
                return (np.asarray(f["data"]), np.asarray(f["indices"]),
                        np.asarray(f["indptr"]))
            return (np.asarray(f["block"]),)

    # -- whole-matrix assembly (the "everything fits" path) ------------

    def to_matrix(self, events=None):
        """Assemble the full matrix on host — the fits-in-budget path
        (bit-identical to the matrix file's round trip: slabs are row slices of
        the same CSR/dense buffers). Callers above the budget should
        stream instead."""
        blocks = [self.read_slab(s["i"], events=events) for s in self.slabs]
        if not blocks:
            if self.format == "csr":
                return sp.csr_matrix(self.shape, dtype=self.dtype)
            return np.zeros(self.shape, dtype=self.dtype)
        if self.format == "csr":
            return sp.vstack(blocks).tocsr()
        return np.vstack(blocks)

    def row_block(self, lo: int, hi: int, events=None):
        """Rows [lo, hi) assembled on host (CSR or dense) — reads only
        the overlapping slabs. Host residency = the block itself."""
        parts = []
        for i in self.slab_indices_for_rows(lo, hi):
            meta = self.slabs[i]
            blk = self.read_slab(i, events=events)
            a = max(lo - meta["row0"], 0)
            b = min(hi, meta["row1"]) - meta["row0"]
            parts.append(blk[a:b])
        if not parts:
            if self.format == "csr":
                return sp.csr_matrix((max(hi - lo, 0), self.n_genes),
                                     dtype=self.dtype)
            return np.zeros((max(hi - lo, 0), self.n_genes),
                            dtype=self.dtype)
        if self.format == "csr":
            return sp.vstack(parts).tocsr() if len(parts) > 1 else parts[0]
        return np.vstack(parts) if len(parts) > 1 else parts[0]


class SlabCursor:
    """A row-range view over a :class:`ShardStore` — the disk-producer
    the streaming engine consumes (``parallel/streaming.py``). ``rows``
    bounds which slabs the cursor will ever open (per-worker/per-host
    ownership); reads outside raise."""

    def __init__(self, store: ShardStore, rows: tuple[int, int] | None = None,
                 events=None, residency: HostResidency | None = None):
        self.store = store
        lo, hi = (0, store.n_rows) if rows is None else rows
        if not (0 <= lo <= hi <= store.n_rows):
            raise ValueError(
                f"cursor rows [{lo}, {hi}) outside store rows "
                f"[0, {store.n_rows})")
        self.rows = (int(lo), int(hi))
        self.events = events
        self.residency = residency if residency is not None \
            else HostResidency()
        self.slabs_read: list[int] = []
        self._lock = threading.Lock()

    @property
    def n_rows(self) -> int:
        return self.rows[1] - self.rows[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.store.n_genes)

    def tasks(self) -> list[tuple[int, int, int]]:
        """Ordered ``(slab_index, row0, row1)`` segments covering this
        cursor's rows (global coordinates, clipped to the range)."""
        lo, hi = self.rows
        out = []
        for i in self.store.slab_indices_for_rows(lo, hi):
            meta = self.store.slabs[i]
            out.append((i, max(meta["row0"], lo), min(meta["row1"], hi)))
        return out

    def read(self, slab_i: int):
        """One slab (digest-verified) — refuses slabs outside the
        cursor's row range, which is exactly the ownership property the
        per-worker ingestion tests pin."""
        meta = self.store.slabs[slab_i]
        lo, hi = self.rows
        if meta["row1"] <= lo or meta["row0"] >= hi:
            raise ValueError(
                f"slab {slab_i} (rows [{meta['row0']}, {meta['row1']})) is "
                f"outside this cursor's range [{lo}, {hi}) — a worker must "
                "only open its own row-range slabs")
        with self._lock:
            self.slabs_read.append(int(slab_i))
        return self.store.read_slab(slab_i, events=self.events,
                                    residency=self.residency)

    def release(self, slab_i: int):
        self.residency.release(self.store.slabs[slab_i]["raw_bytes"])


# ---------------------------------------------------------------------------
# open / probe
# ---------------------------------------------------------------------------

def open_shard_store(store_dir, backend=None, events=None) -> ShardStore:
    """Open + validate a store's manifest; :class:`TornShardError` on any
    structural defect (slab digests are verified lazily per read). Slab
    presence is checked against ONE backend listing."""
    store_dir = os.fspath(store_dir)
    if backend is None:
        backend = resolve_backend(store_dir)
    path = backend.describe(_MANIFEST)
    try:
        manifest = json.loads(
            backend.get(_MANIFEST, op="manifest",
                        events=events).decode("utf-8"))
    except (OSError, ValueError) as exc:
        # FileNotFoundError and JSONDecodeError both land here
        raise TornShardError(f"{path}: unreadable manifest ({exc})")
    if int(manifest.get("schema", -1)) != STORE_SCHEMA:
        raise TornShardError(
            f"{path}: store schema {manifest.get('schema')!r} (this build "
            f"understands {STORE_SCHEMA})")
    for key in ("shape", "dtype", "format", "slabs", "store_digest",
                "input_digest"):
        if key not in manifest:
            raise TornShardError(f"{path}: manifest missing {key!r}")
    if manifest["format"] not in ("csr", "dense"):
        raise TornShardError(
            f"{path}: unknown slab format {manifest['format']!r}")
    n = int(manifest["shape"][0])
    present = set(backend.list(events=events))
    prev = 0
    for s in manifest["slabs"]:
        if int(s["row0"]) != prev or int(s["row1"]) <= int(s["row0"]):
            raise TornShardError(
                f"{path}: slab row ranges are not a contiguous partition "
                f"(slab {s.get('i')}: [{s.get('row0')}, {s.get('row1')}))")
        prev = int(s["row1"])
        if s["file"] not in present:
            raise TornShardError(
                f"{path}: slab file {s['file']!r} is missing")
    if prev != n and not (n == 0 and not manifest["slabs"]):
        raise TornShardError(
            f"{path}: slabs cover {prev} rows, manifest says {n}")
    return ShardStore(store_dir, manifest, backend=backend)


def probe_shard_store(store_dir, events=None):
    """``(store, None)`` when present AND valid, ``(None, 'missing')``
    when absent, else ``(None, reason)`` — callers treat anything
    non-valid as "no store" (the matrix file still exists in the
    default double-write mode)."""
    store_dir = os.fspath(store_dir)
    backend = resolve_backend(store_dir)
    if not backend.exists(_MANIFEST, events=events):
        return None, "missing"
    try:
        return open_shard_store(store_dir, backend=backend,
                                events=events), None
    except TornShardError as exc:
        return None, str(exc)
