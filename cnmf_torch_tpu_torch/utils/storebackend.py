"""Shard-store transport backends.

Own copy of the local part of ``cnmf_torch_tpu/utils/storebackend.py``:
the five-verb :class:`StoreBackend` contract (``get``/``put``/``exists``/
``list``/``delete``) that ``utils/shardstore.py`` reads and writes
through, and :class:`LocalBackend`, the POSIX store directory (plain
reads; writes land through an atomic same-directory rename whose temp
name carries ``.tmp-<pid>``, as the JAX package's do, so either
package's temp sweep finds the other's debris). Digest validation, the
manifest-last protocol and torn-read healing stay above this seam, in
the shard store.

``CNMF_TPU_STORE_URI``: unset keeps the store at its own path;
``file:///base`` relocates it under ``base/<leaf>``. The remote object
store (``http(s)://``) is not ported yet: it raises
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import urllib.parse

from ..obs import metrics as obs_metrics
from .envknobs import env_str

__all__ = ["STORE_URI_ENV", "StoreBackend", "LocalBackend",
           "resolve_backend", "store_cache_dir", "backend_counter_snapshot"]

STORE_URI_ENV = "CNMF_TPU_STORE_URI"


class _Counters:
    """Thread-safe per-backend operation counters (the remote transport's
    retries, hedges and cache traffic in the JAX package; a local backend
    never bumps them)."""

    FIELDS = ("retries", "healed", "hedges", "hedges_won",
              "cache_hits", "cache_misses", "degraded_reads")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def bump(self, key: str, n: int = 1):
        with self._lock:
            setattr(self, key, getattr(self, key) + int(n))
        obs_metrics.counter_inc("cnmf_store_%s_total" % key, n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: int(getattr(self, f)) for f in self.FIELDS}


def backend_counter_snapshot(obj):
    """Counter snapshot of a store's backend when it is remote, else
    ``None``. Accepts a ``ShardStore`` (has ``.backend``) or a backend."""
    bk = getattr(obj, "backend", obj)
    if bk is None or getattr(bk, "kind", "local") != "remote":
        return None
    return bk.counters.snapshot()


class StoreBackend:
    """Transport contract the shard store reads and writes through. Object
    names are flat (``manifest.json``, ``names.npz``, ``slab_*.npz``);
    ``op`` (``slab``/``meta``/``manifest``) names the operation class."""

    kind = "abstract"

    def __init__(self):
        self.counters = _Counters()

    def get(self, name, *, op="slab", refresh=False, events=None) -> bytes:
        raise NotImplementedError

    def put(self, name, data, *, op="slab", events=None) -> None:
        raise NotImplementedError

    def exists(self, name, *, events=None) -> bool:
        raise NotImplementedError

    def list(self, *, events=None) -> list:
        raise NotImplementedError

    def delete(self, name, *, events=None) -> None:
        raise NotImplementedError

    def describe(self, name) -> str:
        """Human-readable location of ``name`` for error messages."""
        raise NotImplementedError


@contextlib.contextmanager
def _atomic_write(path: str):
    """A same-directory ``<path>.tmp-<pid>`` temp renamed onto ``path``
    when the block succeeds; removed otherwise."""
    tmp = path + ".tmp-%d" % os.getpid()
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)


class LocalBackend(StoreBackend):
    """A POSIX store directory: ``get`` is a plain read (the shard reader's
    digest and re-read ladder above handles torn reads), ``put`` lands
    atomically."""

    kind = "local"

    def __init__(self, root: str):
        super().__init__()
        self.root = os.fspath(root)

    def get(self, name, *, op="slab", refresh=False, events=None) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def put(self, name, data, *, op="slab", events=None) -> None:
        os.makedirs(self.root, exist_ok=True)
        with _atomic_write(os.path.join(self.root, name)) as tmp:
            with open(tmp, "wb") as f:
                f.write(bytes(data))

    def exists(self, name, *, events=None) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def list(self, *, events=None) -> list:
        if not os.path.isdir(self.root):
            return []
        return sorted(os.listdir(self.root))

    def delete(self, name, *, events=None) -> None:
        try:
            os.unlink(os.path.join(self.root, name))
        except FileNotFoundError:
            pass

    def describe(self, name) -> str:
        return os.path.join(self.root, name)


def store_cache_dir(store_dir) -> str:
    """The read-through cache directory of a store path, ``<store>.cache``
    beside it (a remote store's; swept with the store)."""
    return os.fspath(store_dir) + ".cache"


def resolve_backend(store_dir, uri: str | None = None) -> StoreBackend:
    """Backend for ``store_dir`` from the store URI (the argument, else
    ``CNMF_TPU_STORE_URI``): empty -> :class:`LocalBackend` on the path
    itself; ``file:///base`` -> under ``base/<leaf>``, ``<leaf>`` being
    the store directory's basename. ``http(s)://`` raises
    ``NotImplementedError`` (the remote store is a later slice)."""
    store_dir = os.fspath(store_dir)
    raw = env_str(STORE_URI_ENV, "") if uri is None else uri
    raw = (raw or "").strip()
    if not raw:
        return LocalBackend(store_dir)
    parts = urllib.parse.urlsplit(raw)
    scheme = parts.scheme.lower()
    leaf = os.path.basename(os.path.normpath(store_dir)) or "store"
    if scheme == "file":
        return LocalBackend(os.path.join(parts.path or "/", leaf))
    if scheme in ("http", "https"):
        raise NotImplementedError(
            "%s=%r: the remote object store (RemoteBackend, "
            "utils/netstore.py) is not ported yet; it comes with the "
            "remote-store slice of ROADMAP item 3. Use a local path or "
            "file:///base" % (STORE_URI_ENV, raw))
    raise ValueError(
        "%s=%r: expected empty (local paths), file:///base/dir, or "
        "http(s)://host[:port]/prefix" % (STORE_URI_ENV, raw))
