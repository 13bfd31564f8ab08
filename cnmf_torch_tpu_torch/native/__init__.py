"""The native MatrixMarket reader behind the 10x ``.mtx`` input.

Own copy of the JAX package's ``cnmf_torch_tpu/native``: the header (banner
and size line) parses in Python, the body in one multi-threaded C++ pass
over the raw buffer (``mtx_reader.cpp``), loaded through ``ctypes``.

The shared library is compiled with ``g++`` at first use into the
package's own ``build/native/`` (``utils/builddir.py``; named by the
source's content digest, as the CUDA kernels are in ``build/kernels/``),
never next to the source. Each building process writes a process-unique
temp file and renames it into place, so concurrent workers racing the
build each install a whole library. A build directory this process cannot
write raises, naming it. ``scipy.io.mmread`` reads what the parser does
not take (symmetric and array-format files, complex fields) and every file
on a machine without a toolchain; :func:`native_available` says which
reader runs.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import io
import os
import subprocess
import threading

import numpy as np
import scipy.sparse as sp

from ..utils import builddir

__all__ = ["read_mtx", "native_available", "BUILD_DIR", "SOURCE"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "mtx_reader.cpp")
BUILD_DIR = builddir.build_dir("native")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmtx_reader_{digest}.so")


def _build(path: str) -> bool:
    # a process-unique temp name, then an atomic rename: a half-written
    # library at ``path`` would poison every loser of a build race
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE,
           "-o", tmp]
    builddir.writable_build_dir(BUILD_DIR, "the .mtx reader is built")
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.mtx_parse_body.restype = ctypes.c_longlong
        lib.mtx_parse_body.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the C++ parser is built and loaded (building it now if
    need be); False means every file goes through scipy."""
    return _load() is not None


def _read_raw(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def read_mtx(path: str) -> sp.coo_matrix:
    """Read a MatrixMarket coordinate file (optionally ``.gz``) to COO
    with f64 values, as the JAX package's ``read_mtx`` does: the C++ body
    parser for general real/integer/pattern files, ``scipy.io.mmread`` for
    the rest or when the library is unavailable. A malformed entry, a
    truncated body, more entries than declared and out-of-bounds indices
    raise ``ValueError`` naming the file."""
    lib = _load()
    raw = _read_raw(path)

    nl = raw.find(b"\n")
    banner = raw[:nl].decode("latin1").lower().split()
    fast = (lib is not None and len(banner) >= 4
            and banner[0] == "%%matrixmarket" and banner[1] == "matrix"
            and banner[2] == "coordinate"
            and banner[3] in ("real", "integer", "pattern")
            and (len(banner) < 5 or banner[4] in ("general",)))
    if not fast:
        import scipy.io

        return sp.coo_matrix(scipy.io.mmread(io.BytesIO(raw)))

    pattern = banner[3] == "pattern"
    # skip comments to the size line; a file ending inside a comment
    # raises instead of looping
    pos = nl + 1
    while pos < len(raw) and raw[pos:pos + 1] == b"%":
        next_nl = raw.find(b"\n", pos)
        if next_nl < 0:
            raise ValueError(f"{path}: truncated header (unterminated comment)")
        pos = next_nl + 1
    size_end = raw.find(b"\n", pos)
    if size_end < 0:
        size_end = len(raw)
    try:
        n_rows, n_cols, nnz = (int(t) for t in raw[pos:size_end].split())
    except ValueError:
        raise ValueError(f"{path}: malformed MatrixMarket size line") from None

    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    body = raw[size_end + 1:]
    got = lib.mtx_parse_body(
        body, len(body),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nnz, int(pattern), 0)
    if got == -(len(body) + 2):
        raise ValueError(
            f"{path}: body contains more entries than the header declares")
    if got < 0:
        raise ValueError(
            f"malformed MatrixMarket entry near byte {-got - 1} of {path}")
    if got != nnz:
        raise ValueError(
            f"{path}: header declares {nnz} entries, parsed {got}")
    if nnz and (rows.max() >= n_rows or cols.max() >= n_cols
                or rows.min() < 0 or cols.min() < 0):
        raise ValueError(f"{path}: entry indices out of declared bounds")
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
