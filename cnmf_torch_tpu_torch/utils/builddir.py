"""Where the port builds its native code at first use.

The CUDA kernels (``ops/kernels/kl_ell.py``) and the ``.mtx`` reader
(``native/``) compile into ``build/`` inside this package's own directory:
``<package>/build/kernels`` and ``<package>/build/native``. The rule is
the same in a checkout and in an install, so an installed copy never
writes a shared ``site-packages/build`` (which is another package's import
directory). Libraries are named by their source's content digest, and each
building process renames a process-unique temp file into place.
"""

from __future__ import annotations

import os
import tempfile

__all__ = ["PACKAGE_DIR", "BUILD_ROOT", "build_dir", "writable_build_dir"]

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(PACKAGE_DIR, "build")


def build_dir(sub: str) -> str:
    """``<package>/build/<sub>``."""
    return os.path.join(BUILD_ROOT, sub)


def writable_build_dir(path: str, what: str) -> None:
    """Create ``path`` and prove this process can write a file there; raise
    ``RuntimeError`` naming the directory otherwise. ``what`` says what is
    built there (e.g. "the CUDA kernels are built")."""
    try:
        os.makedirs(path, exist_ok=True)
        fd, probe = tempfile.mkstemp(prefix=".probe_", dir=path)
        os.close(fd)
        os.unlink(probe)
    except OSError as exc:
        raise RuntimeError(
            f"cannot write the build directory {path} "
            f"({exc.strerror or exc}), where {what} at first use: make it "
            "writable for this process") from exc
