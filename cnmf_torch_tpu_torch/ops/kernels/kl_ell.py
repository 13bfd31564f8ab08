"""CUDA kernels for the ELL KL statistics, their wrappers and launch counts.

Source: ``cnmf_torch_tpu_torch/csrc/kl_ell.cu``, built with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at first use and bound through ctypes
(a plain C interface: pointers and the stream as ``c_void_p``). Each wrapper
checks device, dtype, shape and contiguity (on the CPU too, so the CPU
tests hold callers to the kernels' layout), allocates its outputs,
launches on ``torch.cuda.current_stream()`` and raises when the launch
reports an error. A CUDA tensor launches the kernel or raises; a CPU tensor
takes the kernel's plain torch version (``ops/sparse.py``).

Kernels, and the TPU kernels they replace
(``cnmf_torch_tpu/ops/pallas_kl.py``). The ELL buffers are shared by all
``R`` replicates, so their bytes count once while the arithmetic counts
``R`` times; ``PERF.md`` holds each kernel's time beside its bound.

* ``h_stats`` <- ``pallas_kl_h_stats`` (``_h_stats_body``). One traversal
  of the stored nonzeros: WH, the ratio and the k numerators, about 4k+1
  operations per nonzero and replicate, so it is bound by operations at
  the main path's shapes. What keeps it from that bound is gathering W
  (k random values a slot), the padded slots (29% at the main path's
  shapes) and occupancy. Design: one warp per row, the
  row's H in registers; W[r] staged as a packed per-gene table (bf16 in
  bf16 mode: 64 KB at k=13, g=2000; f32 128 KB), so a lane gathers its
  slot's column once with 16-byte shared loads and keeps it for WH and the
  products; bf16x2 arithmetic with the JAX chain's roundings; a warp stops
  at its row's first window of 32 padded slots; the per-component sums
  fold across the warp in a fixed order (no atomics: repeated runs are
  bit-identical); one wave of persistent blocks sized by the occupancy
  calculator (``h_stats_launch`` reports it). A table larger than a
  block's shared memory is read from device memory instead, still once a
  slot.
* ``w_numer`` <- ``pallas_kl_w_numer`` (both passes: ``_ratio_body`` and
  ``_w_numer_body``; wrapper ``pallas_kl_w_stats`` too). One gene-side
  traversal of the stored nonzeros: at each slot WH from the row's H and
  the gene's W column, the ratio, then k products ``ratio * H``; about
  4k+1 operations per nonzero and replicate. The TPU split it in two
  passes through a flat ratio buffer (every row's ratio had to exist
  before a gene reduced it); a gene-side traversal computes WH where it
  needs it, so no ratio buffer exists. With the operands in L2, the
  sectors its gathers touch bound it. Design: one warp per (replicate,
  gene), its W column in registers (bf16 in bf16 mode), the lanes
  striding over the gene's ``rows_t``/``perm_t`` slots; a prep kernel of
  the same call packs H into scratch of whole 16-byte chunks a row (bf16
  with k rounded up to 8, or f32 to 4), so a slot gathers its row's H once
  (one or two 32-byte sectors at k <= 16) for WH and the products, and
  gathers the stored values into the gene-side layout once for all
  replicates; bf16x2 arithmetic with the JAX chain's roundings; a warp
  stops at its gene's first window of 32 padded slots (the sentinel
  ``n*w``); the per-component sums fold across the warp in a fixed order
  (no atomics). Blocks of two warps, replicate-major.
* ``beta_err_partials`` <- ``pallas_kl_beta_err`` (``_obj_body``). The
  nonzero part of each row's KL term, ``(R, n)`` f32: at each stored slot
  with ``X > 0`` WH, then the two-regime term (a division and a log1p, or
  two logs where ``WH/X < 1e-6``) minus WH; about 2k+8 operations per
  nonzero and replicate (the log1p counted as one), bound by operations.
  Design: ``h_stats``' skeleton (the packed per-gene f32 W table on the
  persistent grid of ``beta_err_launch``, device memory where the table
  does not fit, its placement a template argument); a stored slot gathers
  its column once (``ceil(k/4)`` 16-byte loads), each chunk consumed by the
  WH chain as it arrives; a warp stops at its row's first window of 32
  padded slots; a slot's WH and term are rounded as the plain version
  rounds them (no fused multiply-add), each lane adds its slots' terms in
  f64 and the warp sums them in a fixed order (no atomics), rounding the
  row's value to f32 once: it does not depend on the grid, an all-zero
  row is exactly +0.0, and a row whose terms cancel still matches the
  plain version's f64 row sum. 32 warps a block at k <= 16. The wrapper
  sums the rows in torch and adds the k-sized ``sum WH`` term, as the JAX
  wrapper does.
* ``h_newton_stats`` <- ``pallas_kl_h_newton_stats`` (``_h_newton_body``).
  The Diagonalized-Newton H statistics in one traversal, strict f32: WH,
  ``ratio = X / max(WH, EPS)``, ``r2 = ratio / max(WH, EPS)``, then per
  component the MU numerator ``ratio * W`` and the diagonal Hessian
  ``r2 * W * W``; about 7k+3 operations per nonzero and replicate, bound
  by operations. Design: ``h_stats``' skeleton with a second accumulator
  a component: the packed per-gene f32 W table on the persistent grid of
  ``h_newton_stats_launch`` (16 warps a block at k <= 16), device memory
  where the table does not fit, its placement a template argument; a
  stored slot gathers its column once (``ceil(k/4)`` 16-byte loads) and
  keeps it in registers for WH and both sums (at k > 32 it gathers each
  chunk again for the sums, to stay within 255 registers); a warp stops
  at its row's first window of 32 padded slots and skips padded slots in
  the last, so all-zero rows give exact +0.0 in both outputs, which keeps
  zero-padded components at zero under the Newton step; the two sums fold
  across the warp as one array in a fixed order (no atomics).
* ``wh_at_nz`` <- ``pallas_wh_at_nz`` (``_wh_body``). The SDDMM: WH at
  every slot of the row side, padded ones included, ``(R, n, w)`` f32,
  which the DNA step's row objectives read twice per H step. Bound by the
  bytes of that output (147 MB a call at the batch path's shapes).
  Design: ``h_stats``' skeleton (the packed per-gene f32 W table, one
  gather of ``ceil(k/4)`` 16-byte shared loads a slot, device memory where
  the table does not fit, the persistent grid of ``wh_at_nz_launch``);
  every slot at column 0 (the padding, and gene 0 where stored) takes the
  row's column-0 value, computed once a row by the same chain as a
  gathered slot (one product, then fused multiply-adds in component
  order: the same bits), without touching the table; where ``w`` is a
  multiple of 4 a lane takes four consecutive slots at a time (one
  16-byte column load, two pairs of chains, one 16-byte streaming store),
  else one; 32 warps a block at k <= 16.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .. import sparse

__all__ = ["KERNELS", "launches", "reset_launches", "build", "build_info",
           "h_stats", "h_stats_launch", "w_numer", "beta_err_partials",
           "beta_err_launch", "h_newton_stats", "h_newton_stats_launch",
           "wh_at_nz", "wh_at_nz_launch", "kl_h_stats", "kl_w_numer",
           "kl_w_stats", "kl_beta_err", "kl_h_newton_stats", "kl_wh_at_nz",
           "h_stats_plain", "w_numer_plain", "beta_err_plain",
           "h_newton_stats_plain", "wh_at_nz_plain"]

KERNELS = ("h_stats", "w_numer", "beta_err_partials", "h_newton_stats",
           "wh_at_nz")

# one plain count per kernel: each wrapper adds one where it launches
launches = {name: 0 for name in KERNELS}

# the kernels keep a row's k components in registers (kl_ell.cu builds
# them for k <= 16, 32 and 64)
MAX_K = 64

# filled by build(): seconds, the nvcc command and its -Xptxas -v output
# (kept beside the library, so a process that finds the library built
# still reports it)
build_info: dict = {}

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "kl_ell.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built at first use")
    return found


def build():
    """Compile ``kl_ell.cu`` (once per source content) and load it."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libkl_ell_{digest}.so")
        tmp = f"{so}.{os.getpid()}.tmp"    # concurrent builds never share it
        t0 = time.perf_counter()
        log = ""
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, SOURCE]
        if not os.path.exists(so):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            with open(f"{tmp}.log", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.log", f"{so}.log")
            os.replace(tmp, so)
        elif os.path.exists(f"{so}.log"):
            # built by an earlier process: its -Xptxas -v report
            with open(f"{so}.log") as f:
                log = f.read()
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kl_h_stats.argtypes = [vp, ci, vp, vp, vp, vp] + [ci] * 6 + [vp]
        lib.kl_h_stats_launch.argtypes = [ci] * 6 + [vp]
        lib.kl_w_numer.argtypes = ([vp, ci] + [vp] * 7 + [ci] * 8
                                   + [vp])
        lib.kl_beta_err_partials.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib.kl_beta_err_launch.argtypes = [ci] * 4 + [vp]
        lib.kl_h_newton_stats.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.kl_h_newton_stats_launch.argtypes = [ci] * 4 + [vp]
        lib.kl_wh_at_nz.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.kl_wh_at_nz_launch.argtypes = [ci] * 4 + [vp]
        for fn in (lib.kl_h_stats, lib.kl_h_stats_launch, lib.kl_w_numer,
                   lib.kl_beta_err_partials, lib.kl_beta_err_launch,
                   lib.kl_h_newton_stats, lib.kl_h_newton_stats_launch,
                   lib.kl_wh_at_nz, lib.kl_wh_at_nz_launch):
            fn.restype = ci
        build_info.update(seconds=time.perf_counter() - t0,
                          command=" ".join(cmd), log=log, library=so)
        _lib = lib
        return lib


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(t, name, dtypes, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def _row_checks(vals, cols, H, W, vals_dtypes):
    """Device, dtype, shape and contiguity of a row kernel's inputs;
    ``vals`` is None for the kernels that read the coordinates only."""
    dev = H.device
    R, n, k = H.shape
    g = W.shape[-1]
    w = cols.shape[-1]
    if vals is not None:
        _check(vals, "vals", vals_dtypes, (n, w), dev)
    _check(cols, "cols", (torch.int32,), (n, w), dev)
    _check(H, "H", (torch.float32,), (R, n, k), dev)
    _check(W, "W", (torch.float32,), (R, k, g), dev)
    if k > MAX_K:
        raise ValueError(f"the CUDA ELL kernels take k <= {MAX_K}, got "
                         f"k={k}")
    return R, n, w, k, g


# ---------------------------------------------------------------------------
# plain versions (ops/sparse.py) — what a CPU tensor runs and what the
# kernels are held against on the card
# ---------------------------------------------------------------------------

h_stats_plain = sparse.ell_h_numer
w_numer_plain = sparse.ell_w_numer
beta_err_plain = sparse.ell_beta_err_rows
h_newton_stats_plain = sparse.ell_h_newton
wh_at_nz_plain = sparse.ell_wh_slots


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def h_stats(vals, cols, H, W, bf16: bool = False):
    """``numer (R, n, k)`` f32 of the KL H update. ``vals`` is f32, or bf16
    in bf16 mode (the H solve passes it pre-cast)."""
    ok = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    R, n, w, k, g = _row_checks(vals, cols, H, W, ok)
    if not H.is_cuda:      # the checks put every input on H's device
        return h_stats_plain(vals, cols, H, W, bf16)
    lib = build()
    numer = torch.empty((R, n, k), dtype=torch.float32, device=H.device)
    err = lib.kl_h_stats(_ptr(vals), int(vals.dtype == torch.bfloat16),
                         _ptr(cols), _ptr(H), _ptr(W), _ptr(numer),
                         R, n, w, k, g, int(bool(bf16)), _stream())
    _raise_on(err, "h_stats")
    launches["h_stats"] += 1
    return numer


ROW_LAUNCH = ("threads", "chunks_per_gene", "table_in_smem", "table_bytes",
              "blocks_per_sm", "grid")


def _row_launch(query, name, *args) -> dict:
    out = (ctypes.c_int * len(ROW_LAUNCH))()
    _raise_on(query(*args, out), f"{name} (launch query)")
    return dict(zip(ROW_LAUNCH, out))


def h_stats_launch(R: int, n: int, k: int, g: int, bf16: bool = False,
                   vals_bf16: bool = False) -> dict:
    """How ``h_stats`` launches at these sizes on the current card, without
    launching: threads per block, 16-byte chunks per gene of the packed W
    table, whether the table is staged in shared memory, its bytes, the
    resident blocks per SM at that size and the persistent grid."""
    return _row_launch(build().kl_h_stats_launch, "h_stats", R, n, k, g,
                       int(bool(bf16)), int(bool(vals_bf16)))


def w_numer(vals, cols, rows_t, perm_t, H, W, bf16: bool = False):
    """``numer (R, k, g)`` f32 of the KL W update, ``H^T (X / WH)`` through
    the transpose index set ``rows_t``/``perm_t``. ``vals`` is f32, or bf16
    in bf16 mode. The kernel reads the gene side only; the row side's
    ``cols`` feeds the plain version."""
    if rows_t is None or perm_t is None:
        raise ValueError("no transpose index set (rows_t/perm_t); encode "
                         "with transpose=True")
    ok = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    dev = H.device
    R, n, k = H.shape
    g = W.shape[-1]
    w = vals.shape[-1]
    wt = rows_t.shape[-1]
    _check(vals, "vals", ok, (n, w), dev)
    _check(cols, "cols", (torch.int32,), (n, w), dev)
    _check(rows_t, "rows_t", (torch.int32,), (g, wt), dev)
    _check(perm_t, "perm_t", (torch.int32,), (g, wt), dev)
    _check(H, "H", (torch.float32,), (R, n, k), dev)
    _check(W, "W", (torch.float32,), (R, k, g), dev)
    if k > MAX_K:
        raise ValueError(f"the CUDA ELL kernels take k <= {MAX_K}, got "
                         f"k={k}")
    if not H.is_cuda:
        return w_numer_plain(vals, cols, rows_t, perm_t, H, W, bf16)
    lib = build()
    # scratch: H packed as whole 16-byte chunks a row (8 bf16 or 4 f32
    # components a chunk), and the values in the gene-side layout
    nq = -(-k // (8 if bf16 else 4))
    packed = torch.empty((R * n * nq * 4,), dtype=torch.int32, device=dev)
    vals_t = torch.empty((g, wt), device=dev,
                         dtype=torch.bfloat16 if bf16 else torch.float32)
    numer = torch.empty((R, k, g), dtype=torch.float32, device=dev)
    err = lib.kl_w_numer(_ptr(vals), int(vals.dtype == torch.bfloat16),
                         _ptr(rows_t), _ptr(perm_t), _ptr(H), _ptr(W),
                         _ptr(packed), _ptr(vals_t), _ptr(numer), R, n, w,
                         k, g, wt, nq, int(bool(bf16)), _stream())
    _raise_on(err, "w_numer")
    launches["w_numer"] += 1
    return numer


def beta_err_partials(vals, cols, H, W):
    """The nonzero part of each row's KL term, ``(R, n)`` f32 (f32 inputs
    only, like the TPU kernel); an all-zero row gives exactly +0.0."""
    R, n, w, k, g = _row_checks(vals, cols, H, W, (torch.float32,))
    if not H.is_cuda:
        return beta_err_plain(vals, cols, H, W)
    lib = build()
    partials = torch.empty((R, n), dtype=torch.float32, device=H.device)
    err = lib.kl_beta_err_partials(_ptr(vals), _ptr(cols), _ptr(H), _ptr(W),
                                   _ptr(partials), R, n, w, k, g, _stream())
    _raise_on(err, "beta_err_partials")
    launches["beta_err_partials"] += 1
    return partials


def beta_err_launch(R: int, n: int, k: int, g: int) -> dict:
    """How ``beta_err_partials`` launches at these sizes on the current
    card, without launching (the fields of :func:`h_stats_launch`; its
    packed W table is f32)."""
    return _row_launch(build().kl_beta_err_launch, "beta_err_partials", R,
                       n, k, g)


def h_newton_stats(vals, cols, H, W):
    """``(numer, hess)``, each ``(R, n, k)`` f32, of the DNA H step (f32
    inputs only, like the TPU kernel)."""
    R, n, w, k, g = _row_checks(vals, cols, H, W, (torch.float32,))
    if not H.is_cuda:
        return h_newton_stats_plain(vals, cols, H, W)
    lib = build()
    numer = torch.empty((R, n, k), dtype=torch.float32, device=H.device)
    hess = torch.empty((R, n, k), dtype=torch.float32, device=H.device)
    err = lib.kl_h_newton_stats(_ptr(vals), _ptr(cols), _ptr(H), _ptr(W),
                                _ptr(numer), _ptr(hess), R, n, w, k, g,
                                _stream())
    _raise_on(err, "h_newton_stats")
    launches["h_newton_stats"] += 1
    return numer, hess


def h_newton_stats_launch(R: int, n: int, k: int, g: int) -> dict:
    """How ``h_newton_stats`` launches at these sizes on the current card,
    without launching (the fields of :func:`h_stats_launch`; its packed W
    table is f32)."""
    return _row_launch(build().kl_h_newton_stats_launch, "h_newton_stats",
                       R, n, k, g)


def wh_at_nz_launch(R: int, n: int, k: int, g: int) -> dict:
    """How ``wh_at_nz`` launches at these sizes on the current card, without
    launching (the fields of :func:`h_stats_launch`; its packed W table is
    f32)."""
    return _row_launch(build().kl_wh_at_nz_launch, "wh_at_nz", R, n, k, g)


def wh_at_nz(cols, H, W):
    """``WH`` at every slot of the row side, padded slots included,
    ``(R, n, w)`` f32."""
    R, n, w, k, g = _row_checks(None, cols, H, W, ())
    if not H.is_cuda:
        return wh_at_nz_plain(cols, H, W)
    lib = build()
    out = torch.empty((R, n, w), dtype=torch.float32, device=H.device)
    err = lib.kl_wh_at_nz(_ptr(cols), _ptr(H), _ptr(W), _ptr(out), R, n, w,
                          k, g, _stream())
    _raise_on(err, "wh_at_nz")
    launches["wh_at_nz"] += 1
    return out


# ---------------------------------------------------------------------------
# the statistics the solver calls
# ---------------------------------------------------------------------------

def kl_h_stats(x, H, W, bf16: bool = False):
    """``(numer, denom)`` of the KL H update; ``denom = W.sum(genes)``
    broadcast stays torch."""
    numer = h_stats(x.vals, x.cols, H, W, bf16)
    return numer, W.sum(-1)[:, None, :].expand(H.shape)


def kl_w_numer(x, H, W, bf16: bool = False):
    return w_numer(x.vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)


def kl_w_stats(x, H, W, bf16: bool = False):
    """``(numer, denom)`` of the KL W update; ``denom = H.sum(rows)``
    broadcast stays torch."""
    numer = kl_w_numer(x, H, W, bf16)
    return numer, H.sum(1)[:, :, None].expand(W.shape)


def kl_beta_err(x, H, W):
    """``D_KL(X || HW)`` per replicate ``(R,)`` f32."""
    rows = beta_err_partials(x.vals, x.cols, H, W)
    return rows.sum(1) + sparse.total_wh(H, W)


def kl_h_newton_stats(x, H, W):
    """``(numer, denom, hess)`` of the DNA H step; the ``denom = W.sum(
    genes)`` broadcast of the MU fallback candidate stays torch."""
    numer, hess = h_newton_stats(x.vals, x.cols, H, W)
    return numer, W.sum(-1)[:, None, :].expand(H.shape), hess


def kl_wh_at_nz(x, H, W):
    """``WH`` at the stored coordinates of ``x``, ``(R, n, w)`` f32."""
    return wh_at_nz(x.cols, H, W)
