"""Row-sharded NMF over a mesh of cells shards — the atlas path.

Port of ``cnmf_torch_tpu/parallel/rowshard.py``. The cells axis of the
normalized matrix is sharded over a 1-D mesh (``parallel/mesh.py``) and
the small factors stay replicated: H rows live with their X rows (the
usage subproblem needs no communication), and the W subproblem needs only
the k x g / k x k statistics ``A = H^T X`` and ``B = H^T H`` (beta=2), or
the MU numerator and denominator (beta in {1, 0}), summed over the shards
by :meth:`Mesh.psum <cnmf_torch_tpu_torch.parallel.mesh.Mesh.psum>` (the
local shards in order, then ``torch.distributed.all_reduce`` where the
cells axis spans processes). Each shard runs the one-card program on its
rows, as each device runs the per-shard body of the JAX ``shard_map``.
Without a mesh the solve runs on a one-shard mesh on ``device``, whose sum
is the identity: the same bits as a one-card solve.

* Staging: :func:`stream_rows_to_mesh` (dense, through the pipelined
  host-to-card stream of ``parallel/streaming.py``; CSR slabs densify on
  the card; a store streams only the slabs that overlap each shard),
  :func:`stream_ell_to_mesh` (a CSR matrix or store as the dual ELL
  encoding, one global row width and a transpose set per shard at one
  global transpose width; on the card its KL statistics are the CUDA
  kernels of ``csrc/kl_ell.cu``, launched on every shard) and
  :func:`prepare_rowsharded`. On a mesh they return :class:`RowShards`.
* :func:`_rowsharded_pass`: one block-coordinate pass — each shard's usage
  solve with W fixed, then the W update from the summed statistics and the
  objective (a dense pass's elementwise work in row blocks of
  ``DENSE_BLOCK_ELEMS``). On the ELL lane with beta=1 each shard runs
  ``h_stats`` (usage solve), ``w_numer`` (W numerator) and
  ``beta_err_partials`` (objective); a pinned ``dna`` recipe runs
  ``h_newton_stats`` and ``wh_at_nz`` in the usage solve instead.
* :func:`nmf_fit_rowsharded`: the pass loop, one host loop with or
  without pass checkpoints (``runtime/checkpoint.py``; the JAX package's
  fused while_loop and its checkpointed host loop are one loop here, so
  checkpointing on or off gives the same bits), with the heartbeat stamp
  and the ``hostloss`` hook at every pass boundary; a store over the
  per-shard resident budget runs the slab-looped tier
  (:func:`_fit_rowsharded_ooc`). H comes back gathered.
* :func:`fit_h_rowsharded` (fixed-W usage refit) and
  :func:`refit_w_rowsharded` (fixed-H spectra refit without the
  transpose trick) for consensus above the row-shard threshold.

torch's generator cannot reproduce the JAX package's threefry draws, so
the solvers take explicit inits (``init_factors``, ``H0``, ``W0``) that
the parity tests feed; without them they draw from a CPU
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..ops.kernels import kernel_label, kl_ell
from ..ops.nmf import (EPS, _apply_rate, _apply_rate_sketched,
                       _beta_div_dense, _chunk_h_solve, _row_spans,
                       _sketch_rows, _solve_w_from_stats, beta_loss_to_float,
                       mu_gamma, nndsvd_init_gram, random_init,
                       resolve_online_schedule, split_regularization)
from ..ops.sparse import (EllMatrix, _as_clean_csr, _pad_width, csr_to_ell,
                          ell_beta_err, ell_is_w_stats, ell_row_width,
                          resolve_sparse_beta)
from ..utils.shardstore import ShardStore, SlabCursor
from .mesh import Mesh, single_device_mesh
from .replicates import TRACE_LEN
from .streaming import StreamStats, put_arrays, stream_store, stream_to_device

__all__ = ["nmf_fit_rowsharded", "fit_h_rowsharded", "refit_w_rowsharded",
           "pad_rows_to_mesh", "stream_rows_to_mesh", "stream_ell_to_mesh",
           "prepare_rowsharded", "store_dispatch", "dense_pass_bytes",
           "RowShards"]


class RowShards:
    """A matrix staged over the cells axis of a 1-D mesh: this process's
    shards (``parts``, tensors or :class:`EllMatrix`, in shard order), the
    global padded row count ``n``, ``rows_per`` rows a shard and each local
    shard's global first row (``starts``)."""

    def __init__(self, parts, mesh: Mesh, n: int, g: int):
        self.parts = list(parts)
        self.mesh = mesh
        self.n = int(n)
        self.g = int(g)
        self.rows_per = self.n // mesh.size
        self.starts = [p * self.rows_per for p in mesh.local_shards()]

    @property
    def shape(self):
        return (self.n, self.g)

    @property
    def ell(self) -> bool:
        return isinstance(self.parts[0], EllMatrix)

    @property
    def width(self):
        return self.parts[0].width if self.ell else None

    def total_sum(self) -> torch.Tensor:
        """The sum of every stored value, over every shard (the random
        init's mean), on the first local shard's device."""
        sums = [(p.vals.sum() if self.ell else p.sum()) for p in self.parts]
        return self.mesh.psum(sums)[0]


def _psum(parts, mesh=None):
    """Sum one statistic a local shard over the cells axis: the mesh's
    :meth:`~Mesh.psum`, or the one shard as it is without a mesh. Returns
    the sum on the first local shard's device."""
    if mesh is None:
        return parts[0]
    return mesh.psum(parts)[0]


def pad_rows_to_mesh(X, multiple: int):
    """Zero-pad the cells axis of a host matrix to a multiple of
    ``multiple``; returns ``(X, pad)``. A padded row's usage collapses to
    zero in one MU step and adds nothing to the statistics."""
    n = X.shape[0]
    pad = (-n) % int(multiple)
    if pad:
        if sp.issparse(X):
            X = sp.vstack([X.tocsr(),
                           sp.csr_matrix((pad, X.shape[1]), dtype=X.dtype)])
        else:
            X = np.pad(np.asarray(X), ((0, pad), (0, 0)))
    return X, pad


def _cells_mesh(mesh) -> Mesh:
    """The 1-D cells mesh a solve runs on: a mesh as it is (a 2-D mesh's
    local cells fiber), or the one-entry mesh on a device."""
    if isinstance(mesh, Mesh):
        return mesh if len(mesh.axis_names) == 1 else mesh.fiber("cells")
    return single_device_mesh(resolve_device(mesh))


def _shard_bounds(n: int, mesh: Mesh, multiple: int):
    """``(n_pad, rows_per, [(pos, lo, hi, device), ...])`` of this
    process's shards: shard ``pos`` holds global rows ``[pos * rows_per,
    (pos + 1) * rows_per)``, of which ``[lo, hi)`` are data rows."""
    n_shards = mesh.size
    if multiple % n_shards:
        raise ValueError(
            f"pad_multiple={multiple} must be a multiple of the mesh axis "
            f"size {n_shards} so shards stay equal-sized")
    n_pad = n + (-n) % multiple
    rows_per = n_pad // n_shards
    out = []
    for pos, dev in zip(mesh.local_shards(), mesh.local_devices()):
        lo = min(pos * rows_per, n)
        hi = min((pos + 1) * rows_per, n)
        out.append((pos, lo, hi, dev))
    return n_pad, rows_per, out


def stream_rows_to_mesh(X, device, pad_multiple: int | None = None,
                        stats: StreamStats | None = None, events=None):
    """A host matrix (dense or CSR) or a shard store (:class:`ShardStore`
    or :class:`SlabCursor`) as dense f32 on ``device`` through the
    pipelined stream (``parallel/streaming.py``): the dense matrix never
    exists on the host, and a store streams slab by slab from disk, each
    shard only the slabs that overlap its rows. ``device``: a device (one
    tensor, rows zero-padded to ``pad_multiple``, default 1) or a
    :class:`Mesh` (a :class:`RowShards` over its cells axis, rows padded
    to ``pad_multiple``, default the shard count). Returns ``(staged,
    pad)``; the staged values are the same bits whatever the source."""
    from ..runtime.faults import maybe_fail

    maybe_fail("upload", context="stream_rows_to_mesh")
    if not isinstance(device, Mesh):
        multiple = int(pad_multiple) if pad_multiple else 1
        dev = resolve_device(device)
        if isinstance(X, (ShardStore, SlabCursor)):
            cursor = (X if isinstance(X, SlabCursor)
                      else SlabCursor(X, events=events))
            pad = (-cursor.n_rows) % multiple
            return stream_store(cursor, dev, stats=stats, events=events,
                                pad_rows=pad), pad
        pad = (-int(X.shape[0])) % multiple
        return stream_to_device(X, dev, pad_rows=pad, stats=stats,
                                events=events), pad
    mesh = _cells_mesh(device)
    if not isinstance(_stage_target(mesh), Mesh):
        out, pad = stream_rows_to_mesh(X, mesh.device_of(0), pad_multiple,
                                       stats=stats, events=events)
        return _shards_of(out, mesh), pad
    if isinstance(X, SlabCursor):
        X = X.store
    n, g = int(X.shape[0]), int(X.shape[1])
    n_pad, rows_per, bounds = _shard_bounds(
        n, mesh, int(pad_multiple) if pad_multiple else mesh.size)
    parts = []
    for _pos, lo, hi, dev in bounds:
        dev = resolve_device(dev)
        tail = rows_per - (hi - lo)
        if isinstance(X, ShardStore):
            if hi > lo:
                parts.append(stream_store(
                    SlabCursor(X, rows=(lo, hi), events=events), dev,
                    stats=stats, events=events, pad_rows=tail))
            else:
                parts.append(torch.zeros((rows_per, g), dtype=torch.float32,
                                         device=dev))
        else:
            Xc = X.tocsr() if sp.issparse(X) else np.asarray(X)
            parts.append(stream_to_device(Xc[lo:hi], dev, pad_rows=tail,
                                          stats=stats, events=events))
    return RowShards(parts, mesh, n_pad, g), n_pad - n


def _store_rows(store: ShardStore, lo: int, hi: int, events=None):
    """Global rows ``[lo, hi)`` of a CSR store as host CSR, reading only
    the slabs that overlap them; rows past the store are zero."""
    n_data, g = store.shape
    parts = []
    if lo < n_data:
        parts.append(store.row_block(lo, min(hi, n_data), events=events))
    tail = hi - max(lo, n_data)
    if tail > 0:
        parts.append(sp.csr_matrix((tail, g), dtype=np.float32))
    return sp.vstack(parts).tocsr() if len(parts) > 1 else parts[0].tocsr()


def _t_width(blocks, g: int) -> int:
    """The one transpose width of every shard: the most stored values of
    a gene within one shard, over all shards, padded to 8 (at least 8)."""
    t = 8
    for blk in blocks:
        if g and blk.nnz:
            t = max(t, int(np.bincount(blk.indices, minlength=g).max()))
    return -(-t // 8) * 8


def stream_ell_to_mesh(X, device, width: int | None = None,
                       transpose: bool = True,
                       stats: StreamStats | None = None, events=None):
    """A host CSR matrix or a CSR :class:`ShardStore` as the dual ELL
    encoding — the beta != 2 sparse staging: bytes scale with ``rows x
    width``, not ``rows x genes``, and the KL statistics run on the stored
    slots only (the CUDA kernels on a card). ``width`` defaults to the
    max row nnz padded to 8 (the store's manifest gives it without a data
    pass); the transpose index set (``rows_t``, ``perm_t``; the W step's)
    is built unless ``transpose=False`` (a usage-only refit).

    ``device`` a device: one :class:`EllMatrix`, the in-memory matrix's
    encoding whatever the source. A :class:`Mesh`: a :class:`RowShards`
    of one encoding a shard, every shard at the one global row width and
    the one global transpose width (the JAX package's per-shard transpose
    set); a store reads only the slabs that overlap each shard. Returns
    ``(staged, pad)``."""
    t_wall = time.perf_counter()
    if not isinstance(X, ShardStore) and not sp.issparse(X):
        raise TypeError(
            "stream_ell_to_mesh takes a scipy-sparse matrix or a ShardStore")
    if isinstance(X, ShardStore) and X.format != "csr":
        raise TypeError("stream_ell_to_mesh needs a CSR-format store")
    if not isinstance(device, Mesh):
        if isinstance(X, ShardStore):
            w_store = _pad_width(int(X.max_row_nnz) if X.n_rows else 1)
            X = X.row_block(0, X.n_rows, events=events)
            width = w_store if width is None else width
        X = X.tocsr()
        t0 = time.perf_counter()
        ell = csr_to_ell(X, width=width, transpose=transpose)
        t1 = time.perf_counter()
        leaves = [ell.vals, ell.cols] + ([ell.rows_t, ell.perm_t]
                                         if transpose else [])
        out = put_arrays(leaves, resolve_device(device), stats=stats)
        if stats is not None:
            stats.add(host_prep_s=t1 - t0)
            stats.wall_s += time.perf_counter() - t_wall
        return EllMatrix(out[0], out[1], X.shape[1],
                         *(out[2:] if transpose else (None, None))), 0
    mesh = _cells_mesh(device)
    if not isinstance(_stage_target(mesh), Mesh):
        out, pad = stream_ell_to_mesh(X, mesh.device_of(0), width=width,
                                      transpose=transpose, stats=stats,
                                      events=events)
        return _shards_of(out, mesh), pad
    n, g = int(X.shape[0]), int(X.shape[1])
    n_pad, rows_per, bounds = _shard_bounds(n, mesh, mesh.size)
    if isinstance(X, ShardStore):
        store = X

        def take(pos):
            return _as_clean_csr(_store_rows(store, pos * rows_per,
                                             (pos + 1) * rows_per, events))

        if width is None:
            width = _pad_width(int(store.max_row_nnz) if n else 1)
    else:
        Xc, _ = pad_rows_to_mesh(_as_clean_csr(X), mesh.size)

        def take(pos):
            return Xc[pos * rows_per:(pos + 1) * rows_per]

        if width is None:
            width = ell_row_width(Xc)
    # the transpose width is global: every shard is scanned, so every
    # process and every shard encode at one shape
    blocks = {pos: take(pos) for pos in range(mesh.size)}
    t_width = _t_width(blocks.values(), g) if transpose else None
    parts = []
    for pos, _lo, _hi, dev in bounds:
        t0 = time.perf_counter()
        ell = csr_to_ell(blocks[pos], width=int(width), t_width=t_width,
                         transpose=transpose)
        t1 = time.perf_counter()
        leaves = [ell.vals, ell.cols] + ([ell.rows_t, ell.perm_t]
                                         if transpose else [])
        out = put_arrays(leaves, resolve_device(dev), stats=stats)
        if stats is not None:
            stats.add(host_prep_s=t1 - t0)
        parts.append(EllMatrix(out[0], out[1], g,
                               *(out[2:] if transpose else (None, None))))
    if stats is not None:
        stats.wall_s += time.perf_counter() - t_wall
    return RowShards(parts, mesh, n_pad, g), n_pad - n


def prepare_rowsharded(X, device, stats: StreamStats | None = None,
                       events=None):
    """Stage a counts matrix (host or store) once for many row-sharded
    solves: ``(staged, n_orig)`` for :func:`nmf_fit_rowsharded` and
    :func:`fit_h_rowsharded` (``device`` a device or a :class:`Mesh`)."""
    n_orig = int(X.shape[0])
    Xd, _ = stream_rows_to_mesh(X, device, stats=stats, events=events)
    return Xd, n_orig


def _stage_target(mesh: Mesh):
    """What a solve stages onto: the device of a one-entry mesh (one
    tensor or encoding, the one-card staging), else the mesh."""
    return (mesh.device_of(0) if mesh.size == 1 and not mesh.spans_processes
            else mesh)


def _shards_of(X, mesh=None) -> RowShards:
    """A staged matrix as :class:`RowShards`: a tensor or
    :class:`EllMatrix` is the one shard of a one-entry mesh on its
    device."""
    if isinstance(X, RowShards):
        return X
    dev = X.vals.device if isinstance(X, EllMatrix) else X.device
    if mesh is not None and mesh.size != 1:
        raise ValueError("a tensor staged on one device needs a one-entry "
                         "mesh; stage it with stream_rows_to_mesh(X, mesh)")
    mesh = mesh or single_device_mesh(dev)
    return RowShards([X], mesh, _n_rows(X), int(
        X.g if isinstance(X, EllMatrix) else X.shape[1]))


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _n_rows(X) -> int:
    return int(X.vals.shape[0] if isinstance(X, EllMatrix) else X.shape[0])


def _replicate(W, devices):
    """W on each shard's device (the same tensor where it already is)."""
    return [W if W.device == d else W.to(d) for d in devices]


def _rowsharded_pass(Xs, Hs, W, beta, h_tol, chunk_max_iter, l1_H, l2_H,
                     l1_W, l2_W, kl_newton: bool = False, sketch=None,
                     pass_idx: int = 0, mesh=None):
    """One block-coordinate pass over this process's shards ``Xs`` (usages
    ``Hs``, each ``(1, rows, k)``) and the W update from the summed
    statistics; ``W (1, k, g)`` lives on the first shard's device.

    ``kl_newton`` (beta=1, the dna recipe): the usage solve takes
    Diagonalized-Newton steps. ``sketch`` (``(rows, exact_every)``, beta=1,
    the sketch recipe, rows a shard): the usage solve and the objective
    stay exact, the W statistics come from ``rows`` sampled rows of each
    shard (the same local indices on every shard, drawn from
    ``pass_idx``), and every ``exact_every``-th pass (pass 0 too) is exact.

    Returns ``(Hs, W, err (1,), A, B)``; ``(A, B)`` are the pass's summed
    beta=2 statistics (``H^T X``, ``H^T H``), which the checkpoint keeps,
    and ``None`` for beta != 2."""
    A = B = None
    devs = [h.device for h in Hs]
    Ws = _replicate(W, devs)
    ell = isinstance(Xs[0], EllMatrix)
    rows = 0 if ell else _dense_row_block(Xs[0])
    Hs = [_chunk_h_solve(X, H, w, w @ w.mT if beta == 2.0 else None, beta,
                         l1_H, l2_H, chunk_max_iter, h_tol,
                         kl_newton=kl_newton, row_block=rows)
          for X, H, w in zip(Xs, Hs, Ws)]
    if beta == 2.0:
        A = _psum([H.mT @ X for X, H in zip(Xs, Hs)], mesh)
        B = _psum([H.mT @ H for H in Hs], mesh)
        W = _solve_w_from_stats(W, A, B, l1_W, l2_W, chunk_max_iter, h_tol,
                                None)
    elif beta == 1.0 and sketch is not None:
        n_loc = _n_rows(Xs[0])
        m = min(int(sketch[0]), n_loc)
        exact_now = pass_idx % max(int(sketch[1]), 1) == 0
        numer_l, hsum_l = [], []
        for X, H, w in zip(Xs, Hs, Ws):
            if exact_now:
                numer_l.append(kl_ell.kl_w_numer(X, H, w) if ell
                               else _dense_w_stats(X, H, w, beta, rows)[0])
                hsum_l.append(H.sum(1))
                continue
            idx = _sketch_rows(pass_idx, m, n_loc, 2, None, H.device)
            hs = H[:, idx]
            if ell:
                numer_l.append(kl_ell.kl_w_stats_rows(X, H, w, idx)[0])
            else:
                numer_l.append(hs.mT @ (X[idx] / torch.clamp_min(hs @ w,
                                                                 EPS)))
            hsum_l.append(hs.sum(1))
        numer = _psum(numer_l, mesh)
        denom = _psum(hsum_l, mesh)[:, :, None].expand(W.shape)
        # exact passes apply the plain rate (a dead entry decays); a
        # sketched pass holds zero-evidence entries and scales the
        # penalties by the sampled fraction
        if exact_now:
            W = _apply_rate(W, numer, denom, l1_W, l2_W)
        else:
            sc = m / float(n_loc)
            W = _apply_rate_sketched(W, numer, denom, l1_W * sc, l2_W * sc)
        if ell:
            Ws = _replicate(W, devs)
            return Hs, W, _psum([kl_ell.kl_beta_err(X, H, w) for X, H, w
                                 in zip(Xs, Hs, Ws)], mesh), A, B
    elif ell:
        if beta == 1.0:
            numer = _psum([kl_ell.kl_w_numer(X, H, w)
                           for X, H, w in zip(Xs, Hs, Ws)], mesh)
            denom = _psum([H.sum(1) for H in Hs],
                          mesh)[:, :, None].expand(W.shape)
        else:  # beta == 0.0: the IS hybrid, dense WH denominator
            stats = [ell_is_w_stats(X, H, w) for X, H, w in zip(Xs, Hs, Ws)]
            numer = _psum([s[0] for s in stats], mesh)
            denom = _psum([s[1] for s in stats], mesh)
        W = _apply_rate(W, numer, denom, l1_W, l2_W, gamma=mu_gamma(beta))
        Ws = _replicate(W, devs)
        err = [kl_ell.kl_beta_err(X, H, w) if beta == 1.0
               else ell_beta_err(X, H, w, beta)
               for X, H, w in zip(Xs, Hs, Ws)]
        return Hs, W, _psum(err, mesh), A, B
    else:
        stats = [_dense_w_stats(X, H, w, beta, rows)
                 for X, H, w in zip(Xs, Hs, Ws)]
        numer = _psum([s[0] for s in stats], mesh)
        denom = _psum([s[1] for s in stats], mesh)
        if beta == 1.0:
            denom = denom[:, :, None].expand(W.shape)
        W = _apply_rate(W, numer, denom, l1_W, l2_W, gamma=mu_gamma(beta))
    # the cancellation-safe per-element objective of the updated (H, W)
    Ws = _replicate(W, devs)
    err = _psum([_dense_err(X, H, w, beta, rows)
                 for X, H, w in zip(Xs, Hs, Ws)], mesh)
    return Hs, W, err, A, B


# The dense pass's elementwise work runs in row blocks of at most this
# many elements (512 MiB in f32), so a pass holds X plus a fixed scratch
# of block-sized temporaries (WH, the ratio, the objective's terms)
# rather than several X-sized ones; a smaller matrix is one block.
DENSE_BLOCK_ELEMS = 1 << 27
# block-sized temporaries live at the pass's peak (the KL objective's
# terms), for the resident budget of store_dispatch: a 250,000 x 2,000
# KL factorize on an H100 peaked at X and 9.4 blocks
DENSE_SCRATCH_BLOCKS = 10


def _dense_row_block(X) -> int:
    return max(1, DENSE_BLOCK_ELEMS // max(int(X.shape[-1]), 1))


def dense_pass_bytes(n: int, g: int) -> int:
    """Device bytes of a dense pass over an ``n x g`` shard: X and
    ``DENSE_SCRATCH_BLOCKS`` row blocks of f32 temporaries."""
    n, g = max(int(n), 1), max(int(g), 1)
    block = min(n, max(1, DENSE_BLOCK_ELEMS // g)) * g
    return 4 * (n * g + DENSE_SCRATCH_BLOCKS * block)


def _dense_w_stats(X, H, W, beta, rows, with_err: bool = False):
    """The dense MU W statistics of beta in {1, 0} on one shard's rows,
    summed over row blocks in order: ``(numer, denom, err)``; the KL
    ``denom`` is ``H.sum(1)`` (the caller expands it), ``err`` (with
    ``with_err``) the objective of ``(H, W)`` at the same clamped WH."""
    numer = denom = err = None
    for a, b in _row_spans(int(X.shape[-2]), rows):
        Xb, Hb = X[..., a:b, :], H[:, a:b]
        WH = torch.clamp_min(Hb @ W, EPS)
        if beta == 1.0:
            nb, db = Hb.mT @ (Xb / WH), None
        else:
            nb, db = Hb.mT @ (Xb / (WH * WH)), Hb.mT @ (1.0 / WH)
        numer = nb if numer is None else numer + nb
        denom = db if denom is None else denom + db
        if with_err:
            eb = _beta_div_dense(Xb, WH, beta)
            err = eb if err is None else err + eb
    if beta == 1.0:
        denom = H.sum(1)
    return numer, denom, err


def _dense_err(X, H, W, beta, rows):
    """``_beta_div_dense(X, H @ W)`` summed over row blocks in order."""
    err = None
    for a, b in _row_spans(int(X.shape[-2]), rows):
        eb = _beta_div_dense(X[..., a:b, :], H[:, a:b] @ W, beta)
        err = eb if err is None else err + eb
    return err


class _PassCursor:
    """The pass loop's host state: the pass index, the last two
    objectives in f32 and the trace, started by a first pass or restored
    from a checkpoint, and saved to one."""

    def __init__(self, tol: float):
        self.tol = tol
        self.trace = np.full((TRACE_LEN,), np.nan, np.float32)
        self.it = 0
        self.err_prev = self.err = np.float32(np.nan)

    def start(self, err0):
        f32 = np.float32
        self.err = f32(err0)
        self.err_prev = f32(self.err * f32(1.0 + 2.0 * self.tol) + f32(1.0))
        self.it = 1
        self.trace[0] = self.err

    def restore(self, state):
        self.it = int(state["pass_idx"])
        self.err_prev = np.float32(state["err_prev"])
        self.err = np.float32(state["err"])
        n_tr = min(len(state["trace"]), TRACE_LEN)
        self.trace[:n_tr] = state["trace"][:n_tr]

    def advance(self, err_new):
        self.err_prev, self.err = self.err, np.float32(err_new)
        self.it += 1
        self.trace[min(self.it - 1, TRACE_LEN - 1)] = self.err

    def active(self, n_passes: int, sketch) -> bool:
        """The stopping rule, in f32: at least two passes, then on while
        the relative improvement is ``>= tol`` and under the cap; under
        the sketch recipe only an exact pass may stop the loop."""
        f32 = np.float32
        if self.it >= int(n_passes):
            return False
        if self.it < 2:
            return True
        if sketch is not None and (self.it - 1) % max(int(sketch[1]), 1):
            return True
        rel = ((f32(self.err_prev) - f32(self.err))
               / max(f32(self.err_prev), f32(EPS)))
        return bool(rel >= f32(self.tol))

    def due(self, ckpt) -> bool:
        return (ckpt is not None and ckpt.every > 0
                and self.it % ckpt.every == 0 and ckpt.due())

    def save(self, ckpt, W, A, B, H):
        """Persist this pass: W, the statistics (zeros where a beta != 2
        pass has none) and H (``None`` above the checkpoint's budget)."""
        k, g = int(W.shape[-2]), int(W.shape[-1])

        def host(t, shape):
            if t is None:
                return np.zeros(shape, np.float32)
            return (t[0].cpu().numpy() if isinstance(t, torch.Tensor)
                    else np.asarray(t, np.float32))

        ckpt.save(pass_idx=self.it, err_prev=self.err_prev, err=self.err,
                  trace=self.trace, W=W[0].cpu().numpy(), A=host(A, (k, g)),
                  B=host(B, (k, k)), H=H)

    def nonfinite(self) -> bool:
        return not bool(np.isfinite(np.float32(self.err)))


def _restore_h(h_np, n_pad: int):
    """A checkpoint's H trimmed or zero-padded to this solve's rows (its
    rows past the cell count are zero, so a checkpoint of a larger mesh's
    padding re-fits a smaller one)."""
    h_np = np.asarray(h_np, np.float32)
    if h_np.shape[0] > n_pad:
        return h_np[:n_pad]
    if h_np.shape[0] < n_pad:
        return np.pad(h_np, ((0, n_pad - h_np.shape[0]), (0, 0)))
    return h_np


def _split_rows(H_full, shards: RowShards):
    """A global ``(n_pad, k)`` usage matrix (numpy or tensor) as this
    process's shards, each ``(1, rows_per, k)`` on its shard's device."""
    out = []
    for start, part in zip(shards.starts, shards.parts):
        dev = part.vals.device if isinstance(part, EllMatrix) else part.device
        blk = H_full[start:start + shards.rows_per]
        blk = (blk if isinstance(blk, torch.Tensor)
               else torch.tensor(np.asarray(blk, np.float32)))
        out.append(blk.to(dev)[None].contiguous())
    return out


def _gather_rows(Hs, mesh) -> np.ndarray:
    """This process's usage shards, and every other process's along the
    cells axis, as one host ``(n_pad, k)`` matrix in shard order."""
    local = np.concatenate([h[0].cpu().numpy() for h in Hs])
    if mesh is None or not mesh.spans_processes:
        return local
    return np.concatenate(mesh.gather(local))


def _fit_rowsharded_loop(shards, H0, W0, beta, tol, h_tol, n_passes,
                         chunk_max_iter, l1_H, l2_H, l1_W, l2_W, ckpt=None,
                         n_orig=None, kl_newton: bool = False, sketch=None,
                         heartbeat=None):
    """The pass loop: passes of :func:`_rowsharded_pass` until the
    objective's relative improvement drops below ``tol`` or ``n_passes``
    ran, with one host read of the objective a pass. ``H0`` is this
    process's usage shards, ``W0 (1, k, g)``.

    ``ckpt`` (a ``runtime.checkpoint.PassCheckpointer``): every
    ``ckpt.every`` passes W, the pass statistics, the cursor and (under
    the byte budget) H land on disk, and a valid checkpoint resumes the
    loop mid-run, bit for bit when it holds H; without H, H re-derives
    from the restored W. The same loop runs without a checkpointer, so
    the two give the same bits. When the cells axis spans processes only
    the coordinator writes, without H (no gather a pass), and every
    process reads the same file on a resume. At every pass boundary,
    after the checkpoint, ``heartbeat`` stamps the pass cursor and the
    ``hostloss`` hook may raise (the elastic re-mesh's entry).

    Returns ``(Hs, W (1, k, g), err, trace (TRACE_LEN,), passes,
    nonfinite)``."""
    from ..runtime.faults import maybe_hostloss

    mesh = shards.mesh
    Xs = shards.parts
    dev = W0.device
    k, g = int(W0.shape[-2]), int(W0.shape[-1])
    n_pad = shards.n
    multiproc = mesh.spans_processes
    writer = not multiproc or mesh.rank == min(int(r) for r in
                                               mesh.owners.flat)

    def one_pass(Hs, W, pass_idx):
        return _rowsharded_pass(Xs, Hs, W, beta, h_tol, chunk_max_iter,
                                l1_H, l2_H, l1_W, l2_W, kl_newton=kl_newton,
                                sketch=sketch, pass_idx=pass_idx, mesh=mesh)

    cur = _PassCursor(tol)
    ran_pass = False
    state = None
    if ckpt is not None:
        state = (ckpt.load(n_rows_min=int(n_orig), n_genes=g)
                 if n_orig is not None else ckpt.load(n_rows=n_pad,
                                                      n_genes=g))
    if state is not None:
        W = torch.as_tensor(state["W"]).to(dev)[None]
        Hs = (list(H0) if state["H"] is None else
              _split_rows(_restore_h(state["H"], n_pad), shards))
        resumed_without_h = state["H"] is None
        cur.restore(state)
        A, B = state["A"], state["B"]
    else:
        resumed_without_h = False
        Hs, W, err0, A, B = one_pass(list(H0), W0, 0)
        ran_pass = True
        cur.start(float(err0[0]))

    def save():
        if not writer:
            return
        # the H byte budget gates the device-to-host copy itself
        cur.save(ckpt, W, A, B, _gather_rows(Hs, None)
                 if not multiproc and n_pad * k * 4 <= ckpt.h_budget
                 else None)

    def boundary():
        obs_metrics.counter_inc("cnmf_rowshard_passes_total")
        if heartbeat is not None:
            heartbeat.beat(phase="pass", cursor=cur.it)
        maybe_hostloss(context="pass")

    if ran_pass and cur.due(ckpt):
        save()
    boundary()
    while cur.active(n_passes, sketch):
        Hs, W, err_new, A, B = one_pass(Hs, W, cur.it)
        ran_pass = True
        cur.advance(float(err_new[0]))
        if cur.due(ckpt):
            save()
        boundary()
    if resumed_without_h and not ran_pass:
        # a converged checkpoint without H: W is final; the usages come
        # from one fixed-W solve
        Ws = _replicate(W, [h.device for h in Hs])
        Hs = [_chunk_h_solve(X, H, w, w @ w.mT if beta == 2.0 else None,
                             beta, l1_H, l2_H, chunk_max_iter, h_tol,
                             row_block=0 if isinstance(X, EllMatrix)
                             else _dense_row_block(X))
              for X, H, w in zip(Xs, Hs, Ws)]
    return Hs, W, float(cur.err), cur.trace, cur.it, cur.nonfinite()


# ---------------------------------------------------------------------------
# store dispatch and the slab-looped out-of-core tier
# ---------------------------------------------------------------------------

def _staged_refit_budget_bytes(device=None) -> int:
    """Device headroom for a resident shard or a staged refit: 0.6 of the
    card's free memory; a conservative 8 GB on the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free * 0.6)
    return 8 << 30


def _ooc_shard_budget_bytes(device=None) -> int:
    """Resident-shard budget of store-backed solves:
    ``CNMF_TPU_OOC_SHARD_BYTES`` when set, else the device headroom."""
    from ..utils.shardstore import ooc_shard_bytes

    explicit = ooc_shard_bytes()
    if explicit > 0:
        return explicit
    return _staged_refit_budget_bytes(device)


def store_dispatch(store, beta, init: str = "random",
                   force_dense: bool = False, device=None, mesh=None):
    """How a store-backed row-sharded solve ingests: ``(use_ell,
    slab_loop)``. ``use_ell`` is the in-memory dispatch (the manifest's
    density and width stand in for a data pass); ``slab_loop`` is True
    when one shard (``mesh``'s per-shard rows, else the whole store) would
    exceed the shard budget and the dense random-init lane (the only one
    with a slab-looped pass) applies. ``force_dense`` (``cNMF.factorize``,
    which stages dense like its in-memory twin): the budget is sized with
    dense bytes. A dense shard is charged its pass's working set
    (:func:`dense_pass_bytes`)."""
    n = store.n_rows
    n_dev = _cells_mesh(mesh).size if mesh is not None else 1
    rows = max(-(-n // n_dev), 1) if n else 1
    use_ell = False
    w_ell = 0
    if not force_dense and store.format == "csr" and init == "random":
        w_ell = _pad_width(int(store.max_row_nnz) if n else 1)
        use_ell = resolve_sparse_beta(beta, density=store.density,
                                      width=w_ell, g=store.n_genes)
    shard_bytes = (rows * w_ell * 8 if use_ell
                   else dense_pass_bytes(rows, store.n_genes))
    over = shard_bytes > _ooc_shard_budget_bytes(
        _cells_mesh(mesh).local_devices()[0] if mesh is not None else device)
    if over and (use_ell or init != "random"):
        warnings.warn(
            "shard store: the shard (%d bytes) exceeds the resident budget "
            "but the %s lane has no slab-looped pass program — staging "
            "resident anyway"
            % (shard_bytes, "ELL" if use_ell else f"init={init!r}"),
            RuntimeWarning, stacklevel=2)
        over = False
    return use_ell, over and beta in (2.0, 1.0, 0.0)


def _sketch_of(recipe, n_shards: int = 1):
    """The sketch recipe's ``(rows a shard, exact_every)``: the recipe's
    sampled rows shared over the shards, at least one a shard (the JAX
    package's per-shard accounting); ``None`` for the other recipes."""
    if recipe.algo != "sketch":
        return None
    return (max(1, -(-int(recipe.sketch_dim) // max(int(n_shards), 1))),
            int(recipe.sketch_exact_every))


def _ooc_group_pass(Xgs, Hgs, W, beta, h_tol, chunk_max_iter, l1_H, l2_H,
                    kl_newton: bool = False, sketch=None, pass_idx: int = 0,
                    group_idx: int = 0, mesh=None):
    """One slab group's share of a slab-looped pass over this process's
    shards of the group: each shard's usage block solved with W fixed,
    then the group's summed statistics — beta=2 ``(H^T X, H^T H)`` for the
    pass's accumulators, beta in {1, 0} the MU numerator and denominator
    for the caller's per-group W step — and the group's summed objective.
    Returns ``(Hgs, stat_a, stat_b, err)``."""
    devs = [h.device for h in Hgs]
    Ws = _replicate(W, devs)
    rows = _dense_row_block(Xgs[0])
    Hgs = [_chunk_h_solve(Xg, Hg, w, w @ w.mT if beta == 2.0 else None,
                          beta, l1_H, l2_H, chunk_max_iter, h_tol,
                          kl_newton=kl_newton, row_block=rows)
           for Xg, Hg, w in zip(Xgs, Hgs, Ws)]
    if beta == 2.0:
        a = _psum([h.mT @ x for x, h in zip(Xgs, Hgs)], mesh)
        b = _psum([h.mT @ h for h in Hgs], mesh)
        err = _psum([_dense_err(x, h, w, beta, rows)
                     for x, h, w in zip(Xgs, Hgs, Ws)], mesh)
        return Hgs, a, b, err
    numer_l, denom_l, err_l = [], [], []
    for x, h, w in zip(Xgs, Hgs, Ws):
        if (beta == 1.0 and sketch is not None
                and pass_idx % max(int(sketch[1]), 1) != 0):
            # a sketched pass: the shard's ratio whole, its sampled rows'
            # statistics
            WH = torch.clamp_min(h @ w, EPS)
            m = min(int(sketch[0]), int(h.shape[1]))
            idx = _sketch_rows(group_idx, m, int(h.shape[1]), 3, None,
                               h.device)
            hs = h[:, idx]
            numer_l.append(hs.mT @ (x / WH)[:, idx])
            denom_l.append(hs.sum(1))
            err_l.append(_beta_div_dense(x, WH, beta))
        else:
            nb, db, eb = _dense_w_stats(x, h, w, beta, rows, with_err=True)
            numer_l.append(nb)
            denom_l.append(db)
            err_l.append(eb)
    numer, denom = _psum(numer_l, mesh), _psum(denom_l, mesh)
    if beta == 1.0:
        denom = denom[:, :, None].expand(W.shape)
    return Hgs, numer, denom, _psum(err_l, mesh)


def _fit_rowsharded_ooc(store, k, beta, seed, tol, h_tol, n_passes,
                        chunk_max_iter, l1_H, l2_H, l1_W, l2_W, shard_budget,
                        mesh, ckpt=None, kl_newton: bool = False,
                        sketch=None, events=None,
                        stats: StreamStats | None = None,
                        init_factors=None, heartbeat=None):
    """Slab-looped out-of-core solve: X never becomes resident. Each pass
    streams slab groups (resident bytes a shard bounded by
    ``shard_budget``) from the store, each shard reading only its rows of
    the group, solves each group's usage blocks with W fixed and
    accumulates the pass statistics; H stays on the card as one block a
    group and shard. This is the online solver's block-coordinate pass
    with the group as the chunk: beta=2 solves W once a pass from the
    accumulated statistics, beta in {1, 0} takes one MU W step a group. It
    is within solver tolerance of the resident pass, not bit for bit (the
    resident pass solves its usage block jointly). The stopping rule, the
    pass cap, the checkpoint protocol and the pass-boundary hooks are the
    resident loop's.

    Returns ``(H (n_pad, k) np, W (k, g) np, err, trace, passes,
    nonfinite)``."""
    from ..runtime.faults import maybe_hostloss

    n_orig, g = store.shape
    k = int(k)
    n_dev = mesh.size
    per_dev = max(8, int(shard_budget) // max(g * 4, 1))
    per_dev = min(per_dev, max(-(-n_orig // n_dev), 1))
    group_rows = per_dev * n_dev
    n_groups = max(-(-n_orig // group_rows), 1)
    n_pad = n_groups * group_rows
    local = list(zip(mesh.local_shards(),
                     [resolve_device(d) for d in mesh.local_devices()]))
    dev0 = local[0][1]

    def split_h(H_full):
        return [[torch.as_tensor(np.ascontiguousarray(
            H_full[gi * group_rows + pos * per_dev:
                   gi * group_rows + (pos + 1) * per_dev],
            dtype=np.float32)).to(dev)[None] for pos, dev in local]
            for gi in range(n_groups)]

    if init_factors is None:
        # the manifest's f64 value sum stands in for the resident path's
        # on-device mean
        H0_full, W0 = random_init(int(seed), n_pad, g, k,
                                  store.value_sum / max(n_pad * g, 1))
    else:
        H0_full, W0 = (torch.tensor(np.asarray(a, np.float32))
                       for a in init_factors)
    H_groups = split_h(_restore_h(H0_full.numpy(), n_pad))
    del H0_full
    W = W0.to(dev0)[None]

    def stage_group(gi):
        out = []
        for pos, dev in local:
            lo = min(gi * group_rows + pos * per_dev, n_orig)
            hi = min(lo + per_dev, n_orig)
            if hi > lo:
                out.append(stream_store(
                    SlabCursor(store, rows=(lo, hi), events=events), dev,
                    stats=stats, events=events,
                    pad_rows=per_dev - (hi - lo)))
            else:
                out.append(torch.zeros((per_dev, g), dtype=torch.float32,
                                       device=dev))
        return out

    zero_A = torch.zeros((1, k, g), dtype=torch.float32, device=dev0)
    zero_B = torch.zeros((1, k, k), dtype=torch.float32, device=dev0)
    zero_err = torch.zeros((1,), dtype=torch.float32, device=dev0)

    def one_pass(W, pass_i):
        A, B, err_acc = zero_A, zero_B, zero_err
        for gi in range(n_groups):
            Xgs = stage_group(gi)
            Hgs, a, b, err_g = _ooc_group_pass(
                Xgs, H_groups[gi], W, beta, h_tol, chunk_max_iter, l1_H,
                l2_H, kl_newton=kl_newton, sketch=sketch, pass_idx=pass_i,
                group_idx=pass_i * n_groups + gi, mesh=mesh)
            err_acc = err_acc + err_g
            if beta == 2.0:
                A, B = A + a, B + b
            elif (sketch is not None and beta == 1.0
                    and pass_i % max(int(sketch[1]), 1) != 0):
                sc = min(1.0, sketch[0] * n_dev / max(group_rows, 1))
                W = _apply_rate_sketched(W, a, b, l1_W * sc, l2_W * sc)
            else:
                W = _apply_rate(W, a, b, l1_W, l2_W, gamma=mu_gamma(beta))
            del Xgs
            H_groups[gi] = Hgs
            if heartbeat is not None:
                heartbeat.beat(phase="ooc_group", cursor=gi)
        if beta == 2.0:
            W = _solve_w_from_stats(W, A, B, l1_W, l2_W, chunk_max_iter,
                                    h_tol, None)
            return W, float(err_acc[0]), A, B
        return W, float(err_acc[0]), None, None

    def gather_h():
        return np.concatenate([_gather_rows(hg, mesh) for hg in H_groups])

    cur = _PassCursor(tol)
    A = B = None
    ran_pass = False
    state = (ckpt.load(n_rows_min=n_orig, n_genes=g)
             if ckpt is not None and ckpt.every > 0 else None)
    if state is not None:
        W = torch.as_tensor(state["W"]).to(dev0)[None]
        if state["H"] is not None:
            H_groups = split_h(_restore_h(state["H"], n_pad))
        cur.restore(state)
        A, B = state["A"], state["B"]
    else:
        W, err0, A, B = one_pass(W, 0)
        ran_pass = True
        cur.start(err0)

    def save():
        if mesh.spans_processes and mesh.rank != min(mesh.owners.flat):
            return
        cur.save(ckpt, W, A, B, gather_h()
                 if not mesh.spans_processes
                 and n_pad * k * 4 <= ckpt.h_budget else None)

    def boundary():
        obs_metrics.counter_inc("cnmf_rowshard_passes_total")
        if heartbeat is not None:
            heartbeat.beat(phase="pass", cursor=cur.it)
        maybe_hostloss(context="pass")

    if ran_pass and cur.due(ckpt):
        save()
    boundary()
    while cur.active(n_passes, sketch):
        W, err_new, A, B = one_pass(W, cur.it)
        cur.advance(err_new)
        if cur.due(ckpt):
            save()
        boundary()
    return (gather_h(), W[0].cpu().numpy(), float(cur.err), cur.trace,
            cur.it, cur.nonfinite())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _telemetry_payload(k, beta, seed, n_passes, trace, passes, nonfin, err,
                       recipe, kernel, mode="rowshard"):
    return {"k": int(k), "beta": float(beta), "mode": mode,
            "seeds": [int(seed)], "cap": int(n_passes), "cadence": "pass",
            "trace": trace[None], "iters": np.asarray([passes]),
            "nonfinite": np.asarray([nonfin]),
            "errs": np.asarray([err], np.float64),
            "recipe": recipe.label, "kernel": kernel}


def _emit_collectives(events, mesh, before: dict, wall_s: float, k, beta,
                      kernel, passes):
    """The solve's cross-process sums as one ``collective`` event: the
    backend, the ``all_reduce`` count and payload bytes, when the cells
    axis spans processes."""
    from .mesh import backend

    if events is None or not mesh.spans_processes:
        return
    n = mesh.stats["all_reduces"] - before["all_reduces"]
    events.emit(
        "collective",
        context={"stage": "rowshard_pass_stats", "k": int(k),
                 "beta": float(beta), "mesh_shape": [int(mesh.size)],
                 "processes": len(set(int(r) for r in mesh.owners.flat)),
                 "backend": backend(), "all_reduces": int(n),
                 "kernel": kernel, "passes": int(passes)},
        wall_s=round(float(wall_s), 4),
        nbytes=int(mesh.stats["nbytes"] - before["nbytes"]),
        overlap_fraction=None)


def nmf_fit_rowsharded(X, k: int, beta_loss="frobenius", seed: int = 0,
                       tol: float = 1e-4, h_tol: float = 0.05,
                       n_passes: int | None = None,
                       chunk_max_iter: int = 1000, alpha_W: float = 0.0,
                       l1_ratio_W: float = 0.0, alpha_H: float = 0.0,
                       l1_ratio_H: float = 0.0, n_orig: int | None = None,
                       init: str = "random", telemetry_sink=None,
                       checkpoint=None, recipe=None, events=None,
                       store_slab_loop: bool = False, init_factors=None,
                       device="cuda", mesh=None, heartbeat=None):
    """Factorize a cells-sharded X. Returns ``(H (n, k), W (k, g), err)``
    as numpy arrays and a float; H gathered over every shard.

    ``mesh``: a 1-D :class:`Mesh` (or a 2-D one's local cells fiber) whose
    shards split the rows; default the one-entry mesh on ``device``.
    ``X``: a host matrix (dense or CSR, staged through the stream), a
    :class:`RowShards` (or a tensor or :class:`EllMatrix` on one device)
    already staged by :func:`prepare_rowsharded` /
    :func:`stream_ell_to_mesh` (pass its ``n_orig``), or a
    :class:`ShardStore`. A CSR matrix or store with beta in {1, 0} under
    the ELL rule (and the random init) stages as ELL, and its KL
    statistics are the CUDA kernels on the card, on every shard. A store
    under the per-shard resident budget stages resident (bit for bit the
    in-memory staging); over it, the dense random-init solve runs the
    slab-looped tier (``store_slab_loop`` forces that tier: the caller
    sized the decision).

    ``init_factors``: an explicit ``(H0 (n_pad, k), W0 (k, g))`` (rows
    past ``n_pad`` are trimmed, missing ones zero), else the init of
    ``init`` from ``seed`` (``random``: ``ops/nmf.py:random_init`` at the
    mean of the padded matrix; the nndsvd family from the gram,
    ``ops/nmf.py:nndsvd_init_gram``, one process only). ``checkpoint``: a
    ``runtime.checkpoint.PassCheckpointer`` (see
    :func:`_fit_rowsharded_loop`); ``heartbeat``: a
    ``runtime.elastic.Heartbeat`` stamped every pass. ``recipe``: the
    resolved ``SolverRecipe`` (``dna`` threads Newton usage steps into the
    pass, ``sketch`` the sampled W statistics), else resolved from the
    knobs for ``rowshard``. ``events`` receives the staging of a host
    matrix or store as the ``rowshard_staging`` stream, the slab-looped
    tier's as ``rowshard_ooc_passes``, and, where the cells axis spans
    processes, the solve's sums as one ``collective`` event.
    ``telemetry_sink`` receives the solve's convergence record
    (per-pass objectives, passes, the nonfinite flag; the JAX package's
    payload keys).

    The pass schedule is the online solver's (``resolve_online_schedule``),
    so crossing the row-shard threshold keeps the convergence schedule."""
    beta = beta_loss_to_float(beta_loss)
    _, n_passes, _ = resolve_online_schedule(beta, h_tol, n_passes)
    if beta not in (2.0, 1.0, 0.0):
        raise ValueError(
            f"nmf_fit_rowsharded supports beta in {{2, 1, 0}}, got {beta}")
    if isinstance(X, RowShards):
        mesh = X.mesh
    elif isinstance(X, (torch.Tensor, EllMatrix)):
        mesh = None
    else:
        mesh = _cells_mesh(device if mesh is None else mesh)
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    ooc_deep = False
    stats = StreamStats()
    # a one-entry mesh stages as one tensor or encoding on its device
    target = _stage_target(mesh) if mesh is not None else None
    if isinstance(X, (torch.Tensor, EllMatrix, RowShards)):
        shards = _shards_of(X)
        if n_orig is None:
            n_orig = shards.n
    elif isinstance(X, ShardStore):
        store = X
        n_orig = store.n_rows
        if store_slab_loop:
            use_ell, ooc_deep = False, True
        else:
            use_ell, ooc_deep = store_dispatch(store, beta, init=init,
                                               mesh=mesh)
        if ooc_deep:
            shards = None
        elif use_ell:
            shards, _ = stream_ell_to_mesh(store, target, stats=stats,
                                           events=events)
        else:
            shards, _ = stream_rows_to_mesh(store, target, stats=stats,
                                            events=events)
    else:
        n_orig = int(X.shape[0])
        if (sp.issparse(X) and init == "random" and resolve_sparse_beta(
                beta, density=X.nnz / max(X.shape[0] * X.shape[1], 1),
                width=ell_row_width(X), g=X.shape[1])):
            shards, _ = stream_ell_to_mesh(X, target, stats=stats,
                                           events=events)
        else:
            shards, _ = stream_rows_to_mesh(X, target, stats=stats,
                                            events=events)
    if shards is not None:
        shards = _shards_of(shards, mesh)
    if events is not None and not ooc_deep and stats.nbytes:
        events.emit_stream("rowshard_staging", stats)
    mesh = shards.mesh if shards is not None else mesh
    ell = shards is not None and shards.ell
    if recipe is None:
        from ..ops.recipe import resolve_recipe

        n, g = X.shape if ooc_deep else shards.shape
        recipe = resolve_recipe(beta, "rowshard", ell=ell, n=int(n), g=int(g),
                                k=int(k),
                                ell_width=shards.width if ell else None)
    if (recipe.kl_newton or recipe.algo == "sketch") and beta != 1.0:
        raise ValueError(
            f"recipe {recipe.label!r} requires beta=1 (KL), got "
            f"beta={beta}")
    sketch = _sketch_of(recipe, mesh.size)
    ckpt = (checkpoint if checkpoint is not None
            and getattr(checkpoint, "every", 0) > 0 else None)
    dev = resolve_device(mesh.local_devices()[0])
    before = dict(mesh.stats)
    t0 = time.perf_counter()
    if ooc_deep:
        H, W, err, trace, passes, nonfin = _fit_rowsharded_ooc(
            X, int(k), beta, int(seed), float(tol), float(h_tol),
            int(n_passes), int(chunk_max_iter), l1_H, l2_H, l1_W, l2_W,
            _ooc_shard_budget_bytes(dev), mesh, ckpt=ckpt,
            kl_newton=bool(recipe.kl_newton), sketch=sketch, events=events,
            stats=stats, init_factors=init_factors, heartbeat=heartbeat)
        if events is not None:
            events.emit_stream("rowshard_ooc_passes", stats)
        _emit_collectives(events, mesh, before, time.perf_counter() - t0,
                          k, beta, "dense", passes)
        if telemetry_sink is not None:
            telemetry_sink(_telemetry_payload(
                k, beta, seed, n_passes, trace, passes, nonfin, err, recipe,
                "dense", mode="rowshard-ooc"))
        return H[:n_orig], W, float(err)

    n, g = shards.shape
    if init_factors is not None:
        H0 = _split_rows(_restore_h(init_factors[0], n), shards)
        W0 = torch.as_tensor(np.array(init_factors[1], np.float32)).to(dev)
    elif init == "random":
        # the ELL mean counts the implicit zeros
        x_mean = float(shards.total_sum() / (n * g))
        H0, W0 = random_init(int(seed) & 0x7FFFFFFF, n, g, int(k), x_mean,
                             device=dev)
        H0 = _split_rows(H0, shards)
    elif ell:
        raise ValueError(
            f"ELL-encoded rowshard solves require init='random', "
            f"got {init!r} (the nndsvd gram base needs the dense matrix)")
    elif init in ("nndsvd", "nndsvda", "nndsvdar"):
        if mesh.spans_processes:
            raise ValueError("the row-sharded nndsvd init runs in one "
                             "process; use init='random' across processes")
        variant = "nndsvdar" if init == "nndsvd" else init
        Xcat = (shards.parts[0] if len(shards.parts) == 1 else
                torch.cat([p.to(dev) for p in shards.parts]))
        H0, W0 = nndsvd_init_gram(Xcat, int(k), variant,
                                  seed=int(seed) & 0x7FFFFFFF)
        del Xcat
        H0 = _split_rows(H0, shards)
    else:
        raise ValueError(f"unknown init {init!r}")
    Hs, W, err, trace, passes, nonfin = _fit_rowsharded_loop(
        shards, H0, W0[None].contiguous(), beta, float(tol), float(h_tol),
        int(n_passes), int(chunk_max_iter), l1_H, l2_H, l1_W, l2_W,
        ckpt=ckpt, n_orig=n_orig if ckpt is not None else None,
        kl_newton=bool(recipe.kl_newton), sketch=sketch,
        heartbeat=heartbeat)
    kernel = kernel_label(ell, dev, False, beta)
    _emit_collectives(events, mesh, before, time.perf_counter() - t0, k,
                      beta, kernel, passes)
    if telemetry_sink is not None:
        telemetry_sink(_telemetry_payload(
            k, beta, seed, n_passes, trace, passes, nonfin, err, recipe,
            kernel))
    return _gather_rows(Hs, mesh)[:n_orig], W[0].cpu().numpy(), float(err)


def fit_h_rowsharded(X, W, h_tol: float = 0.05, chunk_max_iter: int = 200,
                     l1_reg_H: float = 0.0, l2_reg_H: float = 0.0, beta=2.0,
                     seed: int = 0, n_orig: int | None = None, H0=None,
                     device="cuda", events=None, mesh=None) -> np.ndarray:
    """Row-sharded fixed-W usage refit (no communication: W is
    replicated and every H row depends on its own X row), each shard
    solved as one block. ``X``: a host matrix (a CSR one under the ELL
    rule stages as ELL without the transpose set, and its KL statistics
    are the ``h_stats`` kernel on the card, on every shard), a staged
    :class:`RowShards`, tensor or :class:`EllMatrix`, or a
    :class:`ShardStore`; ``mesh`` as in :func:`nmf_fit_rowsharded`.
    ``H0``: an explicit init, else ``uniform(0, 1)`` from ``seed``.
    Returns numpy ``(n, k)``, gathered over every shard."""
    from ..ops.nmf import fit_h_default_init

    beta = beta_loss_to_float(beta)
    if isinstance(X, (torch.Tensor, EllMatrix, RowShards)):
        shards = _shards_of(X)
        if n_orig is None:
            n_orig = shards.n
    else:
        mesh = _cells_mesh(device if mesh is None else mesh)
        target = _stage_target(mesh)
        n_orig = int(X.shape[0])
        if isinstance(X, ShardStore):
            use_ell = X.format == "csr" and resolve_sparse_beta(
                beta, density=X.density,
                width=_pad_width(int(X.max_row_nnz) if n_orig else 1),
                g=X.n_genes)
        else:
            use_ell = sp.issparse(X) and resolve_sparse_beta(
                beta, density=X.nnz / max(X.shape[0] * X.shape[1], 1),
                width=ell_row_width(X), g=X.shape[1])
        if use_ell:
            shards, _ = stream_ell_to_mesh(X, target, transpose=False,
                                           events=events)
        else:
            shards, _ = stream_rows_to_mesh(X, target, events=events)
        shards = _shards_of(shards, mesh)
    dev = resolve_device(shards.mesh.local_devices()[0])
    Wt = torch.as_tensor(np.ascontiguousarray(W, dtype=np.float32)).to(dev)
    k = int(Wt.shape[0])
    n = shards.n
    if H0 is None:
        H = fit_h_default_init(n, k, seed=int(seed), device=dev)
    else:
        H = torch.tensor(_restore_h(H0, n)).to(dev)
    Hs = _split_rows(H, shards)
    W1s = _replicate(Wt[None], [h.device for h in Hs])
    Hs = [_chunk_h_solve(X, h, w, w @ w.mT if beta == 2.0 else None, beta,
                         float(l1_reg_H), float(l2_reg_H),
                         int(chunk_max_iter), float(h_tol),
                         row_block=0 if isinstance(X, EllMatrix)
                         else _dense_row_block(X))
          for X, h, w in zip(shards.parts, Hs, W1s)]
    return _gather_rows(Hs, shards.mesh)[:n_orig]


def refit_w_rowsharded(X, H, beta=2.0, h_tol: float = 0.05,
                       max_iter: int = 200, l1_reg_W: float = 0.0,
                       l2_reg_W: float = 0.0, seed: int = 0,
                       row_block: int = 100_000, stage: bool | str = "auto",
                       stage_budget_bytes: int | None = None, W0=None,
                       device="cuda", mesh=None) -> np.ndarray:
    """Fixed-usage spectra refit at atlas scale without the transpose
    trick (whose row chunks would be ``chunk x cells`` dense buffers).

    * beta=2: the MU fixed point depends on X only through ``A = H^T X``
      (one sparse host product) and ``B = H^T H``; the MU iterations run
      on the card on k-sized arrays.
    * beta in {1, 0}: each MU step needs WH per row. When one shard of the
      dense matrix fits the card's headroom (``stage='auto'``) it is
      staged once over ``mesh``'s shards (default one on ``device``) and
      every iteration loops over row blocks of every shard, the
      statistics summed over the shards; above it, host blocks of
      ``row_block`` rows stream every iteration to ``device``.

    The stopping rule is :func:`fit_h`'s (relative change of W below
    ``h_tol``, ``max_iter`` cap). ``W0``: an explicit init, else
    ``uniform(0, 1)`` from ``seed``. Returns numpy ``W (k, g)``."""
    target = _cells_mesh(device if mesh is None else mesh)
    dev = resolve_device(target.local_devices()[0])
    beta = beta_loss_to_float(beta)
    if beta not in (2.0, 1.0, 0.0):
        raise ValueError(
            f"refit_w_rowsharded supports beta in {{2, 1, 0}}, got {beta}")
    H = np.asarray(H, dtype=np.float32)
    n, k = H.shape
    g = int(X.shape[1])
    if W0 is None:
        gen = torch.Generator().manual_seed(int(seed))
        W = torch.rand((k, g), generator=gen, dtype=torch.float32)
    else:
        W = torch.as_tensor(np.array(W0, np.float32))
    W = W.to(dev)[None]
    l1, l2 = float(l1_reg_W), float(l2_reg_W)

    if beta == 2.0:
        if sp.issparse(X):
            A = np.asarray((X.T @ H).T, dtype=np.float32)
        else:
            A = H.T @ np.asarray(X, dtype=np.float32)
        A = torch.as_tensor(np.ascontiguousarray(A)).to(dev)[None]
        B = torch.as_tensor(H.T @ H).to(dev)[None]
        W = _solve_w_from_stats(W, A, B, l1, l2, int(max_iter),
                                float(h_tol), None)
        return W[0].cpu().numpy()

    if isinstance(stage, str) and stage != "auto":
        raise ValueError(f"stage must be True, False, or 'auto'; got {stage!r}")
    if stage == "auto":
        budget = (stage_budget_bytes if stage_budget_bytes is not None
                  else _staged_refit_budget_bytes(dev))
        stage = -(-n // target.size) * g * 4 <= budget

    def mu_step(W, numer, denom):
        W_new = _apply_rate(W, numer, denom, l1, l2, gamma=mu_gamma(beta))
        rel = float(torch.linalg.vector_norm(W_new - W)
                    / (torch.linalg.vector_norm(W) + EPS))
        return W_new, rel

    def block_stats(x, h, W):
        WH = torch.clamp_min(h @ W, EPS)
        if beta == 1.0:
            return h.mT @ (x / WH), None
        return h.mT @ (x / (WH * WH)), h.mT @ (1.0 / WH)

    if stage:
        # row blocks bound the WH intermediate to ~512 MB
        blk = int(min(max(256, DENSE_BLOCK_ELEMS // max(g, 1)), row_block,
                      max(-(-n // target.size), 8)))
        shards, pad = stream_rows_to_mesh(X, target,
                                          pad_multiple=blk * target.size)
        Hs = _split_rows(np.pad(H, ((0, pad), (0, 0))), shards)
        blocks = [(b, b + blk) for b in range(0, shards.rows_per, blk)]
        # the KL denominator is loop-invariant
        kl_denom = _psum([h.sum(1) for h in Hs],
                         target)[:, :, None].expand(W.shape)
        for _ in range(int(max_iter)):
            Ws = _replicate(W, [h.device for h in Hs])
            numer_l, denom_l = [], []
            for x, h, w in zip(shards.parts, Hs, Ws):
                numer = torch.zeros_like(w)
                denom = torch.zeros_like(w) if beta == 0.0 else None
                for lo, hi in blocks:
                    nb, db = block_stats(x[lo:hi], h[:, lo:hi], w)
                    numer = numer + nb
                    if beta == 0.0:
                        denom = denom + db
                numer_l.append(numer)
                denom_l.append(denom)
            numer = _psum(numer_l, target)
            denom = (_psum(denom_l, target) if beta == 0.0 else kl_denom)
            W, rel = mu_step(W, numer, denom)
            if rel < h_tol:
                break
        return W[0].cpu().numpy()

    Xc = X.tocsr() if sp.issparse(X) else np.asarray(X)
    Hd = torch.as_tensor(H).to(dev)[None]
    kl_denom = Hd.sum(1)[:, :, None].expand(W.shape)
    for _ in range(int(max_iter)):
        numer = torch.zeros_like(W)
        denom = torch.zeros_like(W) if beta == 0.0 else kl_denom
        for lo in range(0, n, row_block):
            hi = min(lo + row_block, n)
            x = stream_to_device(Xc[lo:hi], dev)
            nb, db = block_stats(x, Hd[:, lo:hi], W)
            numer = numer + nb
            if beta == 0.0:
                denom = denom + db
        W, rel = mu_step(W, numer, denom)
        if rel < h_tol:
            break
    return W[0].cpu().numpy()
