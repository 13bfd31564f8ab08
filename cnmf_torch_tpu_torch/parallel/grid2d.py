"""The (cells x genes) processor grid with block-wise, overlapped sums —
the MPI-FAUN layout (arXiv 1609.09154).

Port of ``cnmf_torch_tpu/parallel/grid2d.py``. Both data axes shard:

* ``X`` lives as (cells, genes) tiles, each entry of the grid mesh
  (``parallel/mesh.py``) holding an ``(n/c_dim, g/g_dim)`` tile staged by
  :func:`stage_x_grid` one full-width row stripe at a time from a host
  matrix or a shard store.
* ``H`` (cells x k) shards over the cells axis, one copy a tile of its cell
  row; ``W`` (k x genes) shards over the genes axis, one copy a tile of
  its gene column — MPI-FAUN's factor distribution.
* Every update statistic is an axis-local sum: the H-side numerators
  (``X W^T``-shaped) over the genes axis, the W-side statistics (``H^T X``
  (k x g_loc), ``H^T H`` (k x k)) over the cells axis; only the scalar
  objective spans the grid.

The statistics contractions split into ``CNMF_TPU_GRID_BLOCKS`` blocks,
summed in order (:func:`_overlapped_psum`); with ``CNMF_TPU_GRID_OVERLAP=1``
a block's sum is issued on a side stream of the card while the next
block's contraction is issued on the main stream. Both modes add the same
partials in the same order, so their results are the same bits. The
overlap is off by default (the JAX package's is on): on H100s at 700 W
the side stream made a 100,000 x 2,000 grid pass 20-30% slower, on one
card, on four cards of one process and across four processes on NCCL
(``scripts/multicard_check.py``). Solver semantics are the row-sharded
solver's (``parallel/rowshard.py``: block-coordinate passes, tightly
solved usage blocks, the statistics-based W subproblem, the same f32
stopping rule) for plain MU at beta in {2, 1, 0} and the
Diagonalized-Newton KL lane. The
grid stages dense tiles and launches no CUDA kernel (the JAX grid runs no
Pallas kernel); its kernel label is ``dense``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..ops.nmf import (EPS, _apply_rate, _beta_div_dense, _masked_loop,
                       beta_loss_to_float, mu_gamma, random_init,
                       resolve_online_schedule, split_regularization)
from ..utils.shardstore import ShardStore, SlabCursor
from .mesh import Mesh, global_devices, process_count
from .replicates import TRACE_LEN

__all__ = [
    "mesh_grid2d",
    "stage_x_grid",
    "nmf_fit_grid2d",
    "measure_collectives",
    "grid_overlap_enabled",
    "grid_blocks",
    "grid_pass_cost",
    "coll_bytes_per_pass",
    "GridX",
]

GRID_OVERLAP_ENV = "CNMF_TPU_GRID_OVERLAP"
GRID_BLOCKS_ENV = "CNMF_TPU_GRID_BLOCKS"
GRID_SHAPE_ENV = "CNMF_TPU_GRID_SHAPE"


def grid_overlap_enabled() -> bool:
    """``CNMF_TPU_GRID_OVERLAP``: ``1`` issues each statistics block's sum
    on a side stream while the next block's contraction computes; unset
    or ``0`` (the default: the side stream measured slower) sums each
    block before the next is issued — the same bits."""
    from ..utils.envknobs import env_flag

    return env_flag(GRID_OVERLAP_ENV, False)


def grid_blocks(extent: int) -> int:
    """Statistics blocks of the overlap loop, clamped to a divisor of
    ``extent`` (the local rows or columns being blocked). ``0`` (default)
    derives: 4 blocks when the extent affords them, else 1."""
    from ..utils.envknobs import env_int

    want = env_int(GRID_BLOCKS_ENV, 0, lo=0)
    if want <= 0:
        want = 4 if extent >= 64 else 1
    want = max(1, min(int(want), max(int(extent), 1)))
    while want > 1 and extent % want:
        want -= 1
    return want


def _grid_rc(n_dev: int, n_proc: int) -> tuple:
    """Factor the device count into (cell_shards, gene_shards).
    ``CNMF_TPU_GRID_SHAPE=CxG`` pins it. Several processes: the cells axis
    spans processes (gene_shards = devices a process). One process:
    most-square, cells taking the larger factor."""
    from ..utils.envknobs import env_str

    raw = env_str(GRID_SHAPE_ENV, "auto").strip().lower()
    if raw and raw != "auto":
        try:
            c_s, g_s = raw.split("x")
            c, g = int(c_s), int(g_s)
        except ValueError:
            raise ValueError(
                f"{GRID_SHAPE_ENV}={raw!r}: expected 'CxG' (e.g. '4x2') "
                "or 'auto'") from None
        if c < 1 or g < 1 or c * g != n_dev:
            raise ValueError(
                f"{GRID_SHAPE_ENV}={raw!r}: {c}x{g} != {n_dev} devices")
        return c, g
    if n_proc > 1 and n_dev % n_proc == 0:
        return n_proc, n_dev // n_proc
    g = 1
    for cand in range(int(math.isqrt(n_dev)), 0, -1):
        if n_dev % cand == 0:
            g = cand
            break
    return n_dev // g, g


def mesh_grid2d(cell_shards: int | None = None,
                gene_shards: int | None = None, devices=None, owners=None,
                device="cuda") -> Mesh:
    """The (cells, genes) grid over every process's entries
    (``parallel/multihost.py:local_devices`` of each, process 0's first),
    or over ``devices`` (with their ``owners``): with one cell row a
    process, the genes axis and its per-iteration sums stay within one
    process."""
    if devices is None:
        from .multihost import local_devices

        devices, owners = global_devices(local_devices(device))
    devices = list(devices)
    n_dev = len(devices)
    if cell_shards is None and gene_shards is None:
        n_proc = len(set(owners)) if owners is not None else process_count()
        c, g = _grid_rc(n_dev, n_proc)
    else:
        if cell_shards is not None:
            c = int(cell_shards)
            g = n_dev // c if gene_shards is None else int(gene_shards)
        else:
            g = int(gene_shards)
            c = n_dev // g
        if c < 1 or g < 1 or c * g != n_dev:
            raise ValueError(f"grid {c}x{g} does not tile {n_dev} devices")
    arr = np.empty((c, g), dtype=object)
    for i, d in enumerate(devices):
        arr.flat[i] = torch.device(d)
    return Mesh(arr, ("cells", "genes"),
                owners=None if owners is None
                else np.asarray(owners).reshape(c, g))


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

class GridX:
    """A matrix staged on a grid: this process's tiles by entry id
    (``tiles``), the padded shape ``(n, g)``, ``rows_per`` x ``cols_per`` a
    tile, and the mesh."""

    def __init__(self, tiles: dict, mesh: Mesh, n: int, g: int):
        self.tiles = tiles
        self.mesh = mesh
        self.n, self.g = int(n), int(g)
        c_dim, g_dim = mesh.devices.shape
        self.rows_per = self.n // c_dim
        self.cols_per = self.g // g_dim

    @property
    def shape(self):
        return (self.n, self.g)

    def rows(self) -> dict:
        """``{cell row: [entry ids of its local tiles, in gene order]}``."""
        out: dict = {}
        for i in sorted(self.tiles):
            out.setdefault(int(self.mesh.coords(i)[0]), []).append(i)
        return out

    def cols(self) -> dict:
        """``{gene column: [entry ids of its local tiles, in cell
        order]}``."""
        out: dict = {}
        for i in sorted(self.tiles, key=lambda j: self.mesh.coords(j)[::-1]):
            out.setdefault(int(self.mesh.coords(i)[1]), []).append(i)
        return out


def stage_x_grid(X, mesh: Mesh, stats=None, events=None):
    """Stage a host matrix (dense or CSR), a :class:`ShardStore` or a
    :class:`SlabCursor` as (cells, genes) tiles: one full-width row stripe
    at a time (a store reads only the slabs that overlap this process's
    stripes), split into its column tiles on the host and copied to each
    tile's device. Padding is exact zeros (padded rows collapse their
    usages, padded gene columns are masked to zero in W). Returns
    ``(GridX, row_pad, col_pad)``."""
    from ..runtime.faults import maybe_fail

    maybe_fail("upload", context="stage_x_grid")
    c_dim, g_dim = mesh.devices.shape
    if isinstance(X, SlabCursor):
        X = X.store
    n, g = int(X.shape[0]), int(X.shape[1])
    if isinstance(X, ShardStore):
        store = X

        def read_rows(lo, hi):
            return store.row_block(lo, hi, events=events)
    elif sp.issparse(X):
        Xc = X.tocsr()

        def read_rows(lo, hi):
            return Xc[lo:hi]
    else:
        Xn = np.asarray(X)

        def read_rows(lo, hi):
            return Xn[lo:hi]

    n_pad = -(-max(n, 1) // c_dim) * c_dim
    g_pad = -(-max(g, 1) // g_dim) * g_dim
    rows_per, cols_per = n_pad // c_dim, g_pad // g_dim
    t_wall = time.perf_counter()
    stripes: dict = {}
    for i in mesh.local_ids():
        r, c = (int(v) for v in mesh.coords(i))
        stripes.setdefault(r, []).append((i, c))
    tiles: dict = {}
    for r, entries in sorted(stripes.items()):
        t0 = time.perf_counter()
        lo, hi = r * rows_per, min((r + 1) * rows_per, n)
        dense = np.zeros((rows_per, g_pad), np.float32)
        if hi > lo:
            block = read_rows(lo, hi)
            dense[:hi - lo, :g] = (block.toarray() if sp.issparse(block)
                                   else np.asarray(block, np.float32))
        t1 = time.perf_counter()
        for i, c in entries:
            tile = np.ascontiguousarray(dense[:, c * cols_per:
                                              (c + 1) * cols_per])
            tiles[i] = torch.from_numpy(tile).to(
                resolve_device(mesh.device_of(i)))
        if stats is not None:
            stats.add(host_prep_s=t1 - t0, h2d_s=time.perf_counter() - t1,
                      slabs=1, nbytes=rows_per * g_pad * 4)
    if stats is not None:
        stats.wall_s += time.perf_counter() - t_wall
    return GridX(tiles, mesh, n_pad, g_pad), n_pad - n, g_pad - g


# ---------------------------------------------------------------------------
# block-wise, overlapped axis-local sums
# ---------------------------------------------------------------------------

_SIDE: dict = {}


def _side_stream(dev):
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(device=dev)
    return _SIDE[dev]


def _overlapped_psum(fn, nblk: int, psum, overlap: bool):
    """``sum_b psum(fn(b))`` over the statistics blocks, in block order.
    ``fn(b)`` returns a tuple of statistics, each a list of one partial a
    tile of the fiber; ``psum`` sums one such list. With ``overlap`` on a
    card, block ``b``'s sum is issued on a side stream and block
    ``b + 1``'s contraction on the main stream before the side stream is
    joined; off, each sum is complete before the next block is issued.
    Both add the same partials in the same order: the same bits."""
    def reduce(parts):
        return tuple(psum(p) for p in parts)

    prev = fn(0)
    if nblk <= 1:
        return reduce(prev)
    dev = prev[0][0].device
    side = (_side_stream(dev) if overlap and dev.type == "cuda" else None)
    acc = None
    for b in range(1, nblk):
        if side is not None:
            main = torch.cuda.current_stream(dev)
            side.wait_stream(main)
            for parts in prev:
                for t in parts:
                    t.record_stream(side)
            with torch.cuda.stream(side):
                red = reduce(prev)
            nxt = fn(b)
            main.wait_stream(side)
            for t in red:
                t.record_stream(main)
        else:
            red = reduce(prev)
            nxt = fn(b)
        acc = red if acc is None else tuple(a + r for a, r in zip(acc, red))
        prev = nxt
    return tuple(a + r for a, r in zip(acc, reduce(prev)))


# ---------------------------------------------------------------------------
# the pass, one cell row and one gene column at a time
# ---------------------------------------------------------------------------

def _cols(t, b, cb):
    return t[..., b * cb:(b + 1) * cb]


def _h_solve_grid(Xr, h, Wr, psum_g, beta, l1, l2, max_iter, h_tol,
                  kl_newton: bool, nblk: int, overlap: bool):
    """Tightly solve one cell stripe's usage block ``h (1, rows, k)`` with
    W fixed; ``Xr``/``Wr`` are the stripe's local tiles and their gene
    columns' W (each ``(1, k, g_loc)``). The numerator-type statistics sum
    over the genes axis (blocked, overlapped); the iteration and its
    stopping rule are ``ops/nmf.py:_chunk_h_solve``'s."""
    g_loc = int(Wr[0].shape[-1])
    if nblk < 1 or g_loc % nblk:
        raise ValueError(
            f"nblk={nblk} does not divide the local gene extent {g_loc}")
    cb = g_loc // nblk
    devs = [x.device for x in Xr]

    def on(t):
        return [t if t.device == d else t.to(d) for d in devs]

    if beta == 2.0:
        def stats(b):
            Wb = [_cols(w, b, cb) for w in Wr]
            return ([_cols(x, b, cb) @ wb.mT for x, wb in zip(Xr, Wb)],
                    [wb @ wb.mT for wb in Wb])

        numer0, WWT = _overlapped_psum(stats, nblk, psum_g, overlap)
        numer0 = torch.clamp_min(numer0 - l1, 0.0) if l1 else numer0

        def step(hh):
            denom = hh @ WWT
            denom = denom + l2 * hh if l2 else denom
            rate = torch.where(denom < EPS, torch.zeros_like(denom),
                               numer0 / torch.clamp_min(denom, EPS))
            return hh * rate
    elif kl_newton and beta == 1.0:
        s = psum_g([w.sum(-1) for w in Wr])[:, None, :]

        def step(hh):
            hs = on(hh)

            def stats(b):
                out_n, out_h = [], []
                for x, w, hx in zip(Xr, Wr, hs):
                    Wb = _cols(w, b, cb)
                    WHb = torch.clamp_min(hx @ Wb, EPS)
                    ratio = _cols(x, b, cb) / WHb
                    out_n.append(ratio @ Wb.mT)
                    out_h.append((ratio / WHb) @ (Wb * Wb).mT)
                return out_n, out_h

            numer, hess = _overlapped_psum(stats, nblk, psum_g, overlap)
            H_mu = _apply_rate(hh, numer, s.expand(hh.shape), l1, l2)
            grad = s - numer + l1 + l2 * hh
            H_nt = torch.clamp_min(
                hh - grad / torch.clamp_min(hess + l2, EPS), 0.0)
            nts, mus = on(H_nt), on(H_mu)

            def objs(b):
                d_nt, d_mu = [], []
                for x, w, hn, hm in zip(Xr, Wr, nts, mus):
                    Wb, Xb = _cols(w, b, cb), _cols(x, b, cb)
                    d_nt.append(-torch.sum(Xb * torch.log(
                        torch.clamp_min(hn @ Wb, EPS)), dim=-1))
                    d_mu.append(-torch.sum(Xb * torch.log(
                        torch.clamp_min(hm @ Wb, EPS)), dim=-1))
                return d_nt, d_mu

            d_nt, d_mu = _overlapped_psum(objs, nblk, psum_g, overlap)
            sv = s[:, 0, :, None]
            o_nt = (H_nt @ sv)[..., 0] + d_nt
            o_mu = (H_mu @ sv)[..., 0] + d_mu
            if l1:
                o_nt = o_nt + l1 * H_nt.sum(-1)
                o_mu = o_mu + l1 * H_mu.sum(-1)
            if l2:
                o_nt = o_nt + 0.5 * l2 * (H_nt * H_nt).sum(-1)
                o_mu = o_mu + 0.5 * l2 * (H_mu * H_mu).sum(-1)
            return torch.where((o_nt < o_mu)[..., None], H_nt, H_mu)
    else:  # plain MU, beta in {1, 0}
        if beta == 1.0:
            s = psum_g([w.sum(-1) for w in Wr])[:, None, :]

        def step(hh):
            hs = on(hh)
            if beta == 1.0:
                def stats(b):
                    out = []
                    for x, w, hx in zip(Xr, Wr, hs):
                        Wb = _cols(w, b, cb)
                        out.append((_cols(x, b, cb) / torch.clamp_min(
                            hx @ Wb, EPS)) @ Wb.mT)
                    return (out,)

                (numer,) = _overlapped_psum(stats, nblk, psum_g, overlap)
                return _apply_rate(hh, numer, s.expand(hh.shape), l1, l2)

            def stats(b):  # beta == 0.0 (itakura-saito)
                out_n, out_d = [], []
                for x, w, hx in zip(Xr, Wr, hs):
                    Wb = _cols(w, b, cb)
                    WHb = torch.clamp_min(hx @ Wb, EPS)
                    out_n.append((_cols(x, b, cb) / (WHb * WHb)) @ Wb.mT)
                    out_d.append((1.0 / WHb) @ Wb.mT)
                return out_n, out_d

            numer, den = _overlapped_psum(stats, nblk, psum_g, overlap)
            return _apply_rate(hh, numer, den, l1, l2, gamma=mu_gamma(beta))
    return _masked_loop(h, step, max_iter, h_tol, None)


def _rows(t, b, rb):
    return t[..., b * rb:(b + 1) * rb, :]


def _w_stats_grid(Xc, Hc, Wj, psum_c, beta, nblk: int, overlap: bool):
    """One gene column's W-side statistics from its local tiles ``Xc``
    and their cell rows' usages ``Hc``, summed over the cells axis
    (blocked, overlapped): beta=2 ``(A = H^T X, B = H^T H)``, beta=1
    ``(numer, hsum)``, beta=0 ``(numer, denom)``."""
    rows = int(Xc[0].shape[-2])
    if nblk < 1 or rows % nblk:
        raise ValueError(
            f"nblk={nblk} does not divide the local row extent {rows}")
    rb = rows // nblk
    ws = [Wj if Wj.device == x.device else Wj.to(x.device) for x in Xc]
    if beta == 2.0:
        def stats(b):
            hb = [_rows(h, b, rb) for h in Hc]
            return ([h.mT @ _rows(x, b, rb) for x, h in zip(Xc, hb)],
                    [h.mT @ h for h in hb])

        return _overlapped_psum(stats, nblk, psum_c, overlap)
    if beta == 1.0:
        def stats(b):
            out = []
            for x, h, w in zip(Xc, Hc, ws):
                hb = _rows(h, b, rb)
                out.append(hb.mT @ (_rows(x, b, rb)
                                    / torch.clamp_min(hb @ w, EPS)))
            return (out,)

        (numer,) = _overlapped_psum(stats, nblk, psum_c, overlap)
        return numer, psum_c([h.sum(1) for h in Hc])

    def stats(b):  # beta == 0.0 (itakura-saito)
        out_n, out_d = [], []
        for x, h, w in zip(Xc, Hc, ws):
            hb = _rows(h, b, rb)
            WHb = torch.clamp_min(hb @ w, EPS)
            out_n.append(hb.mT @ (_rows(x, b, rb) / (WHb * WHb)))
            out_d.append(hb.mT @ (1.0 / WHb))
        return out_n, out_d

    return _overlapped_psum(stats, nblk, psum_c, overlap)


class _Grid:
    """One grid solve's layout: the tiles, the psums of each fiber, the
    usage stripes by cell row and the W tiles by gene column (each on its
    fiber's first local device)."""

    def __init__(self, gx: GridX, overlap: bool):
        self.gx = gx
        self.mesh = gx.mesh
        self.rows = gx.rows()
        self.cols = gx.cols()
        self.overlap = overlap
        self.nblk_h = grid_blocks(gx.cols_per)
        self.nblk_w = grid_blocks(gx.rows_per)

    def psum_g(self, r):
        ids = self.rows[r]
        return lambda parts: self.mesh.psum(parts, "genes", ids[0])[0]

    def psum_c(self, c):
        ids = self.cols[c]
        return lambda parts: self.mesh.psum(parts, "cells", ids[0])[0]

    def dev(self, i):
        return self.gx.tiles[i].device


def _grid_pass(G: _Grid, H: dict, W: dict, beta, h_tol, chunk_max_iter,
               l1_H, l2_H, l1_W, l2_W, kl_newton: bool):
    """One block-coordinate pass on the grid: every local stripe's tight
    usage solve (genes-axis sums), the global W update (cells-axis sums;
    beta=2 solves the convex subproblem with the stopping rule read on the
    whole W), and the objective of the updated pair (both axes). ``H``:
    ``{cell row: (1, rows, k)}``, ``W``: ``{gene column: (1, k, g_loc)}``.
    Returns ``(H, W, err (1,), A, B)``; ``(A, B)`` the beta=2 statistics
    ``{gene column: (1, k, g_loc)}`` and ``(1, k, k)``, else None."""
    mesh, tiles = G.mesh, G.gx.tiles

    def w_at(c, i):
        w = W[c]
        return w if w.device == G.dev(i) else w.to(G.dev(i))

    def h_at(r, i):
        h = H[r]
        return h if h.device == G.dev(i) else h.to(G.dev(i))

    for r, ids in G.rows.items():
        Wr = [w_at(int(mesh.coords(i)[1]), i) for i in ids]
        H[r] = _h_solve_grid([tiles[i] for i in ids], H[r], Wr, G.psum_g(r),
                             beta, l1_H, l2_H, chunk_max_iter, h_tol,
                             kl_newton, G.nblk_h, G.overlap)
    A = B = None
    stats = {}
    for c, ids in G.cols.items():
        Hc = [h_at(int(mesh.coords(i)[0]), i) for i in ids]
        stats[c] = _w_stats_grid([tiles[i] for i in ids], Hc, W[c],
                                 G.psum_c(c), beta, G.nblk_w, G.overlap)
    if beta == 2.0:
        A = {c: s[0] for c, s in stats.items()}
        B = next(iter(stats.values()))[1]
        W = _solve_w_grid(G, W, A, B, l1_W, l2_W, chunk_max_iter, h_tol)
    else:
        for c, (numer, den) in stats.items():
            if beta == 1.0:
                den = den[:, :, None].expand(W[c].shape)
            W[c] = _apply_rate(W[c], numer, den, l1_W, l2_W,
                               gamma=mu_gamma(beta))
    # the objective: each tile's term, summed over the genes axis of its
    # stripe, then over the cells axis
    e_rows = []
    first_col = None
    for r, ids in G.rows.items():
        terms = [_beta_div_dense(tiles[i], h_at(r, i)
                                 @ w_at(int(mesh.coords(i)[1]), i), beta)
                 for i in ids]
        e_rows.append(G.psum_g(r)(terms))
        first_col = ids[0] if first_col is None else first_col
    err = mesh.psum(e_rows, "cells", first_col)[0]
    return H, W, err, A, B


def _solve_w_grid(G: _Grid, W: dict, A: dict, B, l1_W, l2_W, max_iter,
                  tol):
    """The beta=2 W subproblem on the grid from the summed statistics,
    every gene column stepped together; the stopping rule reads the
    relative change of the whole W (its squared norms summed over the
    genes axis), so every column runs the same trip count."""
    cols = sorted(W)
    if G.mesh.devices.shape[1] == 1:
        # a trivial gene axis: the row-sharded solver's W subproblem
        from ..ops.nmf import _solve_w_from_stats

        return {c: _solve_w_from_stats(W[c], A[c], B, l1_W, l2_W, max_iter,
                                       tol, None) for c in cols}
    r0 = next(iter(G.rows))
    through = G.rows[r0][0]
    Wd = dict(W)
    for _ in range(int(max_iter)):
        new = {c: _apply_rate(Wd[c], A[c], B @ Wd[c], l1_W, l2_W)
               for c in cols}
        d2 = G.mesh.psum([((new[c] - Wd[c]) ** 2).sum().reshape(1)
                          for c in cols], "genes", through)[0]
        n2 = G.mesh.psum([(Wd[c] * Wd[c]).sum().reshape(1) for c in cols],
                         "genes", through)[0]
        Wd = new
        if float(torch.sqrt(d2) / (torch.sqrt(n2) + EPS)) < tol:
            break
    return Wd


# ---------------------------------------------------------------------------
# cost hooks (obs/costmodel.py)
# ---------------------------------------------------------------------------

def _coll_bytes_per_pass(rows_loc, g_loc, k, beta, nblk_h, nblk_w,
                         n_dev) -> int:
    """Logical per-pass sum payload bytes (summed over devices) of the
    pass-level statistics sums — the H-side first iteration plus the
    W-side statistics; KL/IS inner iterations add one H-side round per
    iteration (not counted here)."""
    if beta == 2.0:
        h_side = nblk_h * (rows_loc * k + k * k)
        w_side = nblk_w * (k * g_loc + k * k)
    else:
        h_side = nblk_h * rows_loc * k + k  # first iteration + colsum
        w_side = nblk_w * k * g_loc + k
    return int((h_side + w_side + 1) * 4 * n_dev)


def coll_bytes_per_pass(rows_loc, g_loc, k, beta, nblk_h, nblk_w, n_dev):
    """Public alias of :func:`_coll_bytes_per_pass` for obs/costmodel."""
    return _coll_bytes_per_pass(rows_loc, g_loc, k, beta,
                                nblk_h, nblk_w, n_dev)


def grid_pass_cost(rows_loc: int, g_loc: int, k: int, beta: float = 2.0,
                   *, nblk_h: int = 1, nblk_w: int = 1,
                   n_dev: int = 4) -> dict:
    """Analytic per-device flop and byte cost of one grid pass, the JAX
    package's formula (its byte constants fitted to XLA's buffer
    accounting of the beta=2 pass; the KL/IS pass approximated by its
    dominant terms). ``collective_bytes`` is :func:`_coll_bytes_per_pass`,
    the formula of the ``collective`` event. Host arithmetic only."""
    r, gl, k = int(rows_loc), int(g_loc), int(k)
    if beta == 2.0:
        flops = (
            k * gl + 2 * r * gl * k + 2 * k * gl * k + 2 * (r * k + k * k)
            + 2 * r * k * k + 4 * r * k + 3 * r * k + 4
            + r * k + 2 * r * gl * k + 2 * r * k * k + 2 * (gl * k + k * k)
            + 2 * k * k * gl + 4 * k * gl + 4 * k * gl + 4
            + 2 * r * gl * k + 3 * r * gl + 2)
        bytes_ = (4.0 * (7 * r * gl + 26 * (r * k + k * gl) + 8 * k * k)
                  + 0.75 * (r + gl) + 402.0)
    else:
        flops = (8 * r * gl * k + 6 * r * gl
                 + 4 * r * k * k + 4 * k * k * gl + 7 * (r * k + k * gl))
        bytes_ = 4.0 * (9 * r * gl + 26 * (r * k + k * gl) + 8 * k * k)
    coll = _coll_bytes_per_pass(r, gl, k, float(beta),
                                int(nblk_h), int(nblk_w), int(n_dev))
    return {"flops": float(flops), "bytes": float(bytes_),
            "collective_bytes": float(coll),
            "calibrated": beta == 2.0, "lane": "grid2d"}


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def _grid_inits(gx: GridX, k, seed, g_orig, init_factors):
    """``(H {row}, W {col})`` on each fiber's first local device: the
    random init at the padded matrix's mean (or ``init_factors``), padded
    gene columns of W masked to exact zero."""
    n_pad, g_pad = gx.shape
    mesh = gx.mesh
    rows, cols = gx.rows(), gx.cols()
    if init_factors is not None:
        H0 = np.asarray(init_factors[0], np.float32)
        W0 = np.asarray(init_factors[1], np.float32)
        H0 = np.pad(H0[:n_pad], ((0, max(0, n_pad - H0.shape[0])), (0, 0)))
        W0 = np.pad(W0[:, :g_orig], ((0, 0), (0, g_pad - min(
            W0.shape[1], g_orig))))
        H0, W0 = torch.from_numpy(H0), torch.from_numpy(W0)
    else:
        r0 = next(iter(rows))
        local = mesh.psum([mesh.psum([gx.tiles[i].sum()
                                      for i in rows[r]], "genes",
                                     rows[r][0])[0] for r in rows],
                          "cells", rows[r0][0])[0]
        x_mean = float(local / (n_pad * g_pad))
        H0, W0 = random_init(int(seed) & 0x7FFFFFFF, n_pad, g_pad, int(k),
                             x_mean)
    if g_pad > g_orig:
        W0 = W0 * (torch.arange(g_pad) < g_orig)[None, :]
    H = {r: H0[r * gx.rows_per:(r + 1) * gx.rows_per].to(
        gx.tiles[ids[0]].device)[None].contiguous()
        for r, ids in rows.items()}
    W = {c: W0[:, c * gx.cols_per:(c + 1) * gx.cols_per].to(
        gx.tiles[ids[0]].device)[None].contiguous()
        for c, ids in cols.items()}
    return H, W


def _gather_grid(G: _Grid, H: dict, W: dict):
    """The whole ``H (n_pad, k)`` and ``W (k, g_pad)`` on the host, every
    process's stripes and columns included."""
    parts = G.mesh.gather_all(
        ({r: h[0].cpu().numpy() for r, h in H.items()},
         {c: w[0].cpu().numpy() for c, w in W.items()}))
    Hd, Wd = {}, {}
    for hp, wp in parts:
        Hd.update(hp)
        Wd.update(wp)
    return (np.concatenate([Hd[r] for r in sorted(Hd)]),
            np.concatenate([Wd[c] for c in sorted(Wd)], axis=1))


def nmf_fit_grid2d(X, k: int, mesh: Mesh, beta_loss="frobenius",
                   seed: int = 0, tol: float = 1e-4, h_tol: float = 0.05,
                   n_passes: int | None = None, chunk_max_iter: int = 1000,
                   alpha_W: float = 0.0, l1_ratio_W: float = 0.0,
                   alpha_H: float = 0.0, l1_ratio_H: float = 0.0,
                   n_orig: int | None = None, g_orig: int | None = None,
                   init: str = "random", telemetry_sink=None,
                   checkpoint=None, heartbeat=None, recipe=None,
                   events=None, init_factors=None):
    """Factorize X over the (cells x genes) grid ``mesh``. Returns ``(H
    (n, k), W (k, g), err)`` as numpy arrays and a float — the contract,
    the recipe, checkpoint, heartbeat and ``hostloss`` hooks and the
    telemetry payload of ``parallel/rowshard.py:nmf_fit_rowsharded``
    (mode ``grid2d``).

    ``X``: a host matrix (dense or CSR, staged stripe by stripe), a
    :class:`ShardStore`, or a :class:`GridX` from :func:`stage_x_grid`
    (pass ``n_orig``/``g_orig``). Plain MU at beta in {2, 1, 0} and the
    Diagonalized-Newton KL lane (a pinned ``dna`` recipe); the sketch
    recipe has no grid lane and raises, and the init must be ``random``.
    ``init_factors``: an explicit ``(H0 (n, k), W0 (k, g))`` (the tests
    feed JAX's draws), padded here. ``events`` receives one
    ``collective`` event a solve: its wall and the logical sum bytes of a
    pass (:func:`coll_bytes_per_pass`)."""
    from ..runtime.faults import maybe_hostloss

    beta = beta_loss_to_float(beta_loss)
    _, n_passes, _ = resolve_online_schedule(beta, h_tol, n_passes)
    if beta not in (2.0, 1.0, 0.0):
        raise ValueError(
            f"nmf_fit_grid2d supports beta in {{2, 1, 0}}, got {beta}")
    if init != "random":
        raise ValueError(
            f"nmf_fit_grid2d requires init='random', got {init!r} (the "
            "nndsvd gram base is not sharded over the gene axis)")
    if tuple(mesh.axis_names) != ("cells", "genes"):
        raise ValueError(f"nmf_fit_grid2d needs a ('cells', 'genes') mesh, "
                         f"got axes {mesh.axis_names}")
    c_dim, g_dim = mesh.devices.shape
    if isinstance(X, GridX):
        gx = X
        n_orig = gx.n if n_orig is None else n_orig
        g_orig = gx.g if g_orig is None else g_orig
    else:
        n_orig = int(X.shape[0]) if n_orig is None else n_orig
        g_orig = int(X.shape[1]) if g_orig is None else g_orig
        gx, _, _ = stage_x_grid(X, mesh, events=events)
    n_pad, g_pad = gx.shape
    if recipe is None:
        from ..ops.recipe import resolve_recipe

        recipe = resolve_recipe(beta, "rowshard", algo="mu", ell=False,
                                n=int(n_orig), g=int(g_orig), k=int(k))
    if recipe.kl_newton and beta != 1.0:
        raise ValueError(
            f"recipe {recipe.label!r} requires beta=1 (KL), got "
            f"beta={beta}")
    if recipe.algo == "sketch":
        raise ValueError(
            "the sketch recipe has no (cells x genes) grid lane — run "
            "the 1-D rowshard path, or pin CNMF_TPU_SKETCH=0 for grid2d")
    kl_newton = bool(recipe.kl_newton)
    kernel = "dense"
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    G = _Grid(gx, grid_overlap_enabled())
    H, W = _grid_inits(gx, k, seed, g_orig, init_factors)
    ckpt = (checkpoint if checkpoint is not None
            and getattr(checkpoint, "every", 0) > 0 else None)
    multiproc = mesh.spans_processes
    writer = not multiproc or mesh.rank == min(int(r) for r in
                                               mesh.owners.flat)
    from .rowshard import _PassCursor, _restore_h

    def one_pass(H, W):
        return _grid_pass(G, H, W, beta, float(h_tol), int(chunk_max_iter),
                          l1_H, l2_H, l1_W, l2_W, kl_newton)

    def place(H_np, W_np):
        """Host ``(n_pad, k)``/``(k, g)`` state onto the grid's fibers."""
        W_np = np.asarray(W_np, np.float32)[:, :g_orig]
        W_np = np.pad(W_np, ((0, 0), (0, g_pad - W_np.shape[1])))
        Hn = None if H_np is None else _restore_h(H_np, n_pad)
        return ({r: torch.from_numpy(np.ascontiguousarray(
            Hn[r * gx.rows_per:(r + 1) * gx.rows_per])).to(
                G.dev(ids[0]))[None] for r, ids in G.rows.items()}
                if Hn is not None else None,
                {c: torch.from_numpy(np.ascontiguousarray(
                    W_np[:, c * gx.cols_per:(c + 1) * gx.cols_per])).to(
                        G.dev(ids[0]))[None] for c, ids in G.cols.items()})

    t0 = time.perf_counter()
    cur = _PassCursor(float(tol))
    A = B = None
    state = None
    ran_pass = False
    if ckpt is not None:
        state = (ckpt.load(n_rows_min=int(n_orig), n_genes=int(g_orig))
                 if n_orig is not None else None)
    if state is not None:
        H_r, W = place(state["H"], state["W"])
        resumed_without_h = state["H"] is None
        H = H if H_r is None else H_r
        cur.restore(state)
        A, B = state["A"], state["B"]
    else:
        resumed_without_h = False
        H, W, err0, A, B = one_pass(H, W)
        ran_pass = True
        cur.start(float(err0[0]))

    def save():
        if not writer:
            return
        Hn, Wn = _gather_grid(G, H, W)
        A_np = (None if A is None or isinstance(A, np.ndarray) else
                np.concatenate([A[c][0].cpu().numpy() for c in sorted(A)],
                               axis=1)[:, :g_orig])
        B_np = (None if B is None or isinstance(B, np.ndarray)
                else B[0].cpu().numpy())
        ckpt.save(pass_idx=cur.it, err_prev=cur.err_prev, err=cur.err,
                  trace=cur.trace, W=Wn[:, :g_orig],
                  A=(A_np if A_np is not None
                     else np.zeros((int(k), int(g_orig)), np.float32)),
                  B=(B_np if B_np is not None
                     else np.zeros((int(k), int(k)), np.float32)),
                  H=(Hn if not multiproc and n_pad * int(k) * 4
                     <= ckpt.h_budget else None))

    def boundary():
        obs_metrics.counter_inc("cnmf_rowshard_passes_total")
        if heartbeat is not None:
            heartbeat.beat(phase="pass", cursor=cur.it)
        maybe_hostloss(context="pass")

    if ran_pass and cur.due(ckpt):
        save()
    boundary()
    while cur.active(n_passes, None):
        H, W, err_new, A, B = one_pass(H, W)
        ran_pass = True
        cur.advance(float(err_new[0]))
        if cur.due(ckpt):
            save()
        boundary()
    if resumed_without_h and not ran_pass:
        # a converged checkpoint without H: re-derive the usages from the
        # final W with one fixed-W grid solve
        for r, ids in G.rows.items():
            Wr = [W[int(mesh.coords(i)[1])].to(G.dev(i)) for i in ids]
            H[r] = _h_solve_grid([gx.tiles[i] for i in ids], H[r], Wr,
                                 G.psum_g(r), beta, l1_H, l2_H,
                                 int(chunk_max_iter), float(h_tol),
                                 kl_newton, G.nblk_h, G.overlap)
    H_np, W_np = _gather_grid(G, H, W)
    wall = time.perf_counter() - t0
    err = float(cur.err)
    if telemetry_sink is not None:
        telemetry_sink({
            "k": int(k), "beta": float(beta), "mode": "grid2d",
            "seeds": [int(seed)], "cap": int(n_passes), "cadence": "pass",
            "trace": cur.trace[None], "iters": np.asarray([cur.it]),
            "nonfinite": np.asarray([cur.nonfinite()]),
            "errs": np.asarray([err], np.float64),
            "recipe": recipe.label, "kernel": kernel})
    if events is not None and getattr(events, "enabled", False):
        from .mesh import backend

        events.emit(
            "collective",
            context={"stage": "grid2d_pass_stats", "k": int(k),
                     "beta": float(beta),
                     "mesh_shape": [int(c_dim), int(g_dim)],
                     "blocks": [int(G.nblk_h), int(G.nblk_w)],
                     "overlap": bool(G.overlap), "kernel": kernel,
                     "backend": backend(), "passes": int(cur.it)},
            wall_s=round(wall, 4),
            nbytes=_coll_bytes_per_pass(gx.rows_per, gx.cols_per, int(k),
                                        beta, G.nblk_h, G.nblk_w,
                                        c_dim * g_dim),
            overlap_fraction=None)
    return H_np[:n_orig], W_np[:, :g_orig], err


def measure_collectives(gx: GridX, k: int, beta: float = 2.0,
                        h_tol: float = 0.05, chunk_max_iter: int = 50,
                        seed: int = 0, repeats: int = 11) -> dict:
    """Time the grid's sums on a staged :class:`GridX`: one pass with the
    overlap on and off (the same bits; medians of interleaved samples),
    and the sums alone (each block's statistic summed over its fiber, the
    per-pass payload of :func:`coll_bytes_per_pass`). ``pass_hidden_
    fraction`` is the pass wall the overlap saves over the sums' wall.
    Returns ``{coll_s, pass_overlap_s, pass_serial_s,
    pass_hidden_fraction, blocks, nbytes_per_pass}``."""
    mesh = gx.mesh
    c_dim, g_dim = mesh.devices.shape
    H0, W0 = _grid_inits(gx, k, seed, gx.g, None)

    def sync():
        for t in gx.tiles.values():
            if t.is_cuda:
                torch.cuda.synchronize(t.device)

    def one_pass(overlap):
        G = _Grid(gx, overlap)
        _grid_pass(G, {r: h.clone() for r, h in H0.items()},
                   {c: w.clone() for c, w in W0.items()}, float(beta),
                   float(h_tol), int(chunk_max_iter), 0.0, 0.0, 0.0, 0.0,
                   False)
        sync()

    G = _Grid(gx, True)

    def sums_only():
        for r, ids in G.rows.items():
            for _ in range(G.nblk_h):
                G.psum_g(r)([torch.zeros((1, gx.rows_per, int(k)),
                                         device=G.dev(i)) for i in ids])
        for c, ids in G.cols.items():
            for _ in range(G.nblk_w):
                G.psum_c(c)([torch.zeros((1, int(k), gx.cols_per),
                                         device=G.dev(i)) for i in ids])
        sync()

    def median(fn):
        fn()
        walls = []
        for _ in range(max(int(repeats), 1)):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls))

    t_coll = median(sums_only)
    t_ovl, t_ser = [], []
    one_pass(True)
    one_pass(False)
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        one_pass(False)
        t_ser.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        one_pass(True)
        t_ovl.append(time.perf_counter() - t0)
    t_ser, t_ovl = float(np.median(t_ser)), float(np.median(t_ovl))
    frac = (min(1.0, max(0.0, t_ser - t_ovl) / t_coll) if t_coll > 0
            else 0.0)
    return {"coll_s": round(t_coll, 6), "pass_overlap_s": round(t_ovl, 6),
            "pass_serial_s": round(t_ser, 6),
            "pass_hidden_fraction": round(frac, 4),
            "blocks": [int(G.nblk_h), int(G.nblk_w)],
            "nbytes_per_pass": _coll_bytes_per_pass(
                gx.rows_per, gx.cols_per, int(k), float(beta), G.nblk_h,
                G.nblk_w, c_dim * g_dim)}
