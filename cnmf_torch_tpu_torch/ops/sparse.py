"""Fixed-width dual-ELL encoding and the plain torch KL (beta=1) and
Itakura-Saito (beta=0) statistics.

Port of ``cnmf_torch_tpu/ops/sparse.py``. The encoding is built on the host
in numpy exactly as the JAX package builds it (so the two encodings are
equal array for array) and staged with one ``.to(device)`` per leaf.

Row side: ``vals (..., n, w)`` and ``cols (..., n, w)``, padded with value 0
at column 0. Transpose side: ``rows_t (..., g, wt)`` (row of each stored
entry of a gene) and ``perm_t (..., g, wt)`` (its flat ``row * w + slot``
position in ``vals``), padding pointing at the sentinel ``n * w`` — one
past the end of the flat ratio buffer, whose appended slot is 0. Every
padded slot therefore adds an exact +0.0 to every statistic.

The statistics here are the PLAIN versions of the CUDA kernels in
``ops/kernels/kl_ell.py``: the kernels are held against them on the card,
and every CPU tensor takes them. They are batched over replicates: ``H``
is ``(R, n, k)``, ``W`` is ``(R, k, g)`` and the encoding is shared by all
``R`` lanes. With ``bf16`` the operands and the ratio chain round to
bfloat16 at the same places as the JAX bf16 chain, and every numerator
product is rounded to bf16 before an f32 sum.

The Itakura-Saito statistics (:func:`ell_is_h_stats`,
:func:`ell_is_w_stats`, :func:`ell_beta_err` at beta=0) are the JAX
package's hybrid form: their denominators and objective are supported on
every entry, so ``WH`` is one dense ``(R, n, g)`` matmul, and only the
numerators gather at the stored slots. They are plain torch on every
device (the JAX package ran them without Pallas too).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.envknobs import env_str

__all__ = ["EPS", "SPARSE_DENSITY_THRESHOLD", "EllMatrix", "csr_to_ell",
           "ell_chunk_rows", "ell_row_width", "resolve_sparse_beta",
           "kl_nz_term", "ell_h_numer", "ell_ratio_flat",
           "ell_w_numer_from_ratio", "ell_w_numer", "ell_kl_h_stats",
           "ell_kl_w_numer", "ell_kl_w_stats", "ell_beta_err",
           "ell_beta_err_nz", "ell_beta_err_rows", "total_wh",
           "ell_wh_slots", "ell_wh_at_nz", "ell_h_newton",
           "ell_kl_h_newton_stats", "is_per_elem", "ell_is_h_stats",
           "ell_is_w_stats", "ell_take_rows", "ell_kl_w_stats_rows"]

EPS = 1e-16
# auto-dispatch ceiling: <= 10% nonzeros and row width <= g/8
# (ops/sparse.py:resolve_sparse_beta in the JAX package)
SPARSE_DENSITY_THRESHOLD = 0.10
_WIDTH_MULTIPLE = 8


@dataclass
class EllMatrix:
    """Dual fixed-width ELL matrix (numpy or torch leaves). ``rows_t`` and
    ``perm_t`` are ``None`` for H-only uses (``fit_h``)."""

    vals: object
    cols: object
    g: int
    rows_t: object = None
    perm_t: object = None

    @property
    def shape(self):
        return tuple(self.vals.shape[:-1]) + (int(self.g),)

    @property
    def width(self) -> int:
        return int(self.vals.shape[-1])

    @property
    def t_width(self):
        return None if self.rows_t is None else int(self.rows_t.shape[-1])

    def to(self, device) -> "EllMatrix":
        """Stage every leaf (vals f32, index leaves int32)."""
        def put(a, dt):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=dt).contiguous()
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        return EllMatrix(put(self.vals, torch.float32),
                         put(self.cols, torch.int32), self.g,
                         put(self.rows_t, torch.int32),
                         put(self.perm_t, torch.int32))

    def chunk(self, c: int) -> "EllMatrix":
        """Chunk ``c`` of a pre-chunked encoding (leading chunk axis)."""
        return EllMatrix(self.vals[c], self.cols[c], self.g,
                         None if self.rows_t is None else self.rows_t[c],
                         None if self.perm_t is None else self.perm_t[c])

    def with_vals(self, vals) -> "EllMatrix":
        return EllMatrix(vals, self.cols, self.g, self.rows_t, self.perm_t)


def _pad_width(w: int) -> int:
    return max(_WIDTH_MULTIPLE, -(-max(w, 1) // _WIDTH_MULTIPLE)
               * _WIDTH_MULTIPLE)


def ell_row_width(X) -> int:
    """Max row nnz padded to a multiple of 8 (dense inputs count
    nonzeros)."""
    if sp.issparse(X):
        if sp.isspmatrix_csr(X):
            nnz_per_row = np.diff(X.indptr)
        else:
            nnz_per_row = np.asarray(X.getnnz(axis=1)).reshape(-1)
    else:
        nnz_per_row = np.count_nonzero(np.asarray(X), axis=1)
    return _pad_width(int(nnz_per_row.max()) if nnz_per_row.size else 1)


def _row_ell_buffers(Xc: sp.csr_matrix, width: int, dtype):
    n, _ = Xc.shape
    row_nnz = np.diff(Xc.indptr)
    vals = np.zeros((n, int(width)), dtype=dtype)
    cols = np.zeros((n, int(width)), dtype=np.int32)
    if Xc.nnz:
        rows = np.repeat(np.arange(n), row_nnz)
        pos = np.arange(Xc.nnz) - np.repeat(Xc.indptr[:-1], row_nnz)
        vals[rows, pos] = Xc.data
        cols[rows, pos] = Xc.indices
    return vals, cols


def _transpose_buffers(Xc: sp.csr_matrix, width: int, t_width: int):
    n, g = Xc.shape
    row_nnz = np.diff(Xc.indptr)
    rows_t = np.zeros((g, int(t_width)), np.int32)
    perm_t = np.full((g, int(t_width)), n * int(width), np.int32)
    if Xc.nnz:
        pos_in_row = np.arange(Xc.nnz) - np.repeat(Xc.indptr[:-1], row_nnz)
        flatpos = np.repeat(np.arange(n), row_nnz) * int(width) + pos_in_row
        # group the flat positions per column through CSC (+1 keeps
        # position 0 distinct from CSC's implicit zeros)
        P = sp.csr_matrix((flatpos + 1, Xc.indices, Xc.indptr),
                          shape=(n, g)).tocsc()
        col_nnz = np.diff(P.indptr)
        pos_in_col = np.arange(P.nnz) - np.repeat(P.indptr[:-1], col_nnz)
        cc = np.repeat(np.arange(g), col_nnz)
        rows_t[cc, pos_in_col] = P.indices
        perm_t[cc, pos_in_col] = P.data - 1
    return rows_t, perm_t


def _as_clean_csr(X) -> sp.csr_matrix:
    if sp.issparse(X):
        Xc = X.tocsr().copy()
        Xc.eliminate_zeros()
        return Xc
    return sp.csr_matrix(np.asarray(X))


def csr_to_ell(X, width: int | None = None, t_width: int | None = None,
               transpose: bool = True, dtype=np.float32) -> EllMatrix:
    """Host CSR (or dense) -> dual ELL with numpy leaves; explicit zeros
    are dropped so "stored value > 0 <=> data nonzero" holds."""
    Xc = _as_clean_csr(X)
    n, g = Xc.shape
    max_row = int(np.diff(Xc.indptr).max()) if n else 0
    if width is None:
        width = _pad_width(max_row)
    elif width < max_row:
        raise ValueError(
            f"width={width} < max row nnz {max_row}: rows would truncate")
    if transpose and n * int(width) >= 2 ** 31:
        # perm_t holds flat row-side slot positions (and the sentinel
        # n * w) as int32
        raise ValueError(
            f"{n} rows x width {width} = {n * int(width)} row-side slots: "
            "the transpose index set addresses at most 2**31 - 1")
    vals, cols = _row_ell_buffers(Xc, width, dtype)
    rows_t = perm_t = None
    if transpose:
        max_col = (int(np.bincount(Xc.indices, minlength=g).max())
                   if g and Xc.nnz else 0)
        if t_width is None:
            t_width = _pad_width(max_col)
        elif t_width < max_col:
            raise ValueError(f"t_width={t_width} < max col nnz {max_col}")
        rows_t, perm_t = _transpose_buffers(Xc, width, t_width)
    return EllMatrix(vals, cols, g, rows_t, perm_t)


def ell_chunk_rows(X, chunk_size: int, width: int | None = None,
                   dtype=np.float32):
    """Chunked dual ELL for the online solver: rows zero-padded to a
    multiple of ``chunk_size``, one transpose index set per chunk, all
    widths global maxima. Returns ``(EllMatrix with (C, chunk, w) row
    leaves and (C, g, wt) transpose leaves, pad)``."""
    Xc = _as_clean_csr(X)
    n, g = Xc.shape
    chunk_size = int(min(chunk_size, n))
    n_chunks = max(1, -(-n // chunk_size))
    pad = n_chunks * chunk_size - n
    if pad:
        Xc = sp.vstack(
            [Xc, sp.csr_matrix((pad, g), dtype=Xc.dtype)]).tocsr()
    if width is None:
        width = ell_row_width(Xc)
    blocks = [Xc[i * chunk_size:(i + 1) * chunk_size]
              for i in range(n_chunks)]
    t_width = _pad_width(max(
        int(np.diff(b.tocsc().indptr).max()) if g else 0 for b in blocks))
    vs, cs, rts, pts = [], [], [], []
    for b in blocks:
        v, c = _row_ell_buffers(b, width, dtype)
        rt, pt = _transpose_buffers(b, width, t_width)
        vs.append(v)
        cs.append(c)
        rts.append(rt)
        pts.append(pt)
    return EllMatrix(np.stack(vs), np.stack(cs), g,
                     np.stack(rts), np.stack(pts)), pad


def resolve_sparse_beta(beta: float, density: float | None = None,
                        width: int | None = None, g: int | None = None,
                        override=None) -> bool:
    """Should a beta != 2 solve take the ELL lane? On for beta in {1, 0}
    at density <= SPARSE_DENSITY_THRESHOLD and width <= g/8.
    ``CNMF_TPU_SPARSE_BETA``: ``0`` forces dense, ``1`` forces ELL (for
    beta in {1, 0}), a value in (0, 1) replaces the density threshold (the
    width guard stays); anything else raises. An explicit ``override``
    wins over the knob."""
    if beta not in (1.0, 0.0):
        return False
    if override is not None:
        return bool(override)
    threshold = SPARSE_DENSITY_THRESHOLD
    env = env_str("CNMF_TPU_SPARSE_BETA", "")
    if env:
        try:
            t = float(env)
        except ValueError:
            raise ValueError(
                f"CNMF_TPU_SPARSE_BETA={env!r}: expected 0 (dense), "
                "1 (force ELL), or a density threshold in (0, 1)")
        if t <= 0.0:
            return False
        if t >= 1.0:
            return True
        threshold = t
    if density is None:
        return False
    if width is not None and g is not None and 8 * width > g:
        return False
    return float(density) <= threshold


# ---------------------------------------------------------------------------
# plain statistics (the CUDA kernels' reference versions)
# ---------------------------------------------------------------------------

def _cast(vals, H, W, bf16: bool):
    if bf16:
        return (vals.to(torch.bfloat16), H.to(torch.bfloat16),
                W.to(torch.bfloat16))
    return vals, H, W


def _eps_like(t):
    return torch.tensor(EPS, dtype=t.dtype, device=t.device)


def _slab(W, cols, c: int):
    """``W[:, c][:, cols]`` — component c's values at the stored columns,
    ``(R, n, w)``."""
    return W[:, c][:, cols.long()]


def _wh_at_nz(cols, H, W):
    """``(H @ W)`` at the stored coordinates, accumulated in the operand
    dtype as an unrolled sum over components (the JAX form)."""
    k = H.shape[-1]
    acc = H[..., 0:1] * _slab(W, cols, 0)
    for c in range(1, k):
        acc = acc + H[..., c:c + 1] * _slab(W, cols, c)
    return acc


def _ratio(vals, cols, H, W, bf16: bool):
    vals, Hc, Wc = _cast(vals, H, W, bf16)
    wh = _wh_at_nz(cols, Hc, Wc)
    return vals / torch.maximum(wh, _eps_like(wh)), Wc


def _h_numer(cols, ratio, W):
    """``ratio @ W^T`` with the ratio supported on the stored slots: each
    product in the operands' dtype, summed in f32, ``(R, n, k)``."""
    return torch.stack(
        [(ratio * _slab(W, cols, c)).float().sum(-1)
         for c in range(W.shape[1])], dim=-1)


def ell_h_numer(vals, cols, H, W, bf16: bool = False):
    """Plain ``h_stats``: ``numer[r, i, c] = sum_j ratio[r, i, j] *
    W[r, c, cols[i, j]]``, ``(R, n, k)`` f32."""
    ratio, Wc = _ratio(vals, cols, H, W, bf16)
    return _h_numer(cols, ratio, Wc)


def _flat(ratio):
    """``(R, n, w)`` slot values flattened row-major per replicate with one
    zero sentinel slot appended, ``(R, n*w + 1)``."""
    R = ratio.shape[0]
    return torch.cat([ratio.reshape(R, -1), ratio.new_zeros((R, 1))], dim=1)


def ell_ratio_flat(vals, cols, H, W, bf16: bool = False):
    """The ratio at every stored slot, flattened row-major per replicate
    with one zero sentinel slot appended, ``(R, n*w + 1)`` (bf16 in bf16
    mode, else f32)."""
    return _flat(_ratio(vals, cols, H, W, bf16)[0])


def ell_w_numer_from_ratio(rows_t, perm_t, r_flat, H, bf16: bool = False):
    """``numer[r, c, gene] = sum_t r_flat[r, perm_t[gene, t]] * H[r,
    rows_t[gene, t], c]``, ``(R, k, g)`` f32."""
    Hc = H.to(torch.bfloat16) if bf16 else H
    r_t = r_flat[:, perm_t.long()]                       # (R, g, wt)
    rows = rows_t.long()
    return torch.stack(
        [(r_t * Hc[:, :, c][:, rows]).float().sum(-1)
         for c in range(H.shape[-1])], dim=1)


def ell_w_numer(vals, cols, rows_t, perm_t, H, W, bf16: bool = False):
    """Plain ``w_numer``: the KL W-update numerator ``(R, k, g)`` f32, as
    :func:`ell_ratio_flat` then :func:`ell_w_numer_from_ratio`."""
    r_flat = ell_ratio_flat(vals, cols, H, W, bf16)
    return ell_w_numer_from_ratio(rows_t, perm_t, r_flat, H, bf16)


def ell_kl_h_stats(x: EllMatrix, H, W, bf16: bool = False):
    """KL H-update statistics on the stored nonzeros: ``numer (R, n, k)``
    f32 and the data-independent ``denom = W.sum(-1)`` broadcast."""
    numer = ell_h_numer(x.vals, x.cols, H, W, bf16)
    return numer, W.sum(-1)[:, None, :].expand(H.shape)


def ell_wh_slots(cols, H, W):
    """Plain ``wh_at_nz``: ``wh[r, i, j] = H[r, i, :] @ W[r, :, cols[i,
    j]]`` at every stored slot (padding included), ``(R, n, w)`` f32."""
    return _wh_at_nz(cols, H.float(), W.float())


def ell_wh_at_nz(x: EllMatrix, H, W):
    """The SDDMM ``H @ W`` at the stored coordinates, ``(R, n, w)`` f32
    (``ell_wh_at_nz`` of the JAX package, with the replicate axis)."""
    return ell_wh_slots(x.cols, H, W)


def ell_h_newton(vals, cols, H, W):
    """Plain ``h_newton_stats``, strict f32: the MU numerator
    ``numer[r, i, c] = sum_j ratio * W[r, c, col]`` and the diagonal
    Hessian ``hess[r, i, c] = sum_j (ratio / whm) * W[r, c, col]^2`` with
    ``whm = max(wh, EPS)`` and ``ratio = X / whm``; ``(R, n, k)`` each.
    Padded slots (value 0) add exact zeros to both."""
    wh = _wh_at_nz(cols, H, W)
    whm = torch.maximum(wh, _eps_like(wh))
    ratio = vals / whm
    r2 = ratio / whm
    numers, hesses = [], []
    for c in range(W.shape[1]):
        slab = _slab(W, cols, c)
        numers.append((ratio * slab).sum(-1))
        hesses.append((r2 * slab * slab).sum(-1))
    return torch.stack(numers, dim=-1), torch.stack(hesses, dim=-1)


def ell_kl_h_newton_stats(x: EllMatrix, H, W):
    """KL H statistics of the Diagonalized-Newton recipe on the stored
    nonzeros: ``(numer, denom, hess)``, the data-independent ``denom =
    W.sum(-1)`` broadcast for the MU fallback candidate."""
    numer, hess = ell_h_newton(x.vals, x.cols, H, W)
    return numer, W.sum(-1)[:, None, :].expand(H.shape), hess


def _need_transpose(x: EllMatrix):
    if x.rows_t is None:
        raise ValueError("this EllMatrix has no transpose index set "
                         "(rows_t/perm_t); encode with transpose=True")


def ell_kl_w_numer(x: EllMatrix, H, W, bf16: bool = False):
    """KL W-update numerator ``H^T (X / WH)`` through the transpose index
    set: ``(R, k, g)`` f32."""
    _need_transpose(x)
    return ell_w_numer(x.vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)


def ell_kl_w_stats(x: EllMatrix, H, W, bf16: bool = False):
    numer = ell_kl_w_numer(x, H, W, bf16)
    return numer, H.sum(1)[:, :, None].expand(W.shape)


def ell_take_rows(x: EllMatrix, idx) -> EllMatrix:
    """The rows ``idx`` of an unchunked encoding (repeats allowed; a
    repeated row counts twice) as an encoding of its own, on ``x``'s
    device, with a transpose index set built for it there: the stored
    slots' flat positions in row-major order, stably sorted by column, so
    each gene lists its slots in increasing position and every padded
    slot points at the sentinel ``m * w``. Every step is deterministic
    (no floating-point atomics), so the statistics of a sampled encoding
    are bit-identical from run to run."""
    idx = torch.as_tensor(idx).to(device=x.vals.device, dtype=torch.long)
    vals = x.vals[idx].contiguous()
    cols = x.cols[idx].contiguous()
    m, w = vals.shape
    g = int(x.g)
    dev = vals.device
    pos = torch.nonzero(vals.reshape(-1) != 0).reshape(-1)
    genes = cols.reshape(-1)[pos].long()
    genes, order = torch.sort(genes, stable=True)
    pos = pos[order]
    counts = torch.bincount(genes, minlength=g)
    t_width = _pad_width(int(counts.max()) if pos.numel() else 0)
    slot = (torch.arange(pos.numel(), device=dev)
            - (torch.cumsum(counts, 0) - counts)[genes])
    rows_t = torch.zeros((g, t_width), dtype=torch.int32, device=dev)
    perm_t = torch.full((g, t_width), m * w, dtype=torch.int32, device=dev)
    rows_t[genes, slot] = torch.div(pos, w, rounding_mode="floor").int()
    perm_t[genes, slot] = pos.int()
    return EllMatrix(vals, cols, g, rows_t, perm_t)


def ell_kl_w_stats_rows(x: EllMatrix, H, W, idx):
    """KL W-update statistics from the row subsample ``idx`` of the sketch
    recipe: the numerator ``H[idx]^T (X[idx] / WH[idx])`` on the sampled
    rows' stored slots and the sampled rows' column sums, both ``(R, k,
    g)``. The JAX package scatter-adds the sampled slots' contributions
    per column; here :func:`ell_take_rows` sorts them by column and each
    gene sums its own list, which gives the same function without
    floating-point atomics (the order of a scatter-add on a card changes
    from run to run)."""
    idx = torch.as_tensor(idx).to(device=H.device, dtype=torch.long)
    return ell_kl_w_stats(ell_take_rows(x, idx), H[:, idx].contiguous(), W)


# ---------------------------------------------------------------------------
# Itakura-Saito (beta=0): the hybrid of a dense WH and the stored slots
# ---------------------------------------------------------------------------

def _wh_dense(H, W, bf16: bool):
    """``max(H @ W, EPS)`` ``(R, n, g)``; bf16 operands and output in bf16
    mode (the JAX chain's ``preferred_element_type=bf16``)."""
    if bf16:
        wh = H.to(torch.bfloat16) @ W.to(torch.bfloat16)
    else:
        wh = H @ W
    return torch.maximum(wh, _eps_like(wh))


def _is_ratio(x: EllMatrix, inv):
    """``X / WH^2`` at the stored slots from the dense ``1/WH``, rounded
    after each product in ``inv``'s dtype."""
    R = inv.shape[0]
    cols = x.cols.long().expand(R, *x.cols.shape)
    inv_nz = torch.gather(inv, -1, cols)
    return x.vals.to(inv.dtype) * inv_nz * inv_nz


def ell_is_h_stats(x: EllMatrix, H, W, bf16: bool = False):
    """IS H-update statistics: the numerator ``(X/WH^2) @ W^T`` on the
    stored slots (:func:`_h_numer`) and the dense denominator ``(1/WH) @
    W^T``, both ``(R, n, k)`` f32. In bf16 mode ``WH``, ``1/WH`` and the
    slot ratio are bf16 and the products are summed in f32."""
    inv = 1.0 / _wh_dense(H, W, bf16)
    Wb = W.to(torch.bfloat16) if bf16 else W
    denom = inv.float() @ Wb.float().mT
    return _h_numer(x.cols, _is_ratio(x, inv), Wb), denom


def ell_is_w_stats(x: EllMatrix, H, W, bf16: bool = False):
    """IS W-update statistics: the numerator ``H^T (X/WH^2)`` through the
    transpose index set (:func:`ell_w_numer_from_ratio`) and the dense
    denominator ``H^T (1/WH)``, both ``(R, k, g)`` f32."""
    _need_transpose(x)
    inv = 1.0 / _wh_dense(H, W, bf16)
    Hb = H.to(torch.bfloat16) if bf16 else H
    denom = Hb.float().mT @ inv.float()
    numer = ell_w_numer_from_ratio(x.rows_t, x.perm_t,
                                   _flat(_is_ratio(x, inv)), H, bf16)
    return numer, denom


def is_per_elem(Xs, WHs):
    """Itakura-Saito term ``x/wh - log(x/wh) - 1`` of EPS-floored operands:
    ``v - log1p(v)`` (``v = x/wh - 1``) near convergence, and the logs
    split where the ratio is below 1e-6 (an EPS-floored zero count, where
    ``v`` rounds to -1 and ``log1p(-1)`` is ``-inf``)."""
    ratio = Xs / WHs
    v = ratio - 1.0
    stable = v - torch.log1p(torch.clamp_min(v, -1.0 + EPS))
    tiny = v + torch.log(WHs) - torch.log(Xs)
    return torch.where(ratio < 1e-6, tiny, stable)


def kl_nz_term(Xp, WHs):
    """Cancellation-safe KL term for X > 0: ``X (u - log1p(u))`` with
    ``u = WH/X - 1``, logs split where ``WH/X`` underflows."""
    ratio = WHs / Xp
    u = ratio - 1.0
    stable = u - torch.log1p(torch.clamp_min(u, -1.0 + EPS))
    tiny = u + torch.log(Xp) - torch.log(WHs)
    return Xp * torch.where(ratio < 1e-6, tiny, stable)


def ell_beta_err_rows(vals, cols, H, W):
    """Plain ``beta_err_partials``: the nonzero-supported part of each
    row's ``D_KL(X || HW)`` term, ``(R, n)`` f32:
    ``sum_{X>0} [kl_nz_term - WH]`` over the row's slots, the f32 terms
    summed in f64 and rounded once (a row's terms change sign where
    ``WH = X/e`` and may cancel; the CUDA kernel sums them so too)."""
    vals = vals.float()
    wh = _wh_at_nz(cols, H.float(), W.float())
    nz = torch.where(
        vals > 0,
        kl_nz_term(torch.clamp_min(vals, EPS), torch.clamp_min(wh, EPS))
        - wh, torch.zeros((), dtype=wh.dtype, device=wh.device))
    return nz.sum(-1, dtype=torch.float64).float()


def ell_beta_err_nz(vals, cols, H, W):
    """The nonzero-supported part of ``D_KL(X || HW)`` per replicate,
    ``(R,)`` f32: the rows of :func:`ell_beta_err_rows` summed."""
    return ell_beta_err_rows(vals, cols, H, W).sum(1)


def total_wh(H, W):
    """``sum_all WH = H.sum(rows) . W.sum(genes)`` per replicate."""
    return (H.float().sum(1) * W.float().sum(-1)).sum(-1)


def ell_beta_err(x: EllMatrix, H, W, beta: float = 1.0):
    """``D_beta(X || HW)`` per replicate from the ELL encoding (f32), for
    beta in {1, 0}. KL: the stored slots' terms plus ``sum_all WH``. IS:
    every entry's term with an EPS-floored X from the dense ``WH``, then
    the stored slots' terms swapped in for their EPS-floored ones."""
    if beta == 1.0:
        return ell_beta_err_nz(x.vals, x.cols, H, W) + total_wh(H, W)
    if beta != 0.0:
        raise NotImplementedError(
            f"ELL objective implements beta in {{1, 0}}, got {beta}")
    WH = _wh_dense(H.float(), W.float(), False)
    eps = _eps_like(WH)
    base = is_per_elem(eps, WH).sum(dim=(1, 2))
    vals = x.vals.float()
    wh_nz = torch.gather(WH, -1, x.cols.long().expand(WH.shape[0],
                                                      *x.cols.shape))
    corr = torch.where(
        vals > 0, is_per_elem(torch.clamp_min(vals, EPS), wh_nz)
        - is_per_elem(eps, wh_nz), torch.zeros((), device=WH.device))
    return base + corr.sum(dim=(1, 2))
