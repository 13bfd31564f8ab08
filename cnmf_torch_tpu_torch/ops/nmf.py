"""Multiplicative-update beta-divergence NMF — the online solver of the
consensus sweep and the fixed-spectra usage refit.

Port of the parts of ``cnmf_torch_tpu/ops/nmf.py`` the online KL main path
reaches (beta in {2, 1}; dense and ELL; bf16 ratio chain and strict f32).
Model convention as there: ``X (cells x genes) ~= H (cells x k) @ W (k x
genes)``.

The replicate axis is explicit: ``H`` is ``(R, n, k)`` and ``W`` is
``(R, k, g)`` everywhere below (JAX ``vmap``-ed a solo solver instead).
Every loop keeps a per-lane ``active`` mask and applies
``torch.where(active, new, old)``, so a lane that has stopped keeps its
state while the others go on — each lane's result is its solo solve. The
host reads ``active.any()`` at most once every ``EVAL_EVERY`` inner
iterations (and once per pass in the pass loop).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from .kernels import kl_ell
from .sparse import (EllMatrix, csr_to_ell, ell_row_width, kl_nz_term,
                     resolve_sparse_beta)

__all__ = ["EPS", "EVAL_EVERY", "BETA_LOSS", "beta_loss_to_float",
           "beta_divergence", "resolve_online_schedule",
           "resolve_bf16_ratio", "split_regularization", "mu_gamma",
           "nmf_fit_online", "random_init", "fit_h", "fit_h_default_init",
           "lane_health"]

EPS = 1e-16
EVAL_EVERY = 10
BETA_LOSS = {"frobenius": 2.0, "kullback-leibler": 1.0, "itakura-saito": 0.0}

# elementwise size below which the beta=2 objective materializes X - HW
_DENSE_ERR_ELEMS = 1 << 22


def lane_health(errs, spectra=None) -> np.ndarray:
    """Per-lane health (True = finite final objective and, when given,
    finite spectra) — computed on the host from the solver's outputs."""
    errs = np.asarray(errs, dtype=np.float64).reshape(-1)
    health = np.isfinite(errs)
    if spectra is not None:
        S = np.asarray(spectra)
        health &= np.isfinite(S.reshape(S.shape[0], -1)).all(axis=1)
    return health


def beta_loss_to_float(beta_loss) -> float:
    if isinstance(beta_loss, str):
        try:
            return BETA_LOSS[beta_loss]
        except KeyError:
            raise ValueError(
                "beta_loss must be one of ['frobenius', 'kullback-leibler', "
                "'itakura-saito'] or a numeric value.") from None
    if isinstance(beta_loss, (int, float)):
        return float(beta_loss)
    raise ValueError("beta_loss must be a string or numeric value.")


def _unported(beta):
    return NotImplementedError(
        f"beta={beta} is not ported yet (this slice runs beta in {{2, 1}})")


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def _beta_div_dense(X, WH, beta: float):
    """Per-lane beta-divergence sum for a materialized ``WH (R, n, g)``."""
    if beta == 1.0:
        per_elem = torch.where(
            X > 0, kl_nz_term(torch.clamp_min(X, EPS),
                              torch.clamp_min(WH, EPS)), WH)
        return per_elem.sum(dim=(1, 2))
    if beta == 2.0:
        return 0.5 * ((X - WH) ** 2).sum(dim=(1, 2))
    raise _unported(beta)


def beta_divergence(X, H, W, beta: float = 2.0):
    """``D_beta(X || HW)`` per replicate, ``(R,)`` f32. ``X`` may be an
    :class:`EllMatrix` for beta=1 (the nonzero terms run in the
    ``beta_err_partials`` kernel on the card)."""
    if isinstance(X, EllMatrix):
        if beta != 1.0:
            raise _unported(beta)
        return kl_ell.kl_beta_err(X, H, W)
    if beta == 2.0:
        if X.shape[-2] * X.shape[-1] <= _DENSE_ERR_ELEMS:
            Rm = X - H @ W
            return 0.5 * (Rm * Rm).sum(dim=(1, 2))
        HtH = H.mT @ H
        HtX = H.mT @ X
        return torch.clamp_min(
            0.5 * ((X * X).sum() - 2.0 * (W * HtX).sum(dim=(1, 2))
                   + ((HtH @ W) * W).sum(dim=(1, 2))), 0.0)
    return _beta_div_dense(X, H @ W, beta)


# ---------------------------------------------------------------------------
# schedules and update rules
# ---------------------------------------------------------------------------

def resolve_online_schedule(beta: float, h_tol=None, n_passes=None):
    """Per-loss ``(h_tol, n_passes, h_tol_start)`` of the online solver:
    beta=2 runs a constant 3e-3 inner tolerance for 20 passes; beta != 2
    runs coarse-to-fine (0.1 halving per pass to 1e-2) for up to 60 passes.
    An explicit ``h_tol`` runs constant."""
    h_tol_start = None
    if h_tol is None:
        h_tol = 3e-3 if beta == 2.0 else 1e-2
        if beta != 2.0:
            h_tol_start = 0.1
    if n_passes is None:
        n_passes = 60 if (beta != 2.0 and float(h_tol) >= 5e-3) else 20
    return float(h_tol), int(n_passes), h_tol_start


def resolve_bf16_ratio(beta: float, mode: str, override=None) -> bool:
    """The bf16 ratio chain is on for online KL/IS sweeps, off elsewhere;
    an explicit ``override`` wins."""
    if override is not None:
        return bool(override)
    return beta in (1.0, 0.0) and mode == "online"


def split_regularization(alpha: float, l1_ratio: float) -> tuple[float, float]:
    return (float(alpha) * float(l1_ratio),
            float(alpha) * (1.0 - float(l1_ratio)))


def mu_gamma(beta: float) -> float:
    beta = float(beta)
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


def _apply_rate(M, numer, denom, l1, l2, eps=EPS, gamma: float = 1.0):
    """MU rate: L1-shifted clamped numerator, L2 added to the denominator,
    rate zeroed where the denominator underflows."""
    numer = torch.clamp_min(numer - l1, 0.0) if l1 else numer
    denom = denom + l2 * M if l2 else denom
    rate = torch.where(denom < eps, torch.zeros((), dtype=numer.dtype,
                                                device=numer.device),
                       numer / torch.clamp_min(denom, eps))
    if gamma != 1.0:
        rate = rate ** gamma
    return M * rate


def _bf16_eps(t):
    return torch.tensor(EPS, dtype=torch.bfloat16, device=t.device)


def _update_H(X, H, W, beta: float, l1: float, l2: float,
              bf16_ratio: bool = False):
    """One MU step of the usages. ``X`` is a dense ``(n, g)`` tensor or an
    :class:`EllMatrix`; bf16 mode expects ``X`` already cast (the solvers
    cast once per chunk)."""
    if isinstance(X, EllMatrix):
        if beta != 1.0:
            raise _unported(beta)
        numer, denom = kl_ell.kl_h_stats(X, H, W, bf16_ratio)
        return _apply_rate(H, numer, denom, l1, l2, gamma=mu_gamma(beta))
    if beta == 2.0:
        numer = X @ W.mT
        denom = H @ (W @ W.mT)
    elif beta == 1.0 and bf16_ratio:
        wb = W.to(torch.bfloat16)
        wh = H.to(torch.bfloat16) @ wb
        ratio = X.to(torch.bfloat16) / torch.maximum(wh, _bf16_eps(wh))
        numer = ratio.float() @ wb.float().mT
        denom = W.sum(-1)[:, None, :].expand(H.shape)
    elif beta == 1.0:
        numer = (X / torch.clamp_min(H @ W, EPS)) @ W.mT
        denom = W.sum(-1)[:, None, :].expand(H.shape)
    else:
        raise _unported(beta)
    return _apply_rate(H, numer, denom, l1, l2, gamma=mu_gamma(beta))


def _update_W(X, H, W, beta: float, l1: float, l2: float,
              bf16_ratio: bool = False):
    """One MU step of the spectra (same conventions as :func:`_update_H`;
    the ELL kernels cast f32 values to bf16 themselves)."""
    if isinstance(X, EllMatrix):
        if beta != 1.0:
            raise _unported(beta)
        numer, denom = kl_ell.kl_w_stats(X, H, W, bf16_ratio)
        return _apply_rate(W, numer, denom, l1, l2, gamma=mu_gamma(beta))
    if beta == 2.0:
        numer = H.mT @ X
        denom = (H.mT @ H) @ W
    elif beta == 1.0 and bf16_ratio:
        hb = H.to(torch.bfloat16)
        wh = hb @ W.to(torch.bfloat16)
        ratio = X.to(torch.bfloat16) / torch.maximum(wh, _bf16_eps(wh))
        numer = hb.float().mT @ ratio.float()
        denom = H.sum(1)[:, :, None].expand(W.shape)
    elif beta == 1.0:
        numer = H.mT @ (X / torch.clamp_min(H @ W, EPS))
        denom = H.sum(1)[:, :, None].expand(W.shape)
    else:
        raise _unported(beta)
    return _apply_rate(W, numer, denom, l1, l2, gamma=mu_gamma(beta))


# ---------------------------------------------------------------------------
# masked loops
# ---------------------------------------------------------------------------

def _rel_change(new, old):
    return (torch.linalg.vector_norm(new - old, dim=(1, 2))
            / (torch.linalg.vector_norm(old, dim=(1, 2)) + EPS))


def _lane_tensor(v, R, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((R,), float(v), dtype=torch.float32, device=device)


def _masked_loop(M, step, max_iter: int, tol, active):
    """Iterate ``M <- step(M)`` per lane until the lane's relative change
    drops below ``tol`` or it has run ``max_iter`` steps (the semantics of
    the JAX ``while_loop``s under ``vmap``)."""
    R = M.shape[0]
    M = M.contiguous()      # a chunk's block of (R, C, chunk, k) is strided
    tol = _lane_tensor(tol, R, M.device)
    active = (torch.ones(R, dtype=torch.bool, device=M.device)
              if active is None else active.clone())
    it = torch.zeros(R, dtype=torch.int32, device=M.device)
    steps = 0
    while steps < max_iter:
        M_new = step(M)
        rel = _rel_change(M_new, M)
        M = torch.where(active[:, None, None], M_new, M)
        it = it + active.to(torch.int32)
        active = active & (it < max_iter) & (rel >= tol)
        steps += 1
        if steps % EVAL_EVERY == 0 and not bool(active.any()):
            break
    return M


def _chunk_h_solve(x, h, W, WWT, beta, l1, l2, max_iter, h_tol,
                   bf16_ratio: bool = False, active=None, x_cast=None):
    """Inner MU loop on one chunk's usage block with W fixed; for beta=2
    the numerator ``x @ W.T`` is precomputed once."""
    if beta == 2.0:
        numer0 = x @ W.mT
        numer0 = torch.clamp_min(numer0 - l1, 0.0) if l1 else numer0

        def step(hh):
            denom = hh @ WWT
            denom = denom + l2 * hh if l2 else denom
            rate = torch.where(denom < EPS, torch.zeros_like(denom),
                               numer0 / torch.clamp_min(denom, EPS))
            return hh * rate
    else:
        bf16 = bool(bf16_ratio) and beta in (1.0, 0.0)
        if x_cast is None:
            x_cast = _cast_x(x, bf16)

        def step(hh):
            return _update_H(x_cast, hh, W, beta, l1, l2, bf16_ratio=bf16)
    return _masked_loop(h, step, max_iter, h_tol, active)


def _cast_x(x, bf16: bool):
    if not bf16:
        return x
    if isinstance(x, EllMatrix):
        return x.with_vals(x.vals.to(torch.bfloat16))
    return x.to(torch.bfloat16)


def _solve_w_from_stats(W, A, B, l1_W, l2_W, max_iter, tol, active):
    """The beta=2 W subproblem by MU from ``A = H^T X``, ``B = H^T H``."""
    return _masked_loop(
        W, lambda M: _apply_rate(M, A, B @ M, l1_W, l2_W), max_iter, tol,
        active)


def _chunk(Xc, c):
    return Xc.chunk(c) if isinstance(Xc, EllMatrix) else Xc[c]


def nmf_fit_online(Xc, Hc0, W0, beta: float = 2.0, tol: float = 1e-4,
                   h_tol: float = 1e-3, chunk_max_iter: int = 1000,
                   n_passes: int = 20, l1_H: float = 0.0, l2_H: float = 0.0,
                   l1_W: float = 0.0, l2_W: float = 0.0,
                   h_tol_start: float | None = None,
                   bf16_ratio: bool = False, trace: list | None = None):
    """Streamed MU over pre-chunked inputs for ``R`` replicates at once.

    ``Xc``: ``(C, chunk, genes)`` dense tensor or a pre-chunked
    :class:`EllMatrix` (``ell_chunk_rows``), shared by every lane.
    ``Hc0``: ``(R, C, chunk, k)``; ``W0``: ``(R, k, g)``. Zero-padded rows
    are benign. Returns ``(Hc, W, err (R,))`` where ``err`` is the exact
    objective of the returned pair.

    beta=2: per pass every chunk's usage block is solved with W frozen
    while ``A = H^T X`` and ``B = H^T H`` accumulate; W is then solved
    from (A, B). beta=1: each chunk's usage block is solved, its f32
    objective taken, then W takes one MU step from that chunk's
    statistics (bf16 ratio chain with ``bf16_ratio``). Passes stop per
    lane on the relative objective decrease ``< tol`` (never while the
    coarse-to-fine inner tolerance is still above its floor) or at
    ``n_passes``.
    """
    if beta not in (2.0, 1.0):
        raise _unported(beta)
    bf16 = bool(bf16_ratio) and beta == 1.0
    ell = isinstance(Xc, EllMatrix)
    R, C = Hc0.shape[0], Hc0.shape[1]
    dev = W0.device
    chunks = [_chunk(Xc, c) for c in range(C)]
    casts = [_cast_x(x, bf16) for x in chunks]

    def h_tol_for(p):
        if h_tol_start is None:
            return torch.full((R,), float(h_tol), dtype=torch.float32,
                              device=dev)
        return torch.clamp_min(
            h_tol_start * torch.pow(0.5, p.to(torch.float32)),
            float(np.float32(h_tol)))

    def one_pass(Hc, W, p, active):
        h_tol_p = h_tol_for(p)
        err = torch.zeros(R, dtype=torch.float32, device=dev)
        Hc = Hc.clone()
        if beta == 2.0:
            WWT = W @ W.mT
            A = torch.zeros_like(W)
            B = torch.zeros((R, W.shape[1], W.shape[1]), dtype=W.dtype,
                            device=dev)
            for c, x in enumerate(chunks):
                h = _chunk_h_solve(x, Hc[:, c], W, WWT, beta, l1_H, l2_H,
                                   chunk_max_iter, h_tol_p, active=active)
                A = A + h.mT @ x
                B = B + h.mT @ h
                err = err + beta_divergence(x, h, W, beta=2.0)
                Hc[:, c] = h
            W_new = _solve_w_from_stats(W, A, B, l1_W, l2_W, chunk_max_iter,
                                        h_tol_p, active)
            return Hc, torch.where(active[:, None, None], W_new, W), err
        for c, x in enumerate(chunks):
            h = _chunk_h_solve(x, Hc[:, c], W, None, beta, l1_H, l2_H,
                               chunk_max_iter, h_tol_p, bf16_ratio=bf16,
                               active=active, x_cast=casts[c])
            # the objective stays f32 even when the updates run bf16
            if ell:
                err_c = kl_ell.kl_beta_err(x, h, W)
            else:
                err_c = _beta_div_dense(x, torch.clamp_min(h @ W, EPS), beta)
            W_new = _update_W(x, h, W, beta, l1_W, l2_W, bf16_ratio=bf16)
            W = torch.where(active[:, None, None], W_new, W)
            Hc[:, c] = h
            err = err + err_c
        return Hc, W, err

    all_on = torch.ones(R, dtype=torch.bool, device=dev)
    Hc, W, err0 = one_pass(Hc0, W0, torch.zeros(R, device=dev), all_on)
    err_prev = err0 * (1.0 + 2.0 * tol) + 1.0
    err = err0
    it = torch.ones(R, dtype=torch.int32, device=dev)

    def active_of(err_prev, err, it):
        progressing = (err_prev - err) / torch.clamp_min(err0, EPS) >= tol
        keep = progressing
        if h_tol_start is not None:
            keep = keep | (h_tol_start * torch.pow(0.5, it.to(torch.float32))
                           > float(np.float32(h_tol)))
        return (it < n_passes) & keep

    if trace is not None:
        trace.append(err0.cpu().numpy())
    act = active_of(err_prev, err, it)
    while bool(act.any()):
        Hc, W, err_new = one_pass(Hc, W, it, act)
        err_prev = torch.where(act, err, err_prev)
        err = torch.where(act, err_new, err)
        it = it + act.to(torch.int32)
        act = act & active_of(err_prev, err, it)
        if trace is not None:
            trace.append(err.cpu().numpy())

    err = torch.zeros(R, dtype=torch.float32, device=dev)
    for c, x in enumerate(chunks):
        err = err + beta_divergence(x, Hc[:, c].contiguous(), W,
                                     beta=beta)
    return Hc, W, err


# ---------------------------------------------------------------------------
# initialization and the fixed-spectra usage refit
# ---------------------------------------------------------------------------

def random_init(seed: int, n: int, g: int, k: int, x_mean: float,
                device="cpu"):
    """Scaled random init ``avg * |N(0, 1)|`` with ``avg = sqrt(mean(X)/k)``,
    drawn from a CPU ``torch.Generator`` seeded with ``seed`` and moved to
    ``device`` (a seed gives the same init on the CPU and on the card)."""
    gen = torch.Generator().manual_seed(int(seed))
    avg = float(np.sqrt(max(float(x_mean), EPS) / k))
    H = avg * torch.randn((n, k), generator=gen, dtype=torch.float32).abs()
    W = avg * torch.randn((k, g), generator=gen, dtype=torch.float32).abs()
    return H.to(device), W.to(device)


def fit_h_default_init(n: int, k: int, seed: int = 0, device="cpu"):
    """The usage refit's default init: ``uniform(0, 1)`` of shape (n, k)
    from a CPU generator seeded with ``seed`` (0 by default)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.rand((n, k), generator=gen, dtype=torch.float32).to(device)


def _chunk_rows(X, H, chunk_size: int):
    """Zero-pad rows to a multiple of ``chunk_size`` and add the chunk axis:
    ``(C, chunk, ...)`` for X (dense or unchunked ELL) and ``(1, C, chunk,
    k)`` for H."""
    n, k = H.shape
    n_chunks = max(1, -(-n // chunk_size))
    pad = n_chunks * chunk_size - n
    H = torch.nn.functional.pad(H, (0, 0, 0, pad))
    Hc = H.reshape(1, n_chunks, chunk_size, k)
    if isinstance(X, EllMatrix):
        vals = torch.nn.functional.pad(X.vals, (0, 0, 0, pad))
        cols = torch.nn.functional.pad(X.cols, (0, 0, 0, pad))
        w = vals.shape[1]
        return (EllMatrix(vals.reshape(n_chunks, chunk_size, w),
                          cols.reshape(n_chunks, chunk_size, w), X.g),
                Hc, pad)
    X = torch.nn.functional.pad(X, (0, 0, 0, pad))
    return X.reshape(n_chunks, chunk_size, X.shape[1]), Hc, pad


def dense_on_device(X, device):
    """A host matrix (dense or scipy-sparse) as a dense f32 tensor on
    ``device``; a sparse matrix is densified on the device, so the host
    never holds the dense copy."""
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=torch.float32)
    if sp.issparse(X):
        Xc = X.tocsr()
        rows = np.repeat(np.arange(Xc.shape[0]), np.diff(Xc.indptr))
        out = torch.zeros(Xc.shape, dtype=torch.float32, device=device)
        return out.index_put_(
            (torch.as_tensor(rows).to(device),
             torch.as_tensor(Xc.indices.astype(np.int64)).to(device)),
            torch.as_tensor(Xc.data.astype(np.float32)).to(device),
            accumulate=True)
    return torch.as_tensor(np.asarray(X, dtype=np.float32)).to(device)


def stage_matrix(X, beta: float, device):
    """Host matrix -> what the usage refit takes on ``device``: a sparse
    input under the ELL dispatch rule becomes an :class:`EllMatrix`
    (without the transpose index set, which only W steps read), anything
    else a dense f32 tensor."""
    if isinstance(X, EllMatrix):
        return X.to(device)
    if sp.issparse(X):
        n, g = X.shape
        if resolve_sparse_beta(float(beta), density=X.nnz / max(n * g, 1),
                               width=ell_row_width(X), g=g):
            return csr_to_ell(X, transpose=False).to(device)
    return dense_on_device(X, device)


def fit_h(X, W, H_init=None, chunk_size: int = 5000,
          chunk_max_iter: int = 200, h_tol: float = 0.05,
          l1_reg_H: float = 0.0, l2_reg_H: float = 0.0, beta: float = 2.0,
          device="cuda") -> np.ndarray:
    """Fit usages H for fixed spectra W: one pass over row chunks, an inner
    MU loop per chunk with relative-change tolerance ``h_tol``; uniform
    init (:func:`fit_h_default_init`) when ``H_init`` is None, else
    ``H_init`` clamped at zero. A scipy-sparse ``X`` with beta=1 under the
    ELL rule runs on the ELL kernels (f32). Returns numpy ``(n, k)``."""
    dev = resolve_device(device)
    beta = float(beta)
    if isinstance(X, EllMatrix) and beta != 1.0:
        raise ValueError(f"EllMatrix inputs require beta=1, got {beta}")
    X = stage_matrix(X, beta, dev)
    Wt = torch.tensor(np.ascontiguousarray(W, dtype=np.float32)).to(dev)
    n = X.shape[0]
    k = Wt.shape[0]
    if H_init is None:
        H = fit_h_default_init(n, k, device=dev)
    else:
        H = torch.clamp_min(torch.tensor(
            np.ascontiguousarray(H_init, dtype=np.float32)).to(dev), 0.0)
    Xc, Hc, pad = _chunk_rows(X, H, int(min(chunk_size, n)))
    W1 = Wt[None]
    WWT = W1 @ W1.mT if beta == 2.0 else None
    out = []
    for c in range(Hc.shape[1]):
        out.append(_chunk_h_solve(_chunk(Xc, c), Hc[:, c], W1, WWT, beta,
                                  float(l1_reg_H), float(l2_reg_H),
                                  int(chunk_max_iter), float(h_tol)))
    H = torch.cat(out, dim=1)[0, :n]
    return H.cpu().numpy()
