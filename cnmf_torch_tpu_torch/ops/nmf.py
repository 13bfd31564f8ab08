"""Beta-divergence NMF solvers — the online and batch solvers of the
consensus sweep, the nmf-torch style ``run_nmf`` and the fixed-spectra
usage refit.

Port of ``cnmf_torch_tpu/ops/nmf.py`` for every beta (Frobenius,
Kullback-Leibler, Itakura-Saito, a generic beta on the dense lane; the
ELL lane for beta in {1, 0}); the bf16 ratio chain, strict f32 and the
f64 batch solve (``fp_precision="double"``); the ``mu``, ``amu``,
``dna``, ``hals`` and ``sketch`` recipes of ``ops/recipe.py``; the
bundle-packed beta=2 batch solver; the random and the nndsvd family of
inits. Model convention as there: ``X (cells x genes) ~= H (cells x k) @
W (k x genes)``.

The replicate axis is explicit: ``H`` is ``(R, n, k)`` and ``W`` is
``(R, k, g)`` everywhere below (JAX ``vmap``-ed a solo solver instead).
Every loop keeps a per-lane ``active`` mask and applies
``torch.where(active, new, old)``, so a lane that has stopped keeps its
state while the others go on — each lane's result is its solo solve. The
host reads ``active.any()`` at most once every ``EVAL_EVERY`` inner
iterations (and once per pass in the pass loop). Those reads, a pass's
trace and the result copies are the solvers' chosen host reads: each sits
in ``utils/sanitize.py:host_read``, so ``sync_guard`` lets it through and
raises on any other device-to-host sync.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..utils.envknobs import env_flag
from ..utils.sanitize import host_read
from .kernels import kl_ell
from .recipe import SolverRecipe, resolve_recipe
from .sparse import (EllMatrix, _lane0, _one_replicate, csr_to_ell,
                     ell_beta_err, ell_chunk_rows, ell_is_h_stats,
                     ell_is_w_stats, ell_row_width, is_per_elem, kl_nz_term,
                     resolve_sparse_beta)

__all__ = ["EPS", "EVAL_EVERY", "INNER_STAG_TOL", "BETA_LOSS",
           "SolverTelemetry", "beta_loss_to_float", "beta_divergence",
           "resolve_online_schedule", "resolve_bf16_ratio",
           "split_regularization", "mu_gamma", "nmf_fit_batch",
           "nmf_fit_batch_hals", "nmf_fit_batch_bundled", "bundle_width",
           "bundle_stacks", "unbundle_stacks", "bundled_beta2_update",
           "nmf_fit_online", "random_init", "nndsvd_base", "nndsvd_fill",
           "nndsvd_init", "init_factors", "fit_h", "fit_h_default_init",
           "fit_h_slabbed", "gram_svd_base", "nndsvd_init_gram",
           "lane_health", "run_nmf", "run_nmf_use_ell", "sweep_x_mean",
           "takes_ell_lane", "dense_update_cost"]

EPS = 1e-16
EVAL_EVERY = 10
# amu: a repeat whose relative H change drops below this leaves the
# repeat loop early (its lane only)
INNER_STAG_TOL = 1e-4
BETA_LOSS = {"frobenius": 2.0, "kullback-leibler": 1.0, "itakura-saito": 0.0}

# elementwise size below which the beta=2 objective materializes X - HW
_DENSE_ERR_ELEMS = 1 << 22


class SolverTelemetry(NamedTuple):
    """Per-lane record of one batch solve (numpy), the fields of the JAX
    package's ``SolverTelemetry``. ``trace``: ``(R, evaluations)``
    objectives at every ``EVAL_EVERY``-th iteration, NaN once the lane has
    stopped. ``iters``: iterations the lane ran. ``nonfinite``: an
    evaluated objective (or the final one) was inf/NaN. ``inner_iters``:
    inner H updates (amu and dna only, else None). ``dna_fallback``: the
    mean fraction of rows (and, dense, columns) that took the MU fallback
    over the lane's iterations (dna only, else None)."""

    trace: np.ndarray
    iters: np.ndarray
    nonfinite: np.ndarray
    inner_iters: np.ndarray | None = None
    dna_fallback: np.ndarray | None = None


def lane_health(errs, nonfinite=None, spectra=None) -> np.ndarray:
    """Per-lane health (True = finite final objective) — computed on the
    host from the solver's outputs. ``nonfinite``: a
    :class:`SolverTelemetry` latch array, folding in a lane whose objective
    went nonfinite and recovered; ``spectra``: the stacked factors about
    to be written, which must be finite too."""
    errs = np.asarray(errs, dtype=np.float64).reshape(-1)
    health = np.isfinite(errs)
    if nonfinite is not None:
        health = health & ~np.asarray(nonfinite).astype(bool).reshape(-1)
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


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def _beta_div_dense(X, WH, beta: float):
    """Per-lane beta-divergence sum for a materialized ``WH (R, n, g)``:
    the cancellation-safe two-regime terms for KL and IS (zero counts
    EPS-floored), the plain formula for any other beta."""
    if beta == 1.0:
        per_elem = torch.where(
            X > 0, kl_nz_term(torch.clamp_min(X, EPS),
                              torch.clamp_min(WH, EPS)), WH)
        return per_elem.sum(dim=(1, 2))
    if beta == 0.0:
        return is_per_elem(torch.clamp_min(X, EPS),
                           torch.clamp_min(WH, EPS)).sum(dim=(1, 2))
    if beta == 2.0:
        return 0.5 * ((X - WH) ** 2).sum(dim=(1, 2))
    Xs, WHs, b = torch.clamp_min(X, EPS), torch.clamp_min(WH, EPS), beta
    return ((Xs ** b + (b - 1.0) * WHs ** b - b * Xs * WHs ** (b - 1.0))
            / (b * (b - 1.0))).sum(dim=(1, 2))


def beta_divergence(X, H, W, beta: float = 2.0):
    """``D_beta(X || HW)`` per replicate, ``(R,)`` f32. ``X`` may be an
    :class:`EllMatrix` for beta in {1, 0}: KL's nonzero terms run in the
    ``beta_err_partials`` kernel on the card, IS is the dense-WH hybrid
    (``ops/sparse.py:ell_beta_err``). JAX's one-replicate call (``H (n,
    k)``, ``W (k, g)``) returns a 0-d tensor."""
    if _one_replicate(H, W):
        return beta_divergence(X, H[None], W[None], beta)[0]
    if isinstance(X, EllMatrix):
        if beta == 1.0:
            return kl_ell.kl_beta_err(X, H, W)
        return ell_beta_err(X, H, W, beta)
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


_bf16_ratio_announced = False
_bf16_announce_lock = threading.Lock()


def resolve_bf16_ratio(beta: float, mode: str, override=None) -> bool:
    """The bf16 ratio chain is on for online KL/IS sweeps, off elsewhere
    (the batch solver keeps strict f32). ``CNMF_TPU_BF16_RATIO=0`` opts
    out; an explicit ``override`` wins over the knob. The first activation
    in a process is announced on stdout, since the chain changes
    per-replicate numerics against a strict-f32 run."""
    if override is not None:
        return bool(override)
    active = (beta in (1.0, 0.0) and mode == "online"
              and env_flag("CNMF_TPU_BF16_RATIO", True))
    if active:
        global _bf16_ratio_announced
        with _bf16_announce_lock:
            first = not _bf16_ratio_announced
            _bf16_ratio_announced = True
        if first:
            print("cnmf: bf16 ratio chain active for online KL/IS updates "
                  "(per-seed objectives within ~2-5% of strict f32; set "
                  "CNMF_TPU_BF16_RATIO=0 for f32-parity runs).", flush=True)
    return active


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


def _apply_rate_sketched(W, numer, denom, l1, l2):
    """MU rate from subsampled W statistics (the sketch recipe): an entry
    whose sampled numerator is exactly 0 (no sampled nonzero in its
    column) keeps its value instead of being multiplied by zero, since
    exact zeros are absorbing under MU; a truly dead entry still decays
    through the interleaved exact updates."""
    return torch.where(numer > 0.0, _apply_rate(W, numer, denom, l1, l2), W)


def _sketch_rows(step: int, m: int, n: int, stream: int, rows, device):
    """The ``m`` row indices in ``[0, n)`` of sketched W update number
    ``step``: ``rows[step]`` when the caller gave a table (the parity tests
    feed the JAX package's draws), else a CPU ``torch.Generator`` seeded
    from ``(stream, step)`` (stream 0 the batch solver's iterations, 1 the
    online solver's ``pass * chunks + chunk``), so every run and device
    draws the same rows."""
    if rows is not None:
        idx = torch.as_tensor(np.asarray(rows[step])).long()
    else:
        gen = torch.Generator().manual_seed((int(stream) << 32) + int(step))
        idx = torch.randint(0, int(n), (int(m),), generator=gen)
    with host_read():   # the draws are made on the host, then uploaded
        return idx.to(device)


def _sketched_w_update(X, H, W, idx, l1, l2, n_total):
    """One sketched KL W update from the rows ``idx``: the ELL statistics
    through ``kl_ell.kl_w_stats_rows`` (the ``w_numer`` kernel on the
    card), the dense ones from the gathered rows; the penalties scale with
    the sampled fraction, as the JAX package scales them."""
    if isinstance(X, EllMatrix):
        numer, denom = kl_ell.kl_w_stats_rows(X, H, W, idx)
    else:
        Hs = H[:, idx]
        numer = Hs.mT @ (X[idx] / torch.clamp_min(Hs @ W, EPS))
        denom = Hs.sum(1)[:, :, None].expand(W.shape)
    sc = idx.numel() / n_total
    return _apply_rate_sketched(W, numer, denom, l1 * sc, l2 * sc)


def _bf16_eps(t):
    # a fill, not torch.tensor: a scalar copied from the host syncs
    return torch.full((), EPS, dtype=torch.bfloat16, device=t.device)


def _update_H(X, H, W, beta: float, l1: float, l2: float,
              bf16_ratio: bool = False, w_colsum=None):
    """One MU step of the usages. ``X`` is a dense ``(n, g)`` tensor or an
    :class:`EllMatrix` (beta in {1, 0}); bf16 mode expects ``X`` already
    cast (the solvers cast once per chunk). ``w_colsum`` (dense beta=1):
    the resident ``W.sum(-1)`` of a fixed W (the serving reference), the
    same reduction this step would run, so the same bits."""
    if isinstance(X, EllMatrix):
        if beta == 1.0:
            numer, denom = kl_ell.kl_h_stats(X, H, W, bf16_ratio)
        elif beta == 0.0:
            numer, denom = ell_is_h_stats(X, H, W, bf16_ratio)
        else:
            raise NotImplementedError(
                f"ELL updates implement beta in {{1, 0}}, got {beta}")
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
        colsum = W.sum(-1) if w_colsum is None else w_colsum
        denom = colsum[:, None, :].expand(H.shape)
    elif beta == 0.0 and bf16_ratio:
        wb = W.to(torch.bfloat16)
        wh = H.to(torch.bfloat16) @ wb
        inv = 1.0 / torch.maximum(wh, _bf16_eps(wh))
        numer = (X.to(torch.bfloat16) * inv * inv).float() @ wb.float().mT
        denom = inv.float() @ wb.float().mT
    elif beta == 0.0:
        WH = torch.clamp_min(H @ W, EPS)
        numer = (X / (WH * WH)) @ W.mT
        denom = (1.0 / WH) @ W.mT
    else:
        WH = torch.clamp_min(H @ W, EPS)
        numer = (X * WH ** (beta - 2.0)) @ W.mT
        denom = (WH ** (beta - 1.0)) @ W.mT
    return _apply_rate(H, numer, denom, l1, l2, gamma=mu_gamma(beta))


def _update_W(X, H, W, beta: float, l1: float, l2: float,
              bf16_ratio: bool = False):
    """One MU step of the spectra (same conventions as :func:`_update_H`;
    the ELL kernels cast f32 values to bf16 themselves)."""
    if isinstance(X, EllMatrix):
        if beta == 1.0:
            numer, denom = kl_ell.kl_w_stats(X, H, W, bf16_ratio)
        elif beta == 0.0:
            numer, denom = ell_is_w_stats(X, H, W, bf16_ratio)
        else:
            raise NotImplementedError(
                f"ELL updates implement beta in {{1, 0}}, got {beta}")
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
    elif beta == 0.0 and bf16_ratio:
        hb = H.to(torch.bfloat16)
        wh = hb @ W.to(torch.bfloat16)
        inv = 1.0 / torch.maximum(wh, _bf16_eps(wh))
        numer = hb.float().mT @ (X.to(torch.bfloat16) * inv * inv).float()
        denom = hb.float().mT @ inv.float()
    elif beta == 0.0:
        WH = torch.clamp_min(H @ W, EPS)
        numer = H.mT @ (X / (WH * WH))
        denom = H.mT @ (1.0 / WH)
    else:
        WH = torch.clamp_min(H @ W, EPS)
        numer = H.mT @ (X * WH ** (beta - 2.0))
        denom = H.mT @ (WH ** (beta - 1.0))
    return _apply_rate(W, numer, denom, l1, l2, gamma=mu_gamma(beta))


# ---------------------------------------------------------------------------
# Diagonalized Newton (beta=1) steps — the dna recipe (arXiv:1301.3389)
# ---------------------------------------------------------------------------

def _kl_row_obj(X, C, W, l1, l2):
    """Per-row KL objective ``(R, n)`` of candidate usages ``C`` against
    fixed ``W``, up to X-only constants (equal across candidates):
    ``C @ W.sum(genes) - sum_g X log(max(CW, EPS))`` plus the penalties.
    Rows of D_KL(X || CW) decouple for fixed W, so the per-row argmin over
    candidates minimizes the objective. An ELL ``X`` takes the log term on
    its stored nonzeros (``wh_at_nz`` on the card). The linear term is an
    elementwise product and a last-axis sum, not a batched matvec, so a
    lane's objective (and its row choices) do not depend on how many lanes
    share the call."""
    obj = (C * W.sum(-1)[:, None, :]).sum(-1)
    if isinstance(X, EllMatrix):
        wh = kl_ell.kl_wh_at_nz(X, C, W)
        obj = obj - (X.vals * torch.log(torch.clamp_min(wh, EPS))).sum(-1)
    else:
        obj = obj - (X * torch.log(torch.clamp_min(C @ W, EPS))).sum(-1)
    if l1:
        obj = obj + l1 * C.sum(-1)
    if l2:
        obj = obj + 0.5 * l2 * (C * C).sum(-1)
    return obj


def _kl_col_obj(X, H, C, l1, l2):
    """Per-column analog ``(R, g)`` of :func:`_kl_row_obj` for candidate
    spectra ``C`` against fixed ``H`` (dense ``X``)."""
    obj = (H.sum(1)[:, :, None] * C).sum(1) \
        - (X * torch.log(torch.clamp_min(H @ C, EPS))).sum(1)
    if l1:
        obj = obj + l1 * C.sum(1)
    if l2:
        obj = obj + 0.5 * l2 * (C * C).sum(1)
    return obj


def _dna_h_step(X, H, W, l1, l2):
    """One Diagonalized-Newton KL H step with the per-row MU fallback.

    Both candidates come from one statistics pass (``h_newton_stats`` on
    the card for an ELL ``X``): the MU update, and the Newton update
    ``max(H - grad / hess, 0)`` with ``grad = W.sum(genes) - numer (+reg)``
    and the diagonal Hessian ``hess`` (+l2). A zero-padded component has
    ``grad = hess = 0`` and stays exactly zero. Each row keeps the
    candidate with the smaller row objective, so the composite is monotone
    like MU. Strict f32. Returns ``(H_new, fallback_fraction (R,))``."""
    s = W.sum(-1)[:, None, :]
    if isinstance(X, EllMatrix):
        numer, denom, hess = kl_ell.kl_h_newton_stats(X, H, W)
    else:
        WH = torch.clamp_min(H @ W, EPS)
        ratio = X / WH
        numer = ratio @ W.mT
        hess = (ratio / WH) @ (W * W).mT
        denom = s.expand(H.shape)
    H_mu = _apply_rate(H, numer, denom, l1, l2)
    grad = s - numer + l1 + l2 * H
    H_nt = torch.clamp_min(H - grad / torch.clamp_min(hess + l2, EPS), 0.0)
    take_nt = (_kl_row_obj(X, H_nt, W, l1, l2)
               < _kl_row_obj(X, H_mu, W, l1, l2))[..., None]
    return (torch.where(take_nt, H_nt, H_mu),
            1.0 - take_nt.float().mean(dim=(1, 2)))


def _dna_w_step(X, H, W, l1, l2):
    """Per-column Diagonalized-Newton KL W step with the MU fallback, the
    transpose of :func:`_dna_h_step` (dense ``X`` only: the ELL batch
    recipe keeps the exact MU W step). Returns ``(W_new, fallback_fraction
    (R,))``."""
    WH = torch.clamp_min(H @ W, EPS)
    ratio = X / WH
    numer = H.mT @ ratio
    s = H.sum(1)[:, :, None]
    W_mu = _apply_rate(W, numer, s.expand(W.shape), l1, l2)
    hess = (H * H).mT @ (ratio / WH)
    grad = s - numer + l1 + l2 * W
    W_nt = torch.clamp_min(W - grad / torch.clamp_min(hess + l2, EPS), 0.0)
    take_nt = (_kl_col_obj(X, H, W_nt, l1, l2)
               < _kl_col_obj(X, H, W_mu, l1, l2))[:, None, :]
    return (torch.where(take_nt, W_nt, W_mu),
            1.0 - take_nt.float().mean(dim=(1, 2)))


# ---------------------------------------------------------------------------
# masked loops
# ---------------------------------------------------------------------------

def _rel_change(new, old):
    return (torch.linalg.vector_norm(new - old, dim=(1, 2))
            / (torch.linalg.vector_norm(old, dim=(1, 2)) + EPS))


def _host_any(mask) -> bool:
    """``mask.any()`` read on the host: a chosen read, the loops' only
    question to the card between objective evaluations."""
    with host_read():
        return bool(mask.any())


def _lane_tensor(v, R, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((R,), float(v), dtype=torch.float32, device=device)


def _masked_loop(M, step, max_iter: int, tol, active,
                 return_count: bool = False, return_resid: bool = False):
    """Iterate ``M <- step(M)`` per lane until the lane's relative change
    drops below ``tol`` or it has run ``max_iter`` steps (the semantics of
    the JAX ``while_loop``s under ``vmap``); with ``return_count`` also
    the steps each lane took, ``(R,)`` int32; with ``return_resid``
    (instead) each lane's relative change at its last step, ``(R,)`` f32
    (inf for a lane that took none), the JAX loop's final ``rel``."""
    R = M.shape[0]
    M = M.contiguous()      # a chunk's block of (R, C, chunk, k) is strided
    tol = _lane_tensor(tol, R, M.device)
    active = (torch.ones(R, dtype=torch.bool, device=M.device)
              if active is None else active.clone())
    it = torch.zeros(R, dtype=torch.int32, device=M.device)
    resid = (torch.full((R,), float("inf"), device=M.device)
             if return_resid else None)
    steps = 0
    while steps < max_iter:
        M_new = step(M)
        rel = _rel_change(M_new, M)
        M = torch.where(active[:, None, None], M_new, M)
        if return_resid:
            resid = torch.where(active, rel, resid)
        it = it + active.to(torch.int32)
        active = active & (it < max_iter) & (rel >= tol)
        steps += 1
        if steps % EVAL_EVERY == 0 and not _host_any(active):
            break
    if return_resid:
        return M, resid
    return (M, it) if return_count else M


def _chunk_h_solve(x, h, W, WWT, beta, l1, l2, max_iter, h_tol,
                   bf16_ratio: bool = False, active=None, x_cast=None,
                   kl_newton: bool = False, row_block: int = 0,
                   w_colsum=None, return_resid: bool = False):
    """Inner MU loop on one chunk's usage block with W fixed; for beta=2
    the numerator ``x @ W.T`` is precomputed once. ``kl_newton`` (beta=1,
    the dna recipe): each inner step is a Diagonalized-Newton H step with
    the per-row MU fallback (:func:`_dna_h_step`), strict f32.

    ``row_block`` (a dense ``x`` with beta != 2): each step runs over row
    blocks of at most this many rows, so its ``(rows, genes)`` temporaries
    (WH, the ratio) stay block-sized; the rows are independent and the
    stopping rule still reads the whole block.

    The serving program's two extras: ``w_colsum`` (dense beta=1) is the
    resident ``W.sum(-1)`` the MU denominator would compute each step, and
    ``return_resid`` returns ``(h, rel)`` with each lane's last relative
    change, the per-lane health signal (a nonfinite lane stops on its
    first NaN comparison with ``rel`` nonfinite)."""
    if kl_newton and beta == 1.0:
        xs = x

        def step_on(xb, hh):
            return _dna_h_step(xb, hh, W, l1, l2)[0]
    elif beta == 2.0:
        numer0 = x @ W.mT
        numer0 = torch.clamp_min(numer0 - l1, 0.0) if l1 else numer0

        def step(hh):
            denom = hh @ WWT
            denom = denom + l2 * hh if l2 else denom
            rate = torch.where(denom < EPS, torch.zeros_like(denom),
                               numer0 / torch.clamp_min(denom, EPS))
            return hh * rate
        return _masked_loop(h, step, max_iter, h_tol, active,
                            return_resid=return_resid)
    else:
        bf16 = bool(bf16_ratio) and beta in (1.0, 0.0)
        xs = _cast_x(x, bf16) if x_cast is None else x_cast

        def step_on(xb, hh):
            return _update_H(xb, hh, W, beta, l1, l2, bf16_ratio=bf16,
                             w_colsum=w_colsum)
    n = int(xs.shape[-2]) if not isinstance(xs, EllMatrix) else 0
    if row_block and n > row_block:
        spans = _row_spans(n, row_block)

        def step(hh):
            return torch.cat([step_on(xs[..., a:b, :], hh[:, a:b])
                              for a, b in spans], dim=1)
    else:
        def step(hh):
            return step_on(xs, hh)
    return _masked_loop(h, step, max_iter, h_tol, active,
                        return_resid=return_resid)


def _row_spans(n: int, rows: int):
    """``[lo, hi)`` bounds of consecutive blocks of ``rows`` rows."""
    return [(a, min(a + rows, n)) for a in range(0, n, rows)]


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


def _solve_w_from_stats_hals(W, A, B, l1_W, l2_W, max_iter, tol, active):
    """HALS analog of :func:`_solve_w_from_stats`: row sweeps of W from the
    pass statistics ``A = H^T X``, ``B = H^T H`` alone."""
    return _masked_loop(
        W, lambda M: _hals_sweep(M.mT, B, A.mT, l1_W, l2_W).mT, max_iter,
        tol, active)


def _chunk_h_hals_solve(x, h, W, WWT, l1, l2, max_iter, h_tol, active):
    """HALS analog of :func:`_chunk_h_solve` (Frobenius only): column
    sweeps of one chunk's usage block with W fixed, per lane until its
    relative change drops below ``h_tol`` or ``max_iter``."""
    XWt = x @ W.mT
    return _masked_loop(h, lambda hh: _hals_sweep(hh, WWT, XWt, l1, l2),
                        max_iter, h_tol, active)


def _chunk(Xc, c):
    return Xc.chunk(c) if isinstance(Xc, EllMatrix) else Xc[c]


def _hals_sweep(M, G, C, l1, l2):
    """One HALS sweep over the k columns of ``M (R, m, k)`` against the
    Gram ``G (R, k, k)`` and target ``C (R, m, k)``, columns in order 0..k-1:
    ``M[..., j] <- max((C[..., j] - M G[:, j] + G[j, j] M[..., j] - l1) /
    (G[j, j] + l2 + EPS), 0)``. H sweeps directly (against ``W W^T`` and
    ``X W^T``), W through its transpose (against ``H^T H`` and ``(H^T
    X)^T``). Returns a new tensor; each column is written in place on this
    sweep's own copy."""
    M = M.clone()
    for j in range(M.shape[-1]):
        g = G[:, :, j]
        gjj = g[:, j]
        numer = (C[..., j] - (M @ g[:, :, None])[..., 0]
                 + gjj[:, None] * M[..., j] - l1)
        M[..., j] = torch.clamp_min(numer / (gjj + l2 + EPS)[:, None], 0.0)
    return M


def _solo(solver, call: dict, h: str, w: str, sinks=("trace",)):
    """The JAX package's one-replicate call of a batched solver: ``call``
    (the solver's arguments by name) with a replicate axis of 1 added to
    the factors ``call[h]`` and ``call[w]``, solved, and lane 0 returned
    (the batched call's bits at R=1); each list named in ``sinks`` receives
    lane 0 of what the solve appended to it."""
    call = dict(call)
    call[h], call[w] = call[h][None], call[w][None]
    lists = {s: call[s] for s in sinks if call[s] is not None}
    for s in lists:
        call[s] = []
    out = solver(**call)
    for s, sink in lists.items():
        sink.extend(_lane0(v) for v in call[s])
    return _lane0(out)


def _batch_loop(X, H0, W0, beta, tol, max_iter, step, trace,
                with_inner=False, with_fallback=False, errs=None,
                select=None):
    """The batch solvers' outer loop: ``step(H, W, active) -> (H_new,
    W_new, inner updates (R,) | 1, fallback (R,) | None)`` until each
    lane's relative objective decrease over an ``EVAL_EVERY``-iteration
    window falls below ``tol``, or ``max_iter``. A per-lane ``active``
    latch holds a stopped lane's state while the others go on (each lane's
    result is its solo solve); the host reads ``active.any()`` once per
    objective evaluation. ``errs(H, W) -> (R,)`` gives the lanes'
    objectives (default: :func:`beta_divergence` of ``(R, n, k)``, ``(R,
    k, g)`` stacks) and ``select(active, (H_new, W_new), (H, W)) -> (H,
    W)`` keeps the active lanes' new state (default: by leading-axis
    lane), so a solver whose state packs several lanes into one stack
    reuses the loop. Returns ``(H, W, err (R,))``, ``err`` the exact
    objective of the returned pair; ``trace`` receives one
    :class:`SolverTelemetry`."""
    if errs is None:
        def errs(H, W):
            return beta_divergence(X, H, W, beta=beta)
    if select is None:
        def select(active, new, old):
            mask = active[:, None, None]
            return tuple(torch.where(mask, a, b) for a, b in zip(new, old))
    H, W = H0.contiguous(), W0.contiguous()
    err0 = errs(H, W)
    R = err0.shape[0]
    dev = err0.device
    err_prev, err = err0, err0

    def active_of(err_prev, err, it):
        not_converged = (err_prev - err) / torch.clamp_min(err0, EPS) >= tol
        return (not_converged | (it < EVAL_EVERY)) & (it < max_iter)

    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    iters, inner = zeros, zeros
    fb_sum = torch.zeros(R, dtype=torch.float32, device=dev)
    nonfinite = ~torch.isfinite(err0)
    evals = []
    active = torch.full((R,), max_iter > 0, dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter:
        H_new, W_new, inner_n, fb = step(H, W, active)
        H, W = select(active, (H_new, W_new), (H, W))
        on = active.to(torch.int32)
        iters = iters + on
        inner = inner + on * inner_n
        if fb is not None:
            fb_sum = fb_sum + fb * active
        it += 1
        if it % EVAL_EVERY == 0:
            e = errs(H, W)
            err_prev = torch.where(active, err, err_prev)
            err = torch.where(active, e, err)
            nonfinite = nonfinite | (active & ~torch.isfinite(e))
            evals.append(torch.where(active, e, torch.full_like(e, np.nan)))
            active = active & active_of(err_prev, err, it)
            if not _host_any(active):
                break
    err = errs(H, W)
    if trace is not None:
        tr = (torch.stack(evals, dim=1) if evals
              else torch.zeros((R, 0), device=dev))
        with host_read():
            trace.append(SolverTelemetry(
                trace=tr.cpu().numpy(), iters=iters.cpu().numpy(),
                nonfinite=(nonfinite | ~torch.isfinite(err)).cpu().numpy(),
                inner_iters=inner.cpu().numpy() if with_inner else None,
                dna_fallback=((fb_sum / torch.clamp_min(iters.float(), 1.0))
                              .cpu().numpy() if with_fallback else None)))
    return H, W, err


def nmf_fit_batch(X, H0, W0, beta: float = 2.0, tol: float = 1e-4,
                  max_iter: int = 200, l1_H: float = 0.0, l2_H: float = 0.0,
                  l1_W: float = 0.0, l2_W: float = 0.0,
                  update_W_flag: bool = True,
                  inner_repeats: int = 1, kl_newton: bool = False,
                  trace: list | None = None, sketch_dim: int = 0,
                  sketch_exact_every: int = 1, sketch_rows=None):
    """Alternating MU updates of ``R`` replicates at once (:func:`_batch_loop`
    stops each lane as its solo JAX ``while_loop`` would).

    ``X``: a dense ``(n, g)`` tensor or an unchunked :class:`EllMatrix`
    with its transpose index set (beta in {1, 0}), shared by every lane;
    ``H0 (R, n, k)``, ``W0 (R, k, g)``. Returns ``(H, W, err (R,))``;
    ``trace`` receives one :class:`SolverTelemetry`. ``update_W_flag=False``
    keeps ``W0`` fixed (the returned W is ``W0``'s values) and solves H
    alone, under the same stopping rule.

    Recipes: ``inner_repeats > 1`` (amu) runs up to that many H updates
    per W update, each lane leaving early once its relative H change falls
    below ``INNER_STAG_TOL``; ``kl_newton`` (dna, beta=1) runs
    :func:`_dna_h_step` and, on dense ``X``, :func:`_dna_w_step` (an ELL
    ``X`` keeps the exact MU W step). ELL statistics are strict f32.

    The sketch recipe (``sketch_dim > 0``, beta=1): the H updates stay
    exact, and each W update runs from a ``sketch_dim``-row subsample of
    ``X`` (:func:`_sketch_rows`, shared by every lane; ``sketch_rows``, a
    ``(iterations, m)`` table, replaces the draws), except at iteration 0,
    every ``sketch_exact_every``-th iteration and every iteration that
    feeds an objective evaluation, which run the exact update, so the
    stopping rule compares exactly updated states.

    The solve keeps the dtype of its operands: f64 ``X``, ``H0`` and
    ``W0`` (dense) run the whole solve in f64.

    JAX's one-replicate call, ``H0 (n, k)`` and ``W0 (k, g)``, solves at
    R=1 and returns ``(H (n, k), W (k, g), err ())``; ``trace`` then
    receives that lane's record.
    """
    if _one_replicate(H0, W0):
        # first, so locals() is exactly the call's arguments
        return _solo(nmf_fit_batch, locals(), "H0", "W0")
    inner_repeats = int(inner_repeats)
    sketch_dim = int(sketch_dim)
    if kl_newton and beta != 1.0:
        raise ValueError(
            f"kl_newton is the beta=1 (KL) Newton recipe, got beta={beta}")
    if kl_newton and inner_repeats != 1:
        raise ValueError("kl_newton and inner_repeats>1 are exclusive "
                         "recipes (dna vs amu)")
    ell = isinstance(X, EllMatrix)
    n_total = int(X.vals.shape[0] if ell else X.shape[0])
    if sketch_dim:
        if beta != 1.0:
            raise ValueError(
                f"sketch_dim is the beta=1 (KL) sketch recipe's knob, "
                f"got beta={beta}")
        if kl_newton or inner_repeats != 1:
            raise ValueError("the sketch recipe is exclusive with the "
                             "dna/amu recipes")
        sketch_dim = min(sketch_dim, n_total)
    it_w = [0]      # the outer iteration of the coming W update

    def h_step(H, W, active):
        """``(H_new, inner updates (R,) | 1, fallback (R,) | None)``."""
        if kl_newton:
            H_new, fb = _dna_h_step(X, H, W, l1_H, l2_H)
            return H_new, 1, fb
        if inner_repeats <= 1:
            return _update_H(X, H, W, beta, l1_H, l2_H), 1, None
        if beta == 2.0 and not ell:
            numer0 = X @ W.mT
            WWT = W @ W.mT

            def one(h):
                return _apply_rate(h, numer0, h @ WWT, l1_H, l2_H)
        else:
            def one(h):
                return _update_H(X, h, W, beta, l1_H, l2_H)
        return (*_masked_loop(H, one, inner_repeats, INNER_STAG_TOL, active,
                              return_count=True), None)

    def step(H, W, active):
        H_new, inner_n, fb = h_step(H, W, active)
        it = it_w[0]
        it_w[0] += 1
        if not update_W_flag:
            W_new = W
        elif kl_newton and not ell:
            W_new, fb_w = _dna_w_step(X, H_new, W, l1_W, l2_W)
            fb = 0.5 * (fb + fb_w)
        elif (sketch_dim and it % max(int(sketch_exact_every), 1) != 0
              and (it + 1) % EVAL_EVERY != 0):
            idx = _sketch_rows(it, sketch_dim, n_total, 0, sketch_rows,
                               H.device)
            W_new = _sketched_w_update(X, H_new, W, idx, l1_W, l2_W,
                                       n_total)
        else:
            W_new = _update_W(X, H_new, W, beta, l1_W, l2_W)
        return H_new, W_new, inner_n, fb

    return _batch_loop(X, H0, W0, beta, tol, max_iter, step, trace,
                       with_inner=kl_newton or inner_repeats > 1,
                       with_fallback=kl_newton)


def nmf_fit_batch_hals(X, H0, W0, tol: float = 1e-4, max_iter: int = 200,
                       l1_H: float = 0.0, l2_H: float = 0.0,
                       l1_W: float = 0.0, l2_W: float = 0.0,
                       trace: list | None = None):
    """Hierarchical ALS (Cichocki & Phan 2009) for the Frobenius objective,
    ``R`` replicates at once: each iteration one :func:`_hals_sweep` of H
    (against ``W W^T``, ``X W^T``) then one of W (against ``H^T H``, ``(H^T
    X)^T``). Dense ``X``; the stopping rule, the per-lane latch and the
    telemetry are :func:`nmf_fit_batch`'s (one sweep counts as one inner
    update). Returns ``(H, W, err (R,))``; JAX's one-replicate call as
    :func:`nmf_fit_batch`'s."""
    if _one_replicate(H0, W0):
        return _solo(nmf_fit_batch_hals, locals(), "H0", "W0")

    def step(H, W, active):
        H_new = _hals_sweep(H, W @ W.mT, X @ W.mT, l1_H, l2_H)
        W_new = _hals_sweep(W.mT, H_new.mT @ H_new, (H_new.mT @ X).mT,
                            l1_W, l2_W).mT
        return H_new, W_new, 1, None

    return _batch_loop(X, H0, W0, 2.0, tol, max_iter, step, trace,
                       with_inner=True)


# ---------------------------------------------------------------------------
# bundle-packed replicate batch solver (beta=2)
# ---------------------------------------------------------------------------

def bundle_width(k: int) -> int:
    """Replicates per bundle of the packed beta=2 batch solver: as many
    k-wide factor blocks as fit 128 columns (the JAX package's TPU lane
    width, kept as it is)."""
    return max(1, 128 // int(k))


def _bundle_mask(per_b: int, k: int, device=None):
    """``(per_b*k, per_b*k)`` block-diagonal 0/1 mask: the bundle Grams are
    computed at full width and their cross-replicate blocks masked to
    exact zeros."""
    eye = torch.eye(per_b, dtype=torch.float32, device=device)
    return eye.repeat_interleave(k, 0).repeat_interleave(k, 1)


def bundle_stacks(H, W, per_b: int):
    """``(R, n, k), (R, k, g) -> (B, n, per_b*k), (B, per_b*k, g)``; ``R``
    pads to a bundle multiple by tiling the real replicates (the padded
    lanes recompute real replicates and :func:`unbundle_stacks` drops
    them)."""
    R, n, k = H.shape
    g = W.shape[2]
    R_b = -(-R // per_b) * per_b
    if R_b > R:
        idx = torch.cat([torch.arange(R), torch.arange(R_b - R) % R]).to(
            H.device)
        H, W = H[idx], W[idx]
    B = R_b // per_b
    Hb = H.reshape(B, per_b, n, k).transpose(1, 2).reshape(B, n, per_b * k)
    return Hb, W.reshape(B, per_b * k, g)


def unbundle_stacks(Hb, Wb, R: int, k: int):
    """Inverse of :func:`bundle_stacks` (a permutation: values exact)."""
    B, n, w = Hb.shape
    per_b = w // k
    g = Wb.shape[2]
    H = Hb.reshape(B, n, per_b, k).transpose(1, 2).reshape(B * per_b, n, k)
    return H[:R], Wb.reshape(B * per_b, k, g)[:R]


def bundled_beta2_update(X, Hb, Wb, mask, l1_H: float, l2_H: float,
                         l1_W: float, l2_W: float):
    """One alternating beta=2 MU step of every bundled replicate: the
    numerators are single ``(n, g) x (g, w)``-class matmuls, the
    denominators go through masked bundle Grams whose cross-replicate terms
    are exact zeros, so each replicate gets its own update up to the
    matmuls' summation order."""
    numer = X @ Wb.mT
    denom = Hb @ ((Wb @ Wb.mT) * mask)
    Hb = _apply_rate(Hb, numer, denom, l1_H, l2_H)
    numer2 = Hb.mT @ X
    denom2 = ((Hb.mT @ Hb) * mask) @ Wb
    return Hb, _apply_rate(Wb, numer2, denom2, l1_W, l2_W)


def nmf_fit_batch_bundled(X, H0, W0, tol: float = 1e-4,
                          max_iter: int = 200, l1_H: float = 0.0,
                          l2_H: float = 0.0, l1_W: float = 0.0,
                          l2_W: float = 0.0, trace: list | None = None):
    """``R``-replicate beta=2 batch MU with bundle-packed contractions, in
    place of :func:`nmf_fit_batch` at beta=2 over dense ``X (n, g)``,
    ``H0 (R, n, k)``, ``W0 (R, k, g)``: the same stopping rule per
    replicate, a stopped replicate's columns frozen by selects, the host
    reading ``any(active)`` once per ``EVAL_EVERY`` iterations. Returns
    ``(H, W, errs (R,))``; ``trace`` receives one :class:`SolverTelemetry`
    (``trace``, ``iters``, ``nonfinite``)."""
    R, _, k = H0.shape
    per_b = bundle_width(k)
    Hb, Wb = bundle_stacks(H0, W0, per_b)
    B = Hb.shape[0]
    mask = _bundle_mask(per_b, k, H0.device)

    def errs(Hb, Wb):
        H, W = unbundle_stacks(Hb, Wb, B * per_b, k)
        return beta_divergence(X, H.contiguous(), W, beta=2.0)

    def select(active, new, old):
        cols = active.reshape(B, per_b).repeat_interleave(k, dim=1)
        return (torch.where(cols[:, None, :], new[0], old[0]),
                torch.where(cols[:, :, None], new[1], old[1]))

    def step(Hb, Wb, active):
        return (*bundled_beta2_update(X, Hb, Wb, mask, l1_H, l2_H, l1_W,
                                      l2_W), 1, None)

    lanes = [] if trace is not None else None
    Hb, Wb, err = _batch_loop(X, Hb, Wb, 2.0, tol, max_iter, step, lanes,
                              errs=errs, select=select)
    if trace is not None:   # drop the lanes that pad R to a bundle multiple
        tm = lanes[0]
        trace.append(tm._replace(trace=tm.trace[:R], iters=tm.iters[:R],
                                 nonfinite=tm.nonfinite[:R]))
    H, W = unbundle_stacks(Hb, Wb, R, k)
    return H.contiguous(), W.contiguous(), err[:R]


def nmf_fit_online(Xc, Hc0, W0, beta: float = 2.0, tol: float = 1e-4,
                   h_tol: float = 1e-3, chunk_max_iter: int = 1000,
                   n_passes: int = 20, l1_H: float = 0.0, l2_H: float = 0.0,
                   l1_W: float = 0.0, l2_W: float = 0.0,
                   h_tol_start: float | None = None,
                   bf16_ratio: bool = False, trace: list | None = None,
                   kl_newton: bool = False, algo: str = "mu",
                   sketch_dim: int = 0, sketch_exact_every: int = 1,
                   sketch_rows=None, lane_passes: list | None = None):
    """Streamed MU over pre-chunked inputs for ``R`` replicates at once.

    ``Xc``: ``(C, chunk, genes)`` dense tensor or a pre-chunked
    :class:`EllMatrix` (``ell_chunk_rows``), shared by every lane.
    ``Hc0``: ``(R, C, chunk, k)``; ``W0``: ``(R, k, g)``. Zero-padded rows
    are benign. Returns ``(Hc, W, err (R,))`` where ``err`` is the exact
    objective of the returned pair.

    beta=2: per pass every chunk's usage block is solved with W frozen
    while ``A = H^T X`` and ``B = H^T H`` accumulate; W is then solved
    from (A, B); ``algo="halsvar"`` runs both solves as HALS sweeps
    (:func:`_chunk_h_hals_solve`, :func:`_solve_w_from_stats_hals`).
    beta != 2: each chunk's usage block is solved, its f32 objective
    taken, then W takes one MU step from that chunk's statistics (the
    bf16 ratio chain with ``bf16_ratio``, beta in {1, 0}). Passes stop
    per lane on the relative objective decrease ``< tol`` (never while the
    coarse-to-fine inner tolerance is still above its floor) or at
    ``n_passes``.

    ``kl_newton`` (beta=1, the dna recipe): the chunk usage solves run
    Diagonalized-Newton steps with the per-row MU fallback; the chunk W
    steps stay MU, and the bf16 ratio chain is off (strict f32).

    The sketch recipe (``sketch_dim > 0``, beta=1, strict f32): the chunk
    usage solves and objectives stay exact, and each chunk's W step runs
    from a ``sketch_dim``-row subsample of that chunk (step number ``pass
    * chunks + chunk`` of :func:`_sketch_rows`; ``sketch_rows`` replaces
    the draws), except on the first and every ``sketch_exact_every``-th
    pass; only a pass of exact W steps may stop a lane.

    ``trace`` receives the ``(R,)`` objectives after every pass (a
    stopped lane repeats its last one); ``lane_passes`` receives, once,
    the ``(R,)`` passes each lane ran.

    JAX's one-replicate call, ``Hc0 (C, chunk, k)`` and ``W0 (k, g)``,
    solves at R=1 and returns ``(Hc (C, chunk, k), W (k, g), err ())``;
    ``trace`` and ``lane_passes`` then receive that lane's values.
    """
    if _one_replicate(Hc0, W0, extra=1):
        return _solo(nmf_fit_online, locals(), "Hc0", "W0",
                     ("trace", "lane_passes"))
    if kl_newton and beta != 1.0:
        raise ValueError(
            f"kl_newton is the beta=1 (KL) Newton recipe, got beta={beta}")
    sketch_dim = int(sketch_dim)
    E = max(int(sketch_exact_every), 1)
    if sketch_dim:
        if beta != 1.0:
            raise ValueError(
                f"sketch_dim is the beta=1 (KL) sketch recipe's knob, "
                f"got beta={beta}")
        if kl_newton:
            raise ValueError("the sketch recipe is exclusive with dna")
    if algo not in ("mu", "halsvar"):
        raise ValueError(f"unknown online algo {algo!r}")
    if algo == "halsvar" and beta != 2.0:
        raise ValueError("algo='halsvar' optimizes the Frobenius objective")
    bf16 = (bool(bf16_ratio) and beta in (1.0, 0.0) and not kl_newton
            and not sketch_dim)
    ell = isinstance(Xc, EllMatrix)
    R, C = Hc0.shape[0], Hc0.shape[1]
    dev = W0.device
    chunks = [_chunk(Xc, c) for c in range(C)]
    casts = [_cast_x(x, bf16) for x in chunks]
    chunk_rows = int(Hc0.shape[2])
    m_c = min(sketch_dim, chunk_rows)

    def h_tol_for(p):
        if h_tol_start is None:
            return torch.full((R,), float(h_tol), dtype=torch.float32,
                              device=dev)
        return torch.clamp_min(
            h_tol_start * torch.pow(0.5, p.to(torch.float32)),
            float(np.float32(h_tol)))

    def one_pass(Hc, W, p, active, pass_no):
        h_tol_p = h_tol_for(p)
        err = torch.zeros(R, dtype=torch.float32, device=dev)
        Hc = Hc.clone()
        if beta == 2.0:
            WWT = W @ W.mT
            A = torch.zeros_like(W)
            B = torch.zeros((R, W.shape[1], W.shape[1]), dtype=W.dtype,
                            device=dev)
            for c, x in enumerate(chunks):
                if algo == "halsvar":
                    h = _chunk_h_hals_solve(x, Hc[:, c], W, WWT, l1_H, l2_H,
                                            chunk_max_iter, h_tol_p, active)
                else:
                    h = _chunk_h_solve(x, Hc[:, c], W, WWT, beta, l1_H,
                                       l2_H, chunk_max_iter, h_tol_p,
                                       active=active)
                A = A + h.mT @ x
                B = B + h.mT @ h
                err = err + beta_divergence(x, h, W, beta=2.0)
                Hc[:, c] = h
            w_solve = (_solve_w_from_stats_hals if algo == "halsvar"
                       else _solve_w_from_stats)
            W_new = w_solve(W, A, B, l1_W, l2_W, chunk_max_iter, h_tol_p,
                            active)
            return Hc, torch.where(active[:, None, None], W_new, W), err
        for c, x in enumerate(chunks):
            h = _chunk_h_solve(x, Hc[:, c], W, None, beta, l1_H, l2_H,
                               chunk_max_iter, h_tol_p, bf16_ratio=bf16,
                               active=active, x_cast=casts[c],
                               kl_newton=kl_newton)
            # the objective stays f32 even when the updates run bf16
            if ell:
                err_c = beta_divergence(x, h, W, beta=beta)
            else:
                err_c = _beta_div_dense(x, torch.clamp_min(h @ W, EPS), beta)
            if sketch_dim and pass_no % E != 0:
                idx = _sketch_rows(pass_no * C + c, m_c, chunk_rows, 1,
                                   sketch_rows, dev)
                W_new = _sketched_w_update(x, h, W, idx, l1_W, l2_W,
                                           chunk_rows)
            else:
                W_new = _update_W(x, h, W, beta, l1_W, l2_W,
                                  bf16_ratio=bf16)
            W = torch.where(active[:, None, None], W_new, W)
            Hc[:, c] = h
            err = err + err_c
        return Hc, W, err

    all_on = torch.ones(R, dtype=torch.bool, device=dev)
    Hc, W, err0 = one_pass(Hc0, W0, torch.zeros(R, device=dev), all_on, 0)
    err_prev = err0 * (1.0 + 2.0 * tol) + 1.0
    err = err0
    it = torch.ones(R, dtype=torch.int32, device=dev)

    def active_of(err_prev, err, it):
        progressing = (err_prev - err) / torch.clamp_min(err0, EPS) >= tol
        keep = progressing
        if h_tol_start is not None:
            keep = keep | (h_tol_start * torch.pow(0.5, it.to(torch.float32))
                           > float(np.float32(h_tol)))
        if sketch_dim:
            # pass it-1 ran exact W steps iff (it-1) % E == 0: a sketched
            # pass's state never stops a lane
            keep = keep | ((it - 1) % E != 0)
        return (it < n_passes) & keep

    if trace is not None:
        with host_read():
            trace.append(err0.cpu().numpy())
    act = active_of(err_prev, err, it)
    pass_no = 1     # every active lane has run this many passes
    while _host_any(act):
        Hc, W, err_new = one_pass(Hc, W, it, act, pass_no)
        pass_no += 1
        err_prev = torch.where(act, err, err_prev)
        err = torch.where(act, err_new, err)
        it = it + act.to(torch.int32)
        act = act & active_of(err_prev, err, it)
        if trace is not None:
            with host_read():
                trace.append(err.cpu().numpy())
    if lane_passes is not None:
        with host_read():
            lane_passes.append(it.cpu().numpy())

    err = torch.zeros(R, dtype=torch.float32, device=dev)
    for c, x in enumerate(chunks):
        err = err + beta_divergence(x, Hc[:, c].contiguous(), W,
                                     beta=beta)
    return Hc, W, err


# ---------------------------------------------------------------------------
# initialization and the fixed-spectra usage refit
# ---------------------------------------------------------------------------

def sweep_x_mean(Xs, n: int, g: int) -> float:
    """The random init's scale ``mean(X)`` as a replicate sweep takes it:
    an f32 sum over the staged matrix on its device (dense, or an ELL
    encoding's stored values; padded rows add nothing) over ``n * g``."""
    return float((Xs.vals.sum() if isinstance(Xs, EllMatrix) else Xs.sum())
                 / (n * g))


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


def nndsvd_base(X, k: int):
    """The exact-zero nndsvd base (Boutsidis & Gallopoulos 2008) of a dense
    ``X (n, g)`` tensor: ``(H (n, k), W (k, g))`` in ``X``'s dtype and on
    its device, from ``torch.linalg.svd`` (the JAX package computes its
    SVD outside any Pallas kernel too)."""
    U, S, Vt = torch.linalg.svd(X, full_matrices=False)
    return _nndsvd_from_svd(U[:, :k], S[:k], Vt[:k, :], int(k))


def _nndsvd_from_svd(U, S, Vt, k: int):
    """Each singular pair after the first split into its positive and
    negative parts, the part with the larger norm product kept (a joint
    sign flip of ``(u, v)`` swaps the parts and the choice, so the base
    does not depend on the SVD's signs)."""
    def split_pair(j):
        u, v = U[:, j], Vt[j, :]
        up, un = torch.clamp_min(u, 0.0), torch.clamp_min(-u, 0.0)
        vp, vn = torch.clamp_min(v, 0.0), torch.clamp_min(-v, 0.0)
        n_up, n_un = torch.linalg.vector_norm(up), torch.linalg.vector_norm(un)
        n_vp, n_vn = torch.linalg.vector_norm(vp), torch.linalg.vector_norm(vn)
        termp, termn = n_up * n_vp, n_un * n_vn
        use_p = termp >= termn
        sigma = torch.where(use_p, termp, termn)
        hj = torch.where(use_p, up / torch.clamp_min(n_up, EPS),
                         un / torch.clamp_min(n_un, EPS))
        wj = torch.where(use_p, vp / torch.clamp_min(n_vp, EPS),
                         vn / torch.clamp_min(n_vn, EPS))
        scale = torch.sqrt(S[j] * sigma)
        return scale * hj, scale * wj

    cols = [torch.sqrt(S[0]) * U[:, 0].abs()]
    rows = [torch.sqrt(S[0]) * Vt[0, :].abs()]
    for j in range(1, k):
        hj, wj = split_pair(j)
        cols.append(hj)
        rows.append(wj)
    return torch.stack(cols, dim=1), torch.stack(rows, dim=0)


def gram_svd_base(X, k: int):
    """The truncated-SVD base of the gram-form nndsvd init, ``(U (n, k),
    S (k,), Vt (k, g))``, from the ``g x g`` gram ``X^T X`` and its
    eigendecomposition: the form that needs only the gram across row
    shards. Components past the numerical rank (``S <= 1e-6 S[0]``) get
    ``S = 0`` and a zero ``U`` column, so the fill takes over there."""
    G = X.mT @ X
    evals, evecs = torch.linalg.eigh(G)           # ascending
    S = torch.sqrt(torch.clamp_min(evals.flip(0)[:k], 0.0))
    V = evecs.flip(1)[:, :k]                      # (g, k)
    rank_ok = S > 1e-6 * torch.clamp_min(S[0], EPS)
    S = torch.where(rank_ok, S, torch.zeros_like(S))
    U = torch.where(rank_ok[None, :], (X @ V) / torch.clamp_min(S, EPS),
                    torch.zeros((), dtype=X.dtype, device=X.device))
    return U, S, V.mT


def nndsvd_init_gram(X, k: int, variant: str = "nndsvdar", seed: int = 0,
                     uniforms=None):
    """nndsvd init of a dense ``X`` tensor from its gram
    (:func:`gram_svd_base`), filled per :func:`nndsvd_fill` — the
    row-sharded solver's nndsvd."""
    U, S, Vt = gram_svd_base(X, int(k))
    H, W = _nndsvd_from_svd(U, S, Vt, int(k))
    return nndsvd_fill(H, W, float(X.mean()), variant, seed, uniforms)


def nndsvd_fill(H, W, x_mean: float, variant: str, seed: int = 0,
                uniforms=None):
    """Fill the base's exact zeros: ``nndsvd`` keeps them, ``nndsvda``
    puts ``mean(X)/100`` there, ``nndsvdar`` ``mean(X)/100 * uniform(0,
    1)`` with the uniforms drawn ``(n, k)`` then ``(k, g)`` from a CPU
    ``torch.Generator`` seeded with ``seed`` (``uniforms``: a pair of
    arrays of those shapes in their place; the parity tests feed the JAX
    package's draws)."""
    if variant == "nndsvd":
        return H, W
    fill = float(x_mean) / 100.0
    if variant == "nndsvda":
        return (torch.where(H == 0.0, fill, H),
                torch.where(W == 0.0, fill, W))
    if variant != "nndsvdar":
        raise ValueError(f"unknown nndsvd variant {variant!r}")
    if uniforms is None:
        gen = torch.Generator().manual_seed(int(seed))
        uH = torch.rand(tuple(H.shape), generator=gen, dtype=torch.float32)
        uW = torch.rand(tuple(W.shape), generator=gen, dtype=torch.float32)
    else:
        uH, uW = (torch.as_tensor(np.array(u)) for u in uniforms)
    uH = uH.to(device=H.device, dtype=H.dtype)
    uW = uW.to(device=W.device, dtype=W.dtype)
    return (torch.where(H == 0.0, fill * uH, H),
            torch.where(W == 0.0, fill * uW, W))


def nndsvd_init(X, k: int, variant: str = "nndsvd", seed: int = 0,
                uniforms=None):
    """Nonnegative double SVD init of a dense ``X`` tensor: the base of
    :func:`nndsvd_base` filled per :func:`nndsvd_fill`."""
    H, W = nndsvd_base(X, k)
    return nndsvd_fill(H, W, float(X.mean()), variant, seed, uniforms)


def init_factors(X, k: int, init: str, seed: int, x_mean=None,
                 uniforms=None):
    """``(H0, W0)`` for a dense ``X`` tensor under the reference's inits:
    ``random`` (:func:`random_init`), or the nndsvd family, where
    ``nndsvd`` maps to the seeded ``nndsvdar`` fill (exact zeros are
    absorbing under MU, and a deterministic fill would make every
    replicate of a sweep the same), which the batched sweep's inits give
    for the same seed (``parallel/replicates.py:stacked_inits``)."""
    n, g = X.shape
    if init == "random":
        if x_mean is None:
            x_mean = float(X.mean())
        return random_init(int(seed), n, g, k, x_mean, device=X.device)
    if init in ("nndsvd", "nndsvda", "nndsvdar"):
        variant = "nndsvdar" if init == "nndsvd" else init
        return nndsvd_init(X, k, variant, seed, uniforms)
    raise ValueError(f"unknown init {init!r}")


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
    if takes_ell_lane(X, beta):
        return csr_to_ell(X, transpose=False).to(device)
    return dense_on_device(X, device)


def takes_ell_lane(X, beta: float) -> bool:
    """The ELL lane rule for a host matrix solved row by row: ``X``
    scipy-sparse, beta in {1, 0}, under the dispatch rule (density <= 0.10,
    width <= genes/8; ``ops/sparse.py:resolve_sparse_beta``). A transposed
    solve asks it of ``X.T``."""
    if not sp.issparse(X):
        return False
    n, g = X.shape
    return bool(resolve_sparse_beta(float(beta), density=X.nnz / max(n * g, 1),
                                    width=ell_row_width(X), g=g))


def fit_h(X, W, H_init=None, chunk_size: int = 5000,
          chunk_max_iter: int = 200, h_tol: float = 0.05,
          l1_reg_H: float = 0.0, l2_reg_H: float = 0.0, beta: float = 2.0,
          device="cuda") -> np.ndarray:
    """Fit usages H for fixed spectra W: one pass over row chunks, an inner
    MU loop per chunk with relative-change tolerance ``h_tol``; uniform
    init (:func:`fit_h_default_init`) when ``H_init`` is None, else
    ``H_init`` clamped at zero. A scipy-sparse ``X`` with beta in {1, 0}
    under the ELL rule runs on the ELL statistics (f32; KL on the
    kernels). Returns numpy ``(n, k)``."""
    dev = resolve_device(device)
    beta = float(beta)
    if isinstance(X, EllMatrix) and beta not in (1.0, 0.0):
        raise ValueError(
            f"EllMatrix inputs require beta in {{1, 0}}, got {beta}")
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


def _fit_h_block(Xb, Hb0, W, beta, chunk_size, chunk_max_iter, h_tol,
                 l1_H, l2_H, device) -> np.ndarray:
    """One block of rows through :func:`fit_h`'s chunked fixed-W solve —
    the same zero-padding to a chunk multiple and the same per-chunk
    solve, so a slab-looped caller reproduces the resident refit chunk
    for chunk. ``Xb``: a dense host ``(rows, genes)`` block. Returns the
    block's usage rows as numpy ``(rows, k)``."""
    dev = resolve_device(device)
    rows = int(Xb.shape[0])
    X = torch.as_tensor(np.ascontiguousarray(Xb, dtype=np.float32)).to(dev)
    H = torch.as_tensor(np.ascontiguousarray(Hb0, dtype=np.float32)).to(dev)
    Wt = torch.as_tensor(np.ascontiguousarray(W, dtype=np.float32)).to(dev)
    Xc, Hc, _ = _chunk_rows(X, H, int(chunk_size))
    W1 = Wt[None]
    WWT = W1 @ W1.mT if float(beta) == 2.0 else None
    out = [_chunk_h_solve(Xc[c], Hc[:, c], W1, WWT, float(beta), float(l1_H),
                          float(l2_H), int(chunk_max_iter), float(h_tol))
           for c in range(Hc.shape[1])]
    return torch.cat(out, dim=1)[0, :rows].cpu().numpy()


def fit_h_slabbed(blocks, n: int, W, *, chunk_size: int = 5000,
                  chunk_max_iter: int = 200, h_tol: float = 0.05,
                  l1_reg_H: float = 0.0, l2_reg_H: float = 0.0,
                  beta: float = 2.0, collect=None,
                  device="cuda") -> np.ndarray:
    """:func:`fit_h` as a loop over row blocks: the host holds one block,
    never the cells x genes matrix (the streamed consensus refit).

    Bit for bit :func:`fit_h` on the assembled dense matrix when every
    block boundary is a multiple of the (clamped) chunk size: the default
    init is the same ``(n, k)`` draw (rows ``lo:hi`` of it are the
    block's), and chunks solve independently, so only the chunk partition,
    which this loop keeps, decides the result. A misaligned boundary
    raises. ``blocks``: an iterable of ``(lo, hi, X_block)`` with a dense
    ``(hi - lo, genes)`` block. ``collect(lo, hi, X_block, H_block)`` runs
    for each block before its buffers drop."""
    W = np.asarray(W, dtype=np.float32)
    k = int(W.shape[0])
    chunk_size = int(min(int(chunk_size), max(int(n), 1)))
    H0 = fit_h_default_init(int(n), k).numpy()
    out = np.zeros((int(n), k), np.float32)
    for lo, hi, Xb in blocks:
        lo, hi = int(lo), int(hi)
        if lo % chunk_size and lo < n:
            raise ValueError(
                f"block boundary {lo} is not a multiple of the chunk "
                f"size {chunk_size} — slab-looped fit_h is only "
                "bit-identical to the resident refit when the chunk "
                "partition is preserved")
        Hb = _fit_h_block(Xb, H0[lo:hi], W, beta, chunk_size,
                          chunk_max_iter, h_tol, l1_reg_H, l2_reg_H, device)
        out[lo:hi] = Hb
        if collect is not None:
            collect(lo, hi, Xb, Hb)
    return out


# ---------------------------------------------------------------------------
# run_nmf — the nmf-torch style entry point
# ---------------------------------------------------------------------------

def run_nmf_use_ell(X, beta: float, *, init: str = "random",
                    algo: str = "mu", fp_precision: str = "float") -> bool:
    """Does :func:`run_nmf` take the ELL lane for this input? A scipy-
    sparse ``X`` with beta in {1, 0}, the random init, ``algo='mu'``, f32,
    under the dispatch rule (density <= 0.10, width <= genes/8)."""
    return (init == "random" and algo == "mu" and fp_precision == "float"
            and takes_ell_lane(X, beta))


def run_nmf(X, n_components: int, init: str = "random",
            beta_loss="frobenius", algo: str = "mu", mode: str = "online",
            tol: float = 1e-4, n_passes: int | None = None,
            online_chunk_size: int = 5000, online_chunk_max_iter: int = 1000,
            batch_max_iter: int = 500, alpha_W: float = 0.0,
            l1_ratio_W: float = 0.0, alpha_H: float = 0.0,
            l1_ratio_H: float = 0.0, random_state: int = 0,
            n_jobs: int = -1, use_gpu: bool = False,
            fp_precision: str = "float", online_h_tol: float | None = None,
            recipe: SolverRecipe | None = None, x_mean: float | None = None,
            device="cuda"):
    """One NMF solve with the nmf-torch ``run_nmf`` keyword contract.

    Returns ``(H usages (n, k), W spectra (k, g), err)`` as numpy and a
    float. ``n_jobs`` and ``use_gpu`` are accepted and ignored; ``device``
    places the work. A scipy-sparse KL input under the dispatch rule runs
    on the ELL encoding (the CUDA kernels on the card; IS is the
    dense-WH hybrid): unchunked with its transpose index set in batch
    mode, in row chunks online. ``recipe``: an explicit
    :class:`SolverRecipe`, else resolved from the env knobs
    (``CNMF_TPU_ACCEL`` ``auto`` gives batch KL the dna recipe, batch IS
    amu); a caller-pinned ``hals`` recipe runs the ``halsvar`` lane.

    ``init``: ``random``, or the nndsvd family (:func:`init_factors`; the
    SVD needs the dense matrix, so those inits run the dense lane).
    ``fp_precision='double'`` runs the whole batch solve in f64 with plain
    updates (``mode='online'`` raises, as in the JAX package). Every beta,
    ``algo`` ``'mu'`` and ``'halsvar'`` (Frobenius), and the mu, amu, dna,
    hals and sketch recipes. ``x_mean``: the random init's scale; by
    default the host mean ``X.sum() / (n g)`` on the ELL lane and the
    device mean on the dense lane, as in the JAX package (factorize's
    sequential lane passes the batched lane's :func:`sweep_x_mean`).
    """
    dev = resolve_device(device)
    if fp_precision not in ("float", "double"):
        raise ValueError(
            f"fp_precision={fp_precision!r}: expected 'float' or 'double'")
    if fp_precision == "double" and mode != "batch":
        raise NotImplementedError(
            "fp_precision='double' is implemented for mode='batch'; the "
            "online solver is fp32 by contract")
    if algo not in ("mu", "halsvar"):
        raise NotImplementedError(
            f"algo={algo!r}: 'mu' (all beta losses, batch+online) and "
            "'halsvar' (frobenius, batch+online) are implemented")
    beta = beta_loss_to_float(beta_loss)
    if algo == "halsvar" and beta != 2.0:
        raise ValueError(
            "algo='halsvar' optimizes the Frobenius objective; use "
            "algo='mu' for kullback-leibler / itakura-saito")
    if mode not in ("batch", "online"):
        raise ValueError(f"unknown mode {mode!r}")
    online_h_tol, n_passes, h_tol_start = resolve_online_schedule(
        beta, online_h_tol, n_passes)
    use_ell = run_nmf_use_ell(X, beta, init=init, algo=algo,
                              fp_precision=fp_precision)
    if recipe is None:
        recipe = resolve_recipe(beta, mode, algo=algo, ell=use_ell)
    elif recipe.algo == "hals" and algo == "mu":
        if beta != 2.0:
            raise ValueError(
                "the hals recipe optimizes the Frobenius objective; use "
                "algo='mu' recipes for kullback-leibler / itakura-saito")
        algo = "halsvar"
    if (recipe.kl_newton or recipe.algo == "sketch") and beta != 1.0:
        raise ValueError(
            f"recipe {recipe.label!r} requires beta=1 (KL), got "
            f"beta_loss={beta_loss!r}")
    k = int(n_components)
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    n, g = X.shape
    chunk = int(min(online_chunk_size, n))
    seed = int(random_state) & 0x7FFFFFFF
    if fp_precision == "double":
        Xd = dense_on_device(X, dev).double()
        H0, W0 = init_factors(Xd, k, init, seed)
        H0, W0 = H0.double(), W0.double()
        batch_kw = dict(tol=float(tol), max_iter=int(batch_max_iter),
                        l1_H=l1_H, l2_H=l2_H, l1_W=l1_W, l2_W=l2_W)
        if algo == "halsvar":
            H, W, err = nmf_fit_batch_hals(Xd, H0, W0, **batch_kw)
        else:
            H, W, err = nmf_fit_batch(Xd, H0, W0, beta=beta, **batch_kw)
        return H.cpu().numpy(), W.cpu().numpy(), float(err)
    if use_ell:
        if mode == "online":
            Xs, pad = ell_chunk_rows(X, chunk)
        else:
            Xs = csr_to_ell(X)
        Xs = Xs.to(dev)
        if x_mean is None:
            x_mean = float(X.sum()) / (n * g)
        H0, W0 = random_init(seed, n, g, k, x_mean, device=dev)
    else:
        Xs = dense_on_device(X, dev)
        H0, W0 = init_factors(Xs, k, init, seed, x_mean=x_mean)
    sketch = dict(sketch_dim=int(recipe.sketch_dim),
                  sketch_exact_every=int(recipe.sketch_exact_every))
    if mode == "batch" and algo == "halsvar":
        H, W, err = nmf_fit_batch_hals(
            Xs, H0, W0, tol=float(tol), max_iter=int(batch_max_iter),
            l1_H=l1_H, l2_H=l2_H, l1_W=l1_W, l2_W=l2_W)
    elif mode == "batch":
        H, W, err = nmf_fit_batch(
            Xs, H0, W0, beta=beta, tol=float(tol),
            max_iter=int(batch_max_iter), l1_H=l1_H, l2_H=l2_H, l1_W=l1_W,
            l2_W=l2_W, inner_repeats=int(recipe.inner_repeats),
            kl_newton=bool(recipe.kl_newton), **sketch)
    else:
        if use_ell:
            Xc = Xs
            Hc = torch.nn.functional.pad(H0, (0, 0, 0, pad)).reshape(
                Xc.vals.shape[0], chunk, k)
        else:
            Xc, Hc, _ = _chunk_rows(Xs, H0, chunk)
            Hc = Hc[0]
        Hc, W, err = nmf_fit_online(
            Xc, Hc, W0, beta=beta, tol=float(tol),
            h_tol=float(online_h_tol),
            chunk_max_iter=int(online_chunk_max_iter),
            n_passes=int(n_passes), l1_H=l1_H, l2_H=l2_H, l1_W=l1_W,
            l2_W=l2_W, h_tol_start=h_tol_start,
            bf16_ratio=resolve_bf16_ratio(beta, mode),
            kl_newton=bool(recipe.kl_newton), algo=algo, **sketch)
        H = Hc.reshape(-1, k)[:n]
    return H.cpu().numpy(), W.cpu().numpy(), float(err)


# ---------------------------------------------------------------------------
# the dense lanes' analytic cost (obs/costmodel.py)
# ---------------------------------------------------------------------------

def dense_update_cost(n: int, g: int, k: int, beta: float = 2.0,
                      *, bf16_ratio: bool = False,
                      bundled: bool = False) -> dict:
    """Flops and bytes of ONE dense MU iteration (the H update and the W
    update) of the chains above, the JAX package's formula
    (``cnmf_torch_tpu/ops/nmf.py:dense_update_cost``) term for term: 2mnk
    flops a matmul and one flop an output element of an elementwise op;
    bytes are each unfused matmul's operands and output plus each fused
    elementwise chain's. ``bundled`` counts the useful per-replicate work
    only (the bundled solver's masked-Gram padding is overhead);
    ``bf16_ratio`` halves the X/WH/ratio traffic of the beta != 2 chains,
    flops unchanged. Host arithmetic only."""
    n, g, k = int(n), int(g), int(k)
    f = 4.0                      # f32 operand bytes
    fx = 2.0 if (bf16_ratio and beta != 2.0) else 4.0
    if beta == 2.0:
        # H: X@W.T + W@W.T + H@WWT + the rate chain; W: H.T@X + H.T@H +
        # HtH@W + the rate chain
        flops = (4 * n * g * k + 4 * n * k * k + 4 * g * k * k
                 + 3 * n * k + 3 * g * k)
        bytes_ = (
            (n * g + k * g + n * k) * f        # X @ W.T
            + (2 * k * g + k * k) * f          # W @ W.T
            + (n * k + k * k + n * k) * f      # H @ WWT
            + 4 * n * k * f                    # numer, denom, H -> H'
            + (n * g + n * k + k * g) * f      # H.T @ X
            + (2 * n * k + k * k) * f          # H.T @ H
            + (k * g + k * k + k * g) * f      # HtH @ W
            + 4 * k * g * f)
    elif beta == 1.0:
        # H: WH + ratio + R@W.T + the colsum denominator + rate; W mirrored
        flops = (8 * n * g * k + 4 * n * g + k * (g - 1) + (n - 1) * k
                 + 3 * n * k + 3 * k * g)
        bytes_ = (
            2 * ((n * k + k * g) * f + n * g * fx)   # H@W, both updates
            + 2 * 3 * n * g * fx                     # X/max(WH, eps)
            + (n * g * fx + k * g * f + n * k * f)   # R @ W.T
            + (n * g * fx + n * k * f + k * g * f)   # H.T @ R
            + (k * g * f + k * f)                    # W colsum
            + (n * k * f + k * f)                    # H rowsum
            + 4 * n * k * f + 4 * k * g * f)         # rate chains
    elif beta == 0.0:
        # IS: WH, two ratio chains, two statistics matmuls a side and the
        # gamma=0.5 rate chain (approximate elementwise accounting)
        flops = (12 * n * g * k + 10 * n * g + 7 * n * k + 7 * k * g)
        bytes_ = (
            2 * ((n * k + k * g) * f + n * g * fx)
            + 2 * 5 * n * g * fx
            + 2 * (n * g * fx + k * g * f + n * k * f)
            + 2 * (n * g * fx + n * k * f + k * g * f)
            + 6 * n * k * f + 6 * k * g * f)
    else:
        raise ValueError(f"dense_update_cost implements beta in "
                         f"{{2, 1, 0}}, got {beta}")
    return {"flops": float(flops), "bytes": float(bytes_),
            "lane": ("bundled" if bundled else
                     ("dense-bf16" if (bf16_ratio and beta != 2.0)
                      else "dense"))}
