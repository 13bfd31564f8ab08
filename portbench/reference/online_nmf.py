"""Online beta-divergence NMF by multiplicative updates, in plain PyTorch.

The online solver of cNMF's ``factorize`` as the configuration states it,
written from the algorithm and not from the program: ``X (cells x genes)
~= H (cells x k) @ W (k x genes)``, the cells in row chunks, ``R``
replicates side by side, each replicate's result its own solo solve.

A pass visits the chunks in order. Frobenius (beta=2): each chunk's usage
block is solved by MU with W fixed (relative change below the pass's inner
tolerance, at most ``max_iter`` steps) while ``A = H^T X`` and ``B = H^T H``
accumulate; then W is solved by MU from ``(A, B)`` under the same rule.
Kullback-Leibler (beta=1): each chunk's usage block is solved by MU with W
fixed, the chunk's objective is taken, and W takes one MU step from that
chunk. A replicate stops when its objective fell by less than ``tol`` of
the first pass's objective over a pass (never while the coarse-to-fine
inner tolerance ``h_tol_start * 0.5^pass`` is still above ``h_tol``), or
after ``n_passes`` passes. The returned objective is that of the final
usages and spectra.

``chain`` is the arithmetic of the KL ratio ``X / (H W)``: ``"bf16"``
rounds ``H``, ``W``, ``X`` and ``H W`` to bfloat16 and takes the ratio in
bfloat16 (the statistics accumulate in float32), ``"fp8"`` does the same in
float8 e4m3 (values saturated at its largest finite 448), ``"f32"`` keeps
float32. For Frobenius ``"f32"`` runs float32 matrix products with TF32
off and ``"tf32"`` with TF32 on. Objectives are float64.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-16
EVAL_EVERY = 10
FP8_MAX = 448.0


def x_mean(X: torch.Tensor, n: int, g: int) -> float:
    """The random init's scale ``mean(X)``: a float32 sum over ``n * g``."""
    return float(X.sum(dtype=torch.float32) / (n * g))


def random_init(seed: int, n: int, g: int, k: int, mean: float):
    """``avg * |N(0, 1)|`` usages ``(n, k)`` then spectra ``(k, g)``, with
    ``avg = sqrt(mean / k)``, drawn from a CPU generator seeded with the
    replicate's seed (its low 31 bits)."""
    gen = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFF)
    avg = math.sqrt(max(float(mean), EPS) / k)
    H = avg * torch.randn((n, k), generator=gen, dtype=torch.float32).abs()
    W = avg * torch.randn((k, g), generator=gen, dtype=torch.float32).abs()
    return H, W


def _q8(t):
    return t.clamp(max=FP8_MAX).to(torch.float8_e4m3fn).float()


def _kl_ratio(x, H, W, chain: str):
    """``(ratio (R, rows, g) float32, H operand, W operand)`` of the KL
    updates in the chain's arithmetic; the operands are what the
    statistics multiply the ratio with."""
    if chain == "bf16":
        hb, wb = H.to(torch.bfloat16), W.to(torch.bfloat16)
        wh = hb @ wb
        eps = torch.full((), EPS, dtype=torch.bfloat16, device=x.device)
        ratio = x.to(torch.bfloat16) / torch.maximum(wh, eps)
        return ratio.float(), hb.float(), wb.float()
    if chain == "fp8":
        h8, w8 = _q8(H), _q8(W)
        wh = _q8(h8 @ w8)
        ratio = _q8(_q8(x) / torch.clamp_min(wh, EPS))
        return ratio, h8, w8
    return x / torch.clamp_min(H @ W, EPS), H, W


def _mu(M, numer, denom):
    rate = torch.where(denom < EPS, torch.zeros((), device=M.device),
                       numer / torch.clamp_min(denom, EPS))
    return M * rate


def _kl_h_step(x, H, W, chain):
    ratio, _, w = _kl_ratio(x, H, W, chain)
    return _mu(H, ratio @ w.mT, W.sum(-1)[:, None, :].expand(H.shape))


def _kl_w_step(x, H, W, chain):
    ratio, h, _ = _kl_ratio(x, H, W, chain)
    return _mu(W, h.mT @ ratio, H.sum(1)[:, :, None].expand(W.shape))


def objective(x, H, W, beta: float) -> torch.Tensor:
    """``D_beta(x || H W)`` per replicate, float64."""
    wh = H.double() @ W.double()
    xd = x.double()
    if beta == 2.0:
        return 0.5 * ((xd - wh) ** 2).sum(dim=(1, 2))
    wh = torch.clamp_min(wh, EPS)
    pos = xd > 0
    safe = torch.where(pos, xd, torch.ones((), dtype=xd.dtype,
                                            device=xd.device))
    term = torch.where(pos, xd * torch.log(safe / wh) - xd + wh, wh)
    return term.sum(dim=(1, 2))


def _rel_change(new, old):
    return (torch.linalg.vector_norm(new - old, dim=(1, 2))
            / (torch.linalg.vector_norm(old, dim=(1, 2)) + EPS))


def _until_still(M, step, max_iter: int, tol, active):
    """``M <- step(M)`` for each active replicate until its relative change
    falls below its ``tol`` or it has taken ``max_iter`` steps; a replicate
    that has stopped keeps its value."""
    active = active.clone()
    it = 0
    while it < max_iter:
        new = step(M)
        rel = _rel_change(new, M)
        M = torch.where(active[:, None, None], new, M)
        it += 1
        active = active & (rel >= tol)
        if it % EVAL_EVERY == 0 and not bool(active.any()):
            break
    return M


def solve_online(Xc: torch.Tensor, Hc0: torch.Tensor, W0: torch.Tensor,
                 beta: float, chain: str, tol: float = 1e-4,
                 h_tol: float = 1e-2, h_tol_start: float | None = 0.1,
                 n_passes: int = 60, max_iter: int = 1000):
    """Solve ``R`` replicates online. ``Xc`` ``(C, rows, g)`` float32,
    ``Hc0`` ``(R, C, rows, k)``, ``W0`` ``(R, k, g)``, all on one device.
    Returns ``(W (R, k, g), objective (R,) float64, passes (R,))``."""
    R, C = Hc0.shape[0], Hc0.shape[1]
    dev = W0.device
    h_tol32 = float(torch.tensor(h_tol, dtype=torch.float32))

    def inner_tol(p):
        if h_tol_start is None:
            return torch.full((R,), h_tol, dtype=torch.float32, device=dev)
        return torch.clamp_min(h_tol_start * torch.pow(0.5, p.float()),
                               h_tol32)

    def one_pass(Hc, W, p, active):
        tol_p = inner_tol(p)
        err = torch.zeros(R, dtype=torch.float64, device=dev)
        Hc = Hc.clone()
        if beta == 2.0:
            WWT = W @ W.mT
            A = torch.zeros_like(W)
            B = torch.zeros((R, W.shape[1], W.shape[1]), device=dev)
            for c in range(C):
                x = Xc[c]
                numer = x @ W.mT
                h = _until_still(Hc[:, c], lambda hh: _mu(hh, numer, hh @ WWT),
                                 max_iter, tol_p, active)
                A = A + h.mT @ x
                B = B + h.mT @ h
                err = err + objective(x, h, W, beta)
                Hc[:, c] = h
            W_new = _until_still(W, lambda ww: _mu(ww, A, B @ ww), max_iter,
                                 tol_p, active)
            return Hc, torch.where(active[:, None, None], W_new, W), err
        for c in range(C):
            x = Xc[c]
            h = _until_still(Hc[:, c], lambda hh: _kl_h_step(x, hh, W, chain),
                             max_iter, tol_p, active)
            err = err + objective(x, h, W, beta)
            W = torch.where(active[:, None, None],
                            _kl_w_step(x, h, W, chain), W)
            Hc[:, c] = h
        return Hc, W, err

    on = torch.ones(R, dtype=torch.bool, device=dev)
    Hc, W, err0 = one_pass(Hc0, W0, torch.zeros(R, device=dev), on)
    err_prev = err0 * (1.0 + 2.0 * tol) + 1.0
    err = err0
    passes = torch.ones(R, dtype=torch.int32, device=dev)

    def still(err_prev, err, passes):
        keep = (err_prev - err) / torch.clamp_min(err0, EPS) >= tol
        if h_tol_start is not None:
            keep = keep | (h_tol_start * torch.pow(0.5, passes.float())
                           > h_tol32)
        return (passes < n_passes) & keep

    act = still(err_prev, err, passes)
    while bool(act.any()):
        Hc, W, err_new = one_pass(Hc, W, passes, act)
        err_prev = torch.where(act, err, err_prev)
        err = torch.where(act, err_new, err)
        passes = passes + act.to(torch.int32)
        act = act & still(err_prev, err, passes)
    final = torch.zeros(R, dtype=torch.float64, device=dev)
    for c in range(C):
        final = final + objective(Xc[c], Hc[:, c], W, beta)
    return W, final, passes
