"""Replicate sweeps: ``R`` NMF replicates at one K as one batched solve.

Port of ``cnmf_torch_tpu/parallel/replicates.py`` (the single-device lane).
The JAX package ``vmap``-ed a solo solver over stacked inits; here the
replicate axis is a leading batch dimension of every factor tensor, and
the online solver keeps a per-lane ``active`` mask so each replicate's
result is its solo solve (``ops/nmf.py``). Replicates run in slices sized
from the card's free memory (:func:`auto_replicates_per_batch`).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..ops.nmf import (beta_loss_to_float, dense_on_device, nmf_fit_online,
                       random_init, resolve_bf16_ratio,
                       resolve_online_schedule, split_regularization)
from ..ops.sparse import (EllMatrix, ell_chunk_rows, ell_row_width,
                          resolve_sparse_beta)

__all__ = ["worker_filter", "auto_replicates_per_batch", "replicate_sweep",
           "stacked_inits"]

# f32 element budget when the device reports no free memory (the CPU)
_FALLBACK_BUDGET_ELEMS = 1 << 28


def worker_filter(iterable, worker_index: int, total_workers: int):
    """Round-robin task partition: worker i takes every task whose
    position is congruent to i modulo ``total_workers``."""
    return (p for i, p in enumerate(iterable)
            if (i - worker_index) % total_workers == 0)


def _device_budget_elems(device) -> int:
    """30% of the card's free memory in f32 elements
    (``torch.cuda.mem_get_info``); a fixed 1 GiB on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return _FALLBACK_BUDGET_ELEMS
    free, _total = torch.cuda.mem_get_info(dev)
    return max((int(free) * 3 // 10) // 4, 1 << 22)


def auto_replicates_per_batch(n: int, g: int, k: int, beta: float = 2.0,
                              chunk: int | None = None,
                              budget_elems: int | None = None,
                              ell_width: int | None = None,
                              device="cuda") -> int:
    """How many replicates fit one slice under the f32 element budget.

    Each replicate carries its factor state (current, next and temporary
    H and W, plus the returned usages). For beta != 2 the dense chains
    materialize ``chunk x genes`` intermediates per replicate; the ELL lane
    holds ``(chunk, width)`` ratio and accumulator buffers instead."""
    if budget_elems is None:
        budget_elems = _device_budget_elems(device)
    per_rep = 3 * (n * k + k * g) + n * k
    if beta != 2.0:
        c = n if chunk is None else min(int(chunk), n)
        if ell_width is not None:
            per_rep += c * int(ell_width) * (k + 5)
        else:
            per_rep += 3 * c * g
    return max(1, int(budget_elems // max(per_rep, 1)))


def stacked_inits(x_mean: float, n: int, g: int, k: int, seeds,
                  device="cpu"):
    """Per-replicate ``(H0 (R, n, k), W0 (R, k, g))`` scaled random inits,
    each drawn from a CPU generator seeded with the replicate's seed."""
    pairs = [random_init(int(s), n, g, k, x_mean) for s in seeds]
    return (torch.stack([p[0] for p in pairs]).to(device),
            torch.stack([p[1] for p in pairs]).to(device))


def _stage(X, beta: float, init: str, chunk: int, dev):
    """Host input -> ``(Xc, n)``: the pre-chunked ELL encoding when the
    dispatch rule engages, else dense row chunks ``(C, chunk, g)``."""
    if isinstance(X, EllMatrix):
        if X.vals.ndim != 3 or X.rows_t is None:
            raise ValueError(
                "sweeps take a pre-chunked EllMatrix with its transpose "
                "index set (ops.sparse.ell_chunk_rows)")
        return X.to(dev), None
    if sp.issparse(X):
        n, g = X.shape
        if init == "random" and resolve_sparse_beta(
                beta, density=X.nnz / max(n * g, 1),
                width=ell_row_width(X), g=g):
            Xe, _ = ell_chunk_rows(X, chunk)
            return Xe.to(dev), n
    Xt = dense_on_device(X, dev)
    n, g = Xt.shape
    C = max(1, -(-n // chunk))
    Xt = torch.nn.functional.pad(Xt, (0, 0, 0, C * chunk - n))
    return Xt.reshape(C, chunk, g), n


def replicate_sweep(X, seeds, k: int, beta_loss="frobenius",
                    init: str = "random", mode: str = "online",
                    tol: float = 1e-4, online_chunk_size: int = 5000,
                    online_chunk_max_iter: int = 1000,
                    n_passes: int | None = None, alpha_W: float = 0.0,
                    l1_ratio_W: float = 0.0, alpha_H: float = 0.0,
                    l1_ratio_H: float = 0.0,
                    replicates_per_batch: int | None = None,
                    online_h_tol: float | None = None,
                    n_rows: int | None = None, inits=None,
                    return_usages: bool = False, trace: list | None = None,
                    device="cuda"):
    """Run ``len(seeds)`` online-MU replicates at one K.

    ``X``: a host matrix (dense, or scipy-sparse — encoded as a chunked
    ELL matrix when the dispatch rule engages for beta in {1, 0}) or a
    pre-chunked :class:`EllMatrix` (then pass the true cell count as
    ``n_rows``). ``inits``: optional explicit ``(H0 (R, n, k), W0 (R, k,
    g))`` in place of the seeded random draws. ``trace``: a list that
    receives one ``(passes, r)`` array of per-pass objectives per slice of
    ``r`` replicates. Returns ``(spectra (R, k, g), usages (R, n, k) |
    None, errs (R,))`` as numpy in seed order."""
    dev = resolve_device(device)
    if mode != "online":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (this slice runs 'online')")
    if init != "random":
        raise NotImplementedError(
            f"init={init!r} is not ported yet (this slice runs 'random')")
    beta = beta_loss_to_float(beta_loss)
    chunk = int(min(online_chunk_size, X.shape[0]))
    Xc, n_staged = _stage(X, beta, init, chunk, dev)
    ell = isinstance(Xc, EllMatrix)
    g = int(Xc.g if ell else Xc.shape[-1])
    C, chunk = Xc.shape[0], Xc.shape[1]
    n = int(n_rows if n_rows is not None
            else (n_staged if n_staged is not None else C * chunk))
    k = int(k)
    h_tol, n_passes, h_tol_start = resolve_online_schedule(
        beta, online_h_tol, n_passes)
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    seeds = [int(s) & 0x7FFFFFFF for s in seeds]
    R = len(seeds)
    if R == 0:
        return (np.zeros((0, k, g), np.float32),
                np.zeros((0, n, k), np.float32) if return_usages else None,
                np.zeros((0,), np.float32))
    # mean over all n*g entries: padded rows are all-zero and add nothing
    x_mean = float((Xc.vals.sum() if ell else Xc.sum()) / (n * g))
    rpb = replicates_per_batch or auto_replicates_per_batch(
        n, g, k, beta=beta, chunk=chunk,
        ell_width=Xc.width if ell else None, device=dev)
    spectra, usages, errs = [], [], []
    for start in range(0, R, rpb):
        sl = seeds[start:start + rpb]
        if inits is None:
            H0, W0 = stacked_inits(x_mean, n, g, k, sl, dev)
        else:
            H0 = torch.tensor(np.ascontiguousarray(
                inits[0][start:start + rpb], np.float32)).to(dev)
            W0 = torch.tensor(np.ascontiguousarray(
                inits[1][start:start + rpb], np.float32)).to(dev)
        H0 = torch.nn.functional.pad(H0, (0, 0, 0, C * chunk - n))
        passes = [] if trace is not None else None
        Hc, W, err = nmf_fit_online(
            Xc, H0.reshape(len(sl), C, chunk, k), W0, beta=beta, tol=tol,
            h_tol=h_tol, chunk_max_iter=int(online_chunk_max_iter),
            n_passes=n_passes, l1_H=l1_H, l2_H=l2_H, l1_W=l1_W, l2_W=l2_W,
            h_tol_start=h_tol_start,
            bf16_ratio=resolve_bf16_ratio(beta, mode), trace=passes)
        if trace is not None:
            trace.append(np.stack(passes))
        spectra.append(W.cpu().numpy())
        errs.append(err.cpu().numpy())
        if return_usages:
            usages.append(Hc.reshape(len(sl), C * chunk, k)[:, :n]
                          .cpu().numpy())
    return (np.concatenate(spectra),
            np.concatenate(usages) if return_usages else None,
            np.concatenate(errs))
