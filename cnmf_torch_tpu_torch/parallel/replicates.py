"""Replicate sweeps: ``R`` NMF replicates at one K as one batched solve.

Port of ``cnmf_torch_tpu/parallel/replicates.py`` (the single-device lane).
The JAX package ``vmap``-ed a solo solver over stacked inits; here the
replicate axis is a leading batch dimension of every factor tensor, and
the solvers keep a per-lane ``active`` mask so each replicate's result is
its solo solve (``ops/nmf.py``). ``mode="online"`` runs the streamed
solver over row chunks; ``mode="batch"`` runs the batch solver over the
whole matrix under the resolved recipe (``ops/recipe.py``: batch KL runs
the dna recipe by default, batch IS amu, and a beta=2 batch sweep at
k <= 21 the bundle-packed solver). Replicates run in slices sized from
the card's free memory (:func:`auto_replicates_per_batch`).
:func:`replicate_sweep_packed` gives a multi-K sweep the JAX package's
packed contract over the per-K sweeps.

Inits: the seeded random init, or the nndsvd family, whose SVD base is
computed once per sweep and whose exact zeros each replicate fills from
its own seed (:func:`stacked_inits`).

Telemetry: a sweep given a ``telemetry_sink`` hands it one
:func:`_sweep_telemetry_payload` per K under ``CNMF_TPU_TELEMETRY``, built
from the objective traces the solvers already bring to the host, laid
out as the JAX solvers' fixed ``(R, TRACE_LEN)`` slot arrays.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..ops.kernels import kernel_label
from ..ops.nmf import (EVAL_EVERY, SolverTelemetry, beta_loss_to_float,
                       bundle_width, dense_on_device, nmf_fit_batch,
                       nmf_fit_batch_bundled, nmf_fit_batch_hals,
                       nmf_fit_online, nndsvd_base, nndsvd_fill,
                       random_init, resolve_bf16_ratio,
                       resolve_online_schedule, split_regularization,
                       sweep_x_mean)
from ..ops.recipe import SolverRecipe, resolve_recipe
from ..ops.sparse import (EllMatrix, csr_to_ell, ell_chunk_rows,
                          ell_row_width, resolve_sparse_beta)
from ..runtime.faults import maybe_fail
from ..utils.envknobs import env_int
from ..utils.telemetry import telemetry_enabled

_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar")

__all__ = ["worker_filter", "auto_replicates_per_batch", "replicate_sweep",
           "replicate_sweep_packed", "stacked_inits"]

# f32 element budget when the device reports no free memory (the CPU)
_FALLBACK_BUDGET_ELEMS = 1 << 28
# a beta=2 batch sweep runs the bundled solver where a bundle holds at
# least this many replicates (k <= 21; the JAX package bundles wherever
# two fit). On an NVIDIA H100 (20 replicates, 10,000 x 2,000) it beat the
# per-replicate solve 3.0x at k=5 down to 1.18x at k=21 and tied it within
# 2% at 4 and 2 a bundle (k=32, 64): chip_smoke.py's phase 5 prints these
# times.
BUNDLE_MIN_WIDTH = 6
# a replicate record's objective trace length, the JAX solvers'
# ``TRACE_LEN``: one slot per objective evaluation (each pass online,
# every EVAL_EVERY iterations in batch); evaluations after the 63rd
# overwrite the last slot
TRACE_LEN = 64


def _trace_slots(values) -> np.ndarray:
    """One lane's objectives, in evaluation order, as the JAX solvers'
    ``(TRACE_LEN,)`` slot array: NaN past the last evaluation, and the
    last slot holding the last evaluation once there are more than
    ``TRACE_LEN - 1``."""
    v = np.asarray(values, np.float32)
    out = np.full(TRACE_LEN, np.nan, np.float32)
    head = v[:TRACE_LEN - 1]
    out[:len(head)] = head
    if len(v) >= TRACE_LEN:
        out[-1] = v[-1]
    return out


def _sweep_telemetry(mode: str, traces: list, lane_passes, errs):
    """A sweep's :class:`SolverTelemetry` in the JAX layout, from its
    slices' trace entries. Online: each slice's ``(passes, r)`` per-pass
    objectives and ``(r,)`` pass counts give a lane its first ``passes``
    objectives (a stopped lane's repeats are not evaluations);
    ``nonfinite`` latches any nonfinite pass objective or final ``errs``.
    Batch: each slice's ``SolverTelemetry`` (``(r, evaluations)``, NaN
    once a lane stopped), of which a lane of ``iters`` iterations
    evaluated the first ``iters // EVAL_EVERY``."""
    if mode == "online":
        rows, iters, nonfin = [], [], []
        for tr, passes in zip(traces, lane_passes):
            for r in range(tr.shape[1]):
                p = int(passes[r])
                rows.append(_trace_slots(tr[:p, r]))
                iters.append(p)
                nonfin.append(not np.isfinite(tr[:p, r]).all())
        return SolverTelemetry(
            trace=np.stack(rows), iters=np.asarray(iters, np.int32),
            nonfinite=(np.asarray(nonfin, bool)
                       | ~np.isfinite(np.asarray(errs))))

    def cat(field):
        parts = [getattr(t, field) for t in traces]
        return None if any(v is None for v in parts) else np.concatenate(
            parts)

    rows = [_trace_slots(t.trace[r, :int(t.iters[r]) // EVAL_EVERY])
            for t in traces for r in range(len(t.iters))]
    return SolverTelemetry(
        trace=np.stack(rows), iters=cat("iters"),
        nonfinite=cat("nonfinite"), inner_iters=cat("inner_iters"),
        dna_fallback=cat("dna_fallback"))


def _sweep_telemetry_payload(k, beta, mode, seeds, cap, tm, errs,
                             recipe: SolverRecipe | None = None,
                             kernel: str | None = None):
    """The dict a sweep's ``telemetry_sink`` receives (the JAX package's
    keys): ``cadence`` is ``pass`` online and ``iter/<EVAL_EVERY>`` in
    batch, ``recipe`` the engaged solver recipe's label, ``kernel`` the
    engaged lane's :func:`~..ops.kernels.kernel_label`; the batch solvers'
    inner-update counts and dna fallback fractions ride along where they
    are tracked."""
    out = {
        "k": int(k), "beta": float(beta), "mode": mode,
        "seeds": [int(s) for s in seeds],
        "cap": int(cap),
        "cadence": "pass" if mode == "online" else f"iter/{EVAL_EVERY}",
        "trace": tm.trace, "iters": tm.iters, "nonfinite": tm.nonfinite,
        "errs": errs,
    }
    if recipe is not None:
        out["recipe"] = recipe.label
    if kernel is not None:
        out["kernel"] = kernel
    if tm.inner_iters is not None:
        out["inner_iters"] = tm.inner_iters
    if tm.dna_fallback is not None:
        out["dna_fallback"] = tm.dna_fallback
    return out


def _telemetry_requested(telemetry_sink) -> bool:
    return telemetry_sink is not None and telemetry_enabled()


def worker_filter(iterable, worker_index: int, total_workers: int):
    """Round-robin task partition: worker i takes every task whose
    position is congruent to i modulo ``total_workers``."""
    return (p for i, p in enumerate(iterable)
            if (i - worker_index) % total_workers == 0)


def _device_budget_elems(device) -> int:
    """``CNMF_TPU_BUDGET_ELEMS`` when set; else 30% of the card's free
    memory in f32 elements (``torch.cuda.mem_get_info``), or a fixed 1 GiB
    on the CPU."""
    env = env_int("CNMF_TPU_BUDGET_ELEMS", 0, lo=0)
    if env:
        return env
    dev = torch.device(device)
    if dev.type != "cuda":
        return _FALLBACK_BUDGET_ELEMS
    free, _total = torch.cuda.mem_get_info(dev)
    return max((int(free) * 3 // 10) // 4, 1 << 22)


def auto_replicates_per_batch(n: int, g: int, k: int, beta: float = 2.0,
                              chunk: int | None = None,
                              budget_elems: int | None = None,
                              ell_width: int | None = None,
                              kl_newton: bool = False,
                              device="cuda") -> int:
    """How many replicates fit one slice under the f32 element budget.

    Each replicate carries its factor state (current, next and temporary
    H and W, plus the returned usages). For beta != 2 the dense chains
    materialize ``chunk x genes`` intermediates per replicate (``chunk =
    n`` in batch mode); the ELL lane holds ``(chunk, width)`` ratio and
    accumulator buffers instead, and the IS hybrid (beta=0) a dense ``WH``
    and its reciprocal besides. ``kl_newton`` (dna) charges two more such
    buffers for the candidates' reconstructions."""
    if budget_elems is None:
        budget_elems = _device_budget_elems(device)
    per_rep = 3 * (n * k + k * g) + n * k
    if beta != 2.0:
        c = n if chunk is None else min(int(chunk), n)
        if ell_width is not None:
            per_rep += c * int(ell_width) * (k + 5)
            if beta == 0.0:
                per_rep += 2 * c * g
            if kl_newton:
                per_rep += 2 * c * int(ell_width)
        else:
            per_rep += 3 * c * g
            if kl_newton:
                per_rep += 2 * c * g
    return max(1, int(budget_elems // max(per_rep, 1)))


def stacked_inits(x_mean: float, n: int, g: int, k: int, seeds,
                  device="cpu", init: str = "random", base=None):
    """Per-replicate ``(H0 (R, n, k), W0 (R, k, g))`` inits. ``random``:
    scaled random inits, each drawn from a CPU generator seeded with the
    replicate's seed. The nndsvd family takes ``base``, the sweep's
    exact-zero nndsvd base ``(H (n, k), W (k, g))`` on ``device``:
    ``nndsvd`` and ``nndsvdar`` fill its zeros with ``mean(X)/100 *
    uniform`` drawn from each replicate's seed (distinct replicates),
    ``nndsvda`` with ``mean(X)/100`` (every replicate the same)."""
    if init == "random":
        pairs = [random_init(int(s), n, g, k, x_mean) for s in seeds]
    elif init == "nndsvda":
        pairs = [nndsvd_fill(*base, x_mean, "nndsvda")] * len(list(seeds))
    else:
        pairs = [nndsvd_fill(*base, x_mean, "nndsvdar", int(s))
                 for s in seeds]
    return (torch.stack([p[0] for p in pairs]).to(device),
            torch.stack([p[1] for p in pairs]).to(device))


def _stage(X, beta: float, init: str, mode: str, chunk: int, dev):
    """Host input -> ``(X staged, n | None)``. Online: the pre-chunked ELL
    encoding when the dispatch rule engages, else dense row chunks ``(C,
    chunk, g)``. Batch: the unchunked ELL encoding with its transpose
    index set, else the dense ``(n, g)`` matrix. A caller-staged
    :class:`EllMatrix` must be chunked for online and unchunked for batch
    (``n`` is then None: pass the true cell count as ``n_rows``). The
    fault harness's ``upload`` clause raises here (context
    ``replicate_sweep._stage``)."""
    maybe_fail("upload", context="replicate_sweep._stage")
    if isinstance(X, EllMatrix):
        if init != "random":
            # the nndsvd family's SVD base needs the dense matrix
            raise ValueError(
                f"ELL-encoded sweeps require init='random', got {init!r}")
        want_chunked = mode == "online"
        if want_chunked != (X.vals.ndim == 3):
            raise ValueError(
                "mode=%r needs %s EllMatrix (build online encodings with "
                "ops.sparse.ell_chunk_rows at the sweep's "
                "online_chunk_size, batch encodings with csr_to_ell)"
                % (mode, "a pre-chunked" if want_chunked else "an unchunked"))
        if X.rows_t is None:
            raise ValueError(
                "sweep EllMatrix needs the transpose index set "
                "(rows_t/perm_t) for the W updates")
        return X.to(dev), None
    if sp.issparse(X):
        n, g = X.shape
        if init == "random" and resolve_sparse_beta(
                beta, density=X.nnz / max(n * g, 1),
                width=ell_row_width(X), g=g):
            if mode == "online":
                Xe, _ = ell_chunk_rows(X, chunk)
            else:
                Xe = csr_to_ell(X)
            return Xe.to(dev), n
    Xt = dense_on_device(X, dev)
    n, g = Xt.shape
    if mode == "batch":
        return Xt, n
    C = max(1, -(-n // chunk))
    Xt = torch.nn.functional.pad(Xt, (0, 0, 0, C * chunk - n))
    return Xt.reshape(C, chunk, g), n


def _auto_packed(use_ell: bool, algo: str, init: str, n_ks: int,
                 max_replicates: int, total_workers: int = 1) -> bool:
    """The JAX planner's packed-K-sweep rule (``runtime/planner.py:
    _auto_packed``): a dense random-init ``mu`` ledger of at least 4 Ks with
    at most 32 replicates a K across the workers."""
    return (not use_ell and algo == "mu" and init == "random"
            and n_ks >= 4 and max_replicates * max(1, total_workers) <= 32)


def replicate_sweep(X, seeds, k: int, beta_loss="frobenius",
                    init: str = "random", mode: str = "online",
                    tol: float = 1e-4, online_chunk_size: int = 5000,
                    online_chunk_max_iter: int = 1000,
                    batch_max_iter: int = 500,
                    n_passes: int | None = None, alpha_W: float = 0.0,
                    l1_ratio_W: float = 0.0, alpha_H: float = 0.0,
                    l1_ratio_H: float = 0.0,
                    replicates_per_batch: int | None = None,
                    online_h_tol: float | None = None,
                    n_rows: int | None = None, inits=None,
                    return_usages: bool = False, trace: list | None = None,
                    recipe: SolverRecipe | None = None,
                    telemetry_sink=None, device="cuda"):
    """Run ``len(seeds)`` NMF replicates at one K.

    ``X``: a host matrix (dense, or scipy-sparse — ELL-encoded when the
    dispatch rule engages for beta in {1, 0}: row-chunked online, whole
    with its transpose index set in batch mode), a dense tensor, or a
    caller-staged :class:`EllMatrix` (pre-chunked online, unchunked batch;
    pass the true cell count as ``n_rows``). ``init``: ``random`` or the
    nndsvd family (:func:`stacked_inits`; dense lane only). ``inits``:
    optional explicit ``(H0 (R, n, k), W0 (R, k, g))`` in place of the
    seeded draws.
    ``recipe``: the resolved :class:`SolverRecipe`, else resolved from the
    env knobs (batch KL: ``dna`` by default, batch IS ``amu``); ``hals``
    runs the HALS solvers (beta=2), ``sketch`` the sketched W updates
    (beta=1). A beta=2 batch sweep under plain MU
    runs :func:`~..ops.nmf.nmf_fit_batch_bundled` when at least
    ``BUNDLE_MIN_WIDTH`` replicates fit a bundle, else the per-replicate
    :func:`~..ops.nmf.nmf_fit_batch`. ``trace``: a list
    that receives, per slice of ``r`` replicates, one ``(passes, r)`` array
    of per-pass objectives (online) or one
    :class:`~..ops.nmf.SolverTelemetry` (batch). ``telemetry_sink``: a
    callable receiving, under ``CNMF_TPU_TELEMETRY``, one
    :func:`_sweep_telemetry_payload` for the whole sweep. Returns
    ``(spectra (R, k, g), usages (R, n, k) | None, errs (R,))`` as numpy
    in seed order."""
    dev = resolve_device(device)
    if mode not in ("online", "batch"):
        raise ValueError(f"unknown mode {mode!r}")
    if init not in _INITS:
        raise ValueError(f"unknown init {init!r}")
    beta = beta_loss_to_float(beta_loss)
    chunk = int(min(online_chunk_size, X.shape[0]))
    Xs, n_staged = _stage(X, beta, init, mode, chunk, dev)
    ell = isinstance(Xs, EllMatrix)
    g = int(Xs.g if ell else Xs.shape[-1])
    if mode == "online":
        C, chunk = Xs.shape[0], Xs.shape[1]
        n_padded = C * chunk
    else:
        n_padded = Xs.shape[0]
    n = int(n_rows if n_rows is not None
            else (n_staged if n_staged is not None else n_padded))
    k = int(k)
    if recipe is None:
        recipe = resolve_recipe(beta, mode, ell=ell, n=n, g=g, k=k,
                                ell_width=Xs.width if ell else None)
    if recipe.algo == "hals" and beta != 2.0:
        raise ValueError("the hals recipe optimizes the Frobenius "
                         "objective; this sweep has beta=%g" % beta)
    if recipe.algo == "sketch" and beta != 1.0:
        raise ValueError("the sketch recipe requires beta=1 (KL); this "
                         "sweep has beta=%g" % beta)
    if recipe.kl_newton and beta != 1.0:
        raise ValueError(f"the dna recipe requires beta=1 (KL); this sweep "
                         f"has beta={beta}")
    hals = recipe.algo == "hals"
    bundled = (mode == "batch" and beta == 2.0 and not hals
               and bundle_width(k) >= BUNDLE_MIN_WIDTH
               and recipe.inner_repeats == 1)
    h_tol, n_passes, h_tol_start = resolve_online_schedule(
        beta, online_h_tol, n_passes)
    bf16 = (False if recipe.kl_newton
            else resolve_bf16_ratio(beta, mode))
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    seeds = [int(s) & 0x7FFFFFFF for s in seeds]
    R = len(seeds)
    if R == 0:
        return (np.zeros((0, k, g), np.float32),
                np.zeros((0, n, k), np.float32) if return_usages else None,
                np.zeros((0,), np.float32))
    if init == "nndsvda" and R > 1:
        warnings.warn(
            "init='nndsvda' is deterministic given X: all %d replicates of "
            "this sweep will be identical and consensus over them is "
            "vacuous. Use init='nndsvd' (seeded nndsvdar fill) or 'random' "
            "for replicate sweeps." % R, UserWarning, stacklevel=2)
    x_mean = sweep_x_mean(Xs, n, g)
    # the nndsvd family's SVD base: once per sweep, on the unpadded rows
    base = (None if init == "random" or inits is not None
            else nndsvd_base(Xs.reshape(-1, g)[:n], k))
    rpb = replicates_per_batch or auto_replicates_per_batch(
        n, g, k, beta=beta, chunk=chunk if mode == "online" else n,
        ell_width=Xs.width if ell else None, kl_newton=recipe.kl_newton,
        device=dev)
    reg = dict(l1_H=l1_H, l2_H=l2_H, l1_W=l1_W, l2_W=l2_W)
    sketch = dict(sketch_dim=int(recipe.sketch_dim),
                  sketch_exact_every=int(recipe.sketch_exact_every))
    want_telem = _telemetry_requested(telemetry_sink)
    # the slices' trace entries: the caller's list, or one of the sweep's
    # own when only the telemetry asks for them
    traces = trace if trace is not None else ([] if want_telem else None)
    first_entry = len(traces) if traces is not None else 0
    lane_passes = [] if want_telem and mode == "online" else None
    spectra, usages, errs = [], [], []
    for start in range(0, R, rpb):
        sl = seeds[start:start + rpb]
        if inits is None:
            H0, W0 = stacked_inits(x_mean, n, g, k, sl, dev, init, base)
        else:
            H0 = torch.tensor(np.ascontiguousarray(
                inits[0][start:start + rpb], np.float32)).to(dev)
            W0 = torch.tensor(np.ascontiguousarray(
                inits[1][start:start + rpb], np.float32)).to(dev)
        H0 = torch.nn.functional.pad(H0, (0, 0, 0, n_padded - n))
        if mode == "batch":
            batch_kw = dict(tol=tol, max_iter=int(batch_max_iter),
                            trace=traces, **reg)
            if hals:
                H, W, err = nmf_fit_batch_hals(Xs, H0, W0, **batch_kw)
            elif bundled:
                H, W, err = nmf_fit_batch_bundled(Xs, H0, W0, **batch_kw)
            else:
                H, W, err = nmf_fit_batch(
                    Xs, H0, W0, beta=beta,
                    inner_repeats=int(recipe.inner_repeats),
                    kl_newton=bool(recipe.kl_newton), **sketch, **batch_kw)
        else:
            passes = [] if traces is not None else None
            Hc, W, err = nmf_fit_online(
                Xs, H0.reshape(len(sl), C, chunk, k), W0, beta=beta,
                tol=tol, h_tol=h_tol,
                chunk_max_iter=int(online_chunk_max_iter),
                n_passes=n_passes, h_tol_start=h_tol_start, bf16_ratio=bf16,
                trace=passes, kl_newton=bool(recipe.kl_newton),
                algo="halsvar" if hals else "mu", lane_passes=lane_passes,
                **sketch, **reg)
            if traces is not None:
                traces.append(np.stack(passes))
            H = Hc.reshape(len(sl), n_padded, k)
        spectra.append(W.cpu().numpy())
        errs.append(err.cpu().numpy())
        if return_usages:
            usages.append(H[:, :n].cpu().numpy())
    errs = np.concatenate(errs)
    if want_telem:
        telemetry_sink(_sweep_telemetry_payload(
            k, beta, mode, seeds,
            n_passes if mode == "online" else batch_max_iter,
            _sweep_telemetry(mode, traces[first_entry:], lane_passes, errs),
            errs, recipe=recipe,
            kernel=kernel_label(ell, dev, bf16 and recipe.algo != "sketch",
                                beta)))
    return (np.concatenate(spectra),
            np.concatenate(usages) if return_usages else None,
            errs)


def replicate_sweep_packed(X, ks, seeds, beta_loss="frobenius",
                           init: str = "random", mode: str = "online",
                           tol: float = 1e-4, online_chunk_size: int = 5000,
                           online_chunk_max_iter: int = 1000,
                           batch_max_iter: int = 500,
                           n_passes: int | None = None,
                           alpha_W: float = 0.0, l1_ratio_W: float = 0.0,
                           alpha_H: float = 0.0, l1_ratio_H: float = 0.0,
                           return_usages: bool = False,
                           replicates_per_batch: int | None = None,
                           online_h_tol: float | None = None,
                           on_slice=None, trace: list | None = None,
                           recipe: SolverRecipe | None = None,
                           device="cuda"):
    """Run a multi-K sweep of ``len(seeds)`` (k, seed) tasks with the JAX
    package's packed contract: results in task order, ``spectra (R, K_max,
    g)`` with exact zeros beyond each task's k, ``usages (R, n, K_max) |
    None``, ``errs (R,)``, and per-(seed, k) spectra bit-identical to the
    per-K sweeps'.

    An adapter over :func:`replicate_sweep`, for the API's sake: the JAX
    package runs every task at ``K_max`` with zero-padded components so
    that XLA compiles one executable for every K. Eager PyTorch compiles
    nothing per K, so here the tasks of each K run as that K's
    :func:`replicate_sweep` (in slices of ``replicates_per_batch`` when it
    is given) and the outputs are padded to ``K_max``. ``cNMF.factorize``
    does not call it: its per-K sweeps are the same work.

    ``X`` is dense or scipy-sparse (densified on the device once; ELL
    input is refused, as are ``init != 'random'`` and the hals and sketch
    recipes). ``on_slice(task_indices, spectra (r, K_max, g), errs (r,))``
    is called with numpy results as each slice completes, and the function
    then returns ``None``. ``trace`` receives each slice's entries (as
    :func:`replicate_sweep`'s) before ``on_slice`` is called for it."""
    if isinstance(X, EllMatrix):
        raise ValueError(
            "replicate_sweep_packed does not support ELL-encoded X; use "
            "per-K replicate_sweep calls (packed=False)")
    if init != "random":
        raise ValueError("packed K-sweeps require init='random'")
    if mode not in ("online", "batch"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    Xd = dense_on_device(X, dev)
    n, g = Xd.shape
    beta = beta_loss_to_float(beta_loss)
    if recipe is None:
        recipe = resolve_recipe(beta, mode, n=n, g=g,
                                k=max((int(v) for v in ks), default=None))
    if recipe.algo == "hals":
        raise ValueError("packed K-sweeps run the mu-family recipes only; "
                         "use per-K replicate_sweep calls for hals")
    if recipe.algo == "sketch":
        raise ValueError("packed K-sweeps run the exact mu-family "
                         "programs; use per-K replicate_sweep calls for "
                         "the sketch recipe")
    ks = [int(v) for v in ks]
    if len(ks) != len(seeds):
        raise ValueError("ks and seeds must have equal length")
    if not seeds:
        return (np.zeros((0, 0, g), np.float32),
                np.zeros((0, n, 0), np.float32) if return_usages else None,
                np.zeros((0,), np.float32))
    kmax = max(ks)
    by_k: dict[int, list[int]] = {}
    for i, kv in enumerate(ks):
        by_k.setdefault(kv, []).append(i)
    kw = dict(beta_loss=beta_loss, mode=mode, tol=tol,
              online_chunk_size=online_chunk_size,
              online_chunk_max_iter=online_chunk_max_iter,
              batch_max_iter=batch_max_iter, n_passes=n_passes,
              alpha_W=alpha_W, l1_ratio_W=l1_ratio_W, alpha_H=alpha_H,
              l1_ratio_H=l1_ratio_H, online_h_tol=online_h_tol,
              replicates_per_batch=replicates_per_batch,
              return_usages=return_usages, trace=trace, recipe=recipe,
              device=dev)
    order, parts = [], []
    for kv in sorted(by_k):
        idxs = by_k[kv]
        step = replicates_per_batch or len(idxs)
        for start in range(0, len(idxs), step):
            sl_idx = idxs[start:start + step]
            spectra, usages, errs = replicate_sweep(
                Xd, [seeds[i] for i in sl_idx], kv, **kw)
            spectra = np.pad(spectra, ((0, 0), (0, kmax - kv), (0, 0)))
            if return_usages:
                usages = np.pad(usages, ((0, 0), (0, 0), (0, kmax - kv)))
            if on_slice is not None:
                on_slice(sl_idx, spectra, errs)
                continue
            order.extend(sl_idx)
            parts.append((usages, spectra, errs))
    if on_slice is not None:
        return None
    inv = np.argsort(np.asarray(order))
    return (np.concatenate([p[1] for p in parts])[inv],
            (np.concatenate([p[0] for p in parts])[inv]
             if return_usages else None),
            np.concatenate([p[2] for p in parts])[inv])
