"""Row-sharded NMF on a one-rank group — the atlas path.

Port of ``cnmf_torch_tpu/parallel/rowshard.py``. The JAX package shards
the cells axis of the normalized matrix over a device mesh and keeps the
small factors replicated: H rows live with their X rows (the usage
subproblem needs no communication), and the W subproblem needs only the
k x g / k x k statistics ``A = H^T X`` and ``B = H^T H`` (beta=2), or the
MU numerator and denominator (beta in {1, 0}), summed over the shards.
Here the group has one rank: every sum over the cells axis goes through
:func:`_psum`, the identity while ``group`` is ``None`` (the multi-device
slice plugs ``torch.distributed.all_reduce`` in there), so the per-rank
program is the whole solve on one card.

* Staging: :func:`stream_rows_to_mesh` (dense, through the pipelined
  host-to-card stream of ``parallel/streaming.py``; CSR slabs densify on
  the card), :func:`stream_ell_to_mesh` (a CSR matrix or store as the
  dual ELL encoding, whose KL statistics are the CUDA kernels of
  ``csrc/kl_ell.cu`` on the card) and :func:`prepare_rowsharded`.
* :func:`_rowsharded_pass`: one block-coordinate pass — the usage solve
  of the whole shard with W fixed, then the W update from the summed
  statistics and the objective (a dense pass's elementwise work in row
  blocks of ``DENSE_BLOCK_ELEMS``). On the ELL lane with beta=1 the pass
  runs ``h_stats`` (usage solve), ``w_numer`` (W numerator) and
  ``beta_err_partials`` (objective); a pinned ``dna`` recipe runs
  ``h_newton_stats`` and ``wh_at_nz`` in the usage solve instead.
* :func:`nmf_fit_rowsharded`: the pass loop, one host loop with or
  without pass checkpoints (``runtime/checkpoint.py``; the JAX package's
  fused while_loop and its checkpointed host loop are one loop here, so
  checkpointing on or off gives the same bits); a store over the
  resident-shard budget runs the slab-looped tier
  (:func:`_fit_rowsharded_ooc`), within solver tolerance of the resident
  solve.
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
from ..ops.sparse import (EllMatrix, _pad_width, csr_to_ell, ell_beta_err,
                          ell_is_w_stats, ell_row_width, resolve_sparse_beta)
from ..utils.shardstore import ShardStore, SlabCursor
from .replicates import TRACE_LEN
from .streaming import StreamStats, put_arrays, stream_store, stream_to_device

__all__ = ["nmf_fit_rowsharded", "fit_h_rowsharded", "refit_w_rowsharded",
           "pad_rows_to_mesh", "stream_rows_to_mesh", "stream_ell_to_mesh",
           "prepare_rowsharded", "store_dispatch", "dense_pass_bytes"]


def _psum(t, group=None):
    """Sum a per-rank statistic over the cells group: the identity on the
    one-rank group (``group=None``)."""
    if group is not None:
        raise NotImplementedError(
            "row-sharded solves across ranks come with the multi-device "
            "slice (ROADMAP item 4); this build runs a one-rank group")
    return t


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


def stream_rows_to_mesh(X, device, pad_multiple: int | None = None,
                        stats: StreamStats | None = None, events=None):
    """A host matrix (dense or CSR) or a shard store (:class:`ShardStore`
    or :class:`SlabCursor`) as a dense f32 tensor on ``device``, rows
    zero-padded to ``pad_multiple`` (default 1), through the pipelined
    stream (``parallel/streaming.py``): the dense matrix never exists on
    the host, and a store streams slab by slab from disk. Returns
    ``(X_device, pad)``; the staged tensor is the same bits whatever the
    source."""
    from ..runtime.faults import maybe_fail

    maybe_fail("upload", context="stream_rows_to_mesh")
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


def _store_csr(store: ShardStore, events=None):
    """A CSR store's whole matrix on the host (the one shard of a
    one-rank group), and its ELL row width from the manifest."""
    if store.format != "csr":
        raise TypeError("stream_ell_to_mesh needs a CSR-format store")
    return (store.row_block(0, store.n_rows, events=events),
            _pad_width(int(store.max_row_nnz) if store.n_rows else 1))


def stream_ell_to_mesh(X, device, width: int | None = None,
                       transpose: bool = True,
                       stats: StreamStats | None = None, events=None):
    """A host CSR matrix or a CSR :class:`ShardStore` as the dual ELL
    encoding on ``device`` — the beta != 2 sparse staging: bytes scale
    with ``rows x width``, not ``rows x genes``, and the KL statistics run
    on the stored slots only (the CUDA kernels on a card). ``width``
    defaults to the max row nnz padded to 8 (the store's manifest gives
    it without a data pass); the transpose index set (``rows_t``,
    ``perm_t``; the W step's) is built unless ``transpose=False`` (a
    usage-only refit). The encoding is the in-memory matrix's whatever
    the source. Returns ``(EllMatrix, pad)`` with ``pad = 0``."""
    t_wall = time.perf_counter()
    if isinstance(X, ShardStore):
        X, w_store = _store_csr(X, events=events)
        width = w_store if width is None else width
    elif not sp.issparse(X):
        raise TypeError(
            "stream_ell_to_mesh takes a scipy-sparse matrix or a ShardStore")
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


def prepare_rowsharded(X, device, stats: StreamStats | None = None,
                       events=None):
    """Stage a counts matrix (host or store) once for many row-sharded
    solves: ``(X_device, n_orig)`` for :func:`nmf_fit_rowsharded` and
    :func:`fit_h_rowsharded`."""
    n_orig = int(X.shape[0])
    Xd, _ = stream_rows_to_mesh(X, device, stats=stats, events=events)
    return Xd, n_orig


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _n_rows(X) -> int:
    return int(X.vals.shape[0] if isinstance(X, EllMatrix) else X.shape[0])


def _rowsharded_pass(X, H, W, beta, h_tol, chunk_max_iter, l1_H, l2_H, l1_W,
                     l2_W, kl_newton: bool = False, sketch=None,
                     pass_idx: int = 0, group=None):
    """One block-coordinate pass over this rank's rows and the W update
    from the summed statistics. ``H (1, n, k)``, ``W (1, k, g)``.

    ``kl_newton`` (beta=1, the dna recipe): the usage solve takes
    Diagonalized-Newton steps. ``sketch`` (``(rows, exact_every)``, beta=1,
    the sketch recipe): the usage solve and the objective stay exact, the
    W statistics come from ``rows`` sampled rows of this rank (drawn from
    ``pass_idx``), and every ``exact_every``-th pass (pass 0 too) is exact.

    Returns ``(H, W, err (1,), A, B)``; ``(A, B)`` are the pass's summed
    beta=2 statistics (``H^T X``, ``H^T H``), which the checkpoint keeps,
    and ``None`` for beta != 2."""
    A = B = None
    WWT = W @ W.mT if beta == 2.0 else None
    ell = isinstance(X, EllMatrix)
    rows = 0 if ell else _dense_row_block(X)
    H = _chunk_h_solve(X, H, W, WWT, beta, l1_H, l2_H, chunk_max_iter, h_tol,
                       kl_newton=kl_newton, row_block=rows)
    if beta == 2.0:
        A = _psum(H.mT @ X, group)
        B = _psum(H.mT @ H, group)
        W = _solve_w_from_stats(W, A, B, l1_W, l2_W, chunk_max_iter, h_tol,
                                None)
    elif beta == 1.0 and sketch is not None:
        n_loc = _n_rows(X)
        m = min(int(sketch[0]), n_loc)
        exact_now = pass_idx % max(int(sketch[1]), 1) == 0
        if exact_now:
            numer_l = (kl_ell.kl_w_numer(X, H, W) if ell
                       else _dense_w_stats(X, H, W, beta, rows)[0])
            hsum_l = H.sum(1)
        else:
            idx = _sketch_rows(pass_idx, m, n_loc, 2, None, H.device)
            hs = H[:, idx]
            if ell:
                numer_l, _ = kl_ell.kl_w_stats_rows(X, H, W, idx)
            else:
                numer_l = hs.mT @ (X[idx] / torch.clamp_min(hs @ W, EPS))
            hsum_l = hs.sum(1)
        numer = _psum(numer_l, group)
        denom = _psum(hsum_l, group)[:, :, None].expand(W.shape)
        # exact passes apply the plain rate (a dead entry decays); a
        # sketched pass holds zero-evidence entries and scales the
        # penalties by the sampled fraction
        if exact_now:
            W = _apply_rate(W, numer, denom, l1_W, l2_W)
        else:
            sc = m / float(n_loc)
            W = _apply_rate_sketched(W, numer, denom, l1_W * sc, l2_W * sc)
        if ell:
            return H, W, _psum(kl_ell.kl_beta_err(X, H, W), group), A, B
    elif ell:
        if beta == 1.0:
            numer = _psum(kl_ell.kl_w_numer(X, H, W), group)
            denom = _psum(H.sum(1), group)[:, :, None].expand(W.shape)
        else:  # beta == 0.0: the IS hybrid, dense WH denominator
            numer, denom = ell_is_w_stats(X, H, W)
            numer, denom = _psum(numer, group), _psum(denom, group)
        W = _apply_rate(W, numer, denom, l1_W, l2_W, gamma=mu_gamma(beta))
        err = (kl_ell.kl_beta_err(X, H, W) if beta == 1.0
               else ell_beta_err(X, H, W, beta))
        return H, W, _psum(err, group), A, B
    else:
        numer, denom, _ = _dense_w_stats(X, H, W, beta, rows)
        numer, denom = _psum(numer, group), _psum(denom, group)
        if beta == 1.0:
            denom = denom[:, :, None].expand(W.shape)
        W = _apply_rate(W, numer, denom, l1_W, l2_W, gamma=mu_gamma(beta))
    # the cancellation-safe per-element objective of the updated (H, W)
    err = _psum(_dense_err(X, H, W, beta, rows), group)
    return H, W, err, A, B


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
    """The dense MU W statistics of beta in {1, 0} on this rank's rows,
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
    rows past the cell count are zero)."""
    h_np = np.asarray(h_np, np.float32)
    if h_np.shape[0] > n_pad:
        return h_np[:n_pad]
    if h_np.shape[0] < n_pad:
        return np.pad(h_np, ((0, n_pad - h_np.shape[0]), (0, 0)))
    return h_np


def _fit_rowsharded_loop(X, H0, W0, beta, tol, h_tol, n_passes,
                         chunk_max_iter, l1_H, l2_H, l1_W, l2_W, ckpt=None,
                         n_orig=None, kl_newton: bool = False, sketch=None,
                         group=None):
    """The pass loop: passes of :func:`_rowsharded_pass` until the
    objective's relative improvement drops below ``tol`` or ``n_passes``
    ran, with one host read of the objective a pass.

    ``ckpt`` (a ``runtime.checkpoint.PassCheckpointer``): every
    ``ckpt.every`` passes W, the pass statistics, the cursor and (under
    the byte budget) H land on disk, and a valid checkpoint resumes the
    loop mid-run, bit for bit when it holds H; without H, H re-derives
    from the restored W. The same loop runs without a checkpointer, so
    the two give the same bits.

    Returns ``(H (1, n, k), W (1, k, g), err, trace (TRACE_LEN,),
    passes, nonfinite)``."""
    dev = W0.device
    k, g = int(W0.shape[-2]), int(W0.shape[-1])
    n_pad = int(H0.shape[1])

    def one_pass(H, W, pass_idx):
        return _rowsharded_pass(X, H, W, beta, h_tol, chunk_max_iter, l1_H,
                                l2_H, l1_W, l2_W, kl_newton=kl_newton,
                                sketch=sketch, pass_idx=pass_idx,
                                group=group)

    cur = _PassCursor(tol)
    ran_pass = False
    state = None
    if ckpt is not None:
        state = (ckpt.load(n_rows_min=int(n_orig), n_genes=g)
                 if n_orig is not None else ckpt.load(n_rows=n_pad,
                                                      n_genes=g))
    if state is not None:
        W = torch.as_tensor(state["W"]).to(dev)[None]
        H = (H0 if state["H"] is None else
             torch.as_tensor(_restore_h(state["H"], n_pad)).to(dev)[None])
        resumed_without_h = state["H"] is None
        cur.restore(state)
        A, B = state["A"], state["B"]
    else:
        resumed_without_h = False
        H, W, err0, A, B = one_pass(H0, W0, 0)
        ran_pass = True
        cur.start(float(err0[0]))

    def save():
        # the H byte budget gates the device-to-host copy itself
        cur.save(ckpt, W, A, B, H[0].cpu().numpy()
                 if n_pad * k * 4 <= ckpt.h_budget else None)

    if ran_pass and cur.due(ckpt):
        save()
    obs_metrics.counter_inc("cnmf_rowshard_passes_total")
    while cur.active(n_passes, sketch):
        H, W, err_new, A, B = one_pass(H, W, cur.it)
        ran_pass = True
        cur.advance(float(err_new[0]))
        if cur.due(ckpt):
            save()
        obs_metrics.counter_inc("cnmf_rowshard_passes_total")
    if resumed_without_h and not ran_pass:
        # a converged checkpoint without H: W is final; the usages come
        # from one fixed-W solve
        H = _chunk_h_solve(X, H0, W, W @ W.mT if beta == 2.0 else None,
                           beta, l1_H, l2_H, chunk_max_iter, h_tol,
                           row_block=0 if isinstance(X, EllMatrix)
                           else _dense_row_block(X))
    return H, W, float(cur.err), cur.trace, cur.it, cur.nonfinite()


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
                   force_dense: bool = False, device=None):
    """How a store-backed row-sharded solve ingests: ``(use_ell,
    slab_loop)``. ``use_ell`` is the in-memory dispatch (the manifest's
    density and width stand in for a data pass); ``slab_loop`` is True
    when the resident shard would exceed the shard budget and the dense
    random-init lane (the only one with a slab-looped pass) applies.
    ``force_dense`` (``cNMF.factorize``, which stages dense like its
    in-memory twin): the budget is sized with dense bytes. A dense shard
    is charged its pass's working set (:func:`dense_pass_bytes`)."""
    n = store.n_rows
    use_ell = False
    w_ell = 0
    if not force_dense and store.format == "csr" and init == "random":
        w_ell = _pad_width(int(store.max_row_nnz) if n else 1)
        use_ell = resolve_sparse_beta(beta, density=store.density,
                                      width=w_ell, g=store.n_genes)
    shard_bytes = (max(n, 1) * w_ell * 8 if use_ell
                   else dense_pass_bytes(n, store.n_genes))
    over = shard_bytes > _ooc_shard_budget_bytes(device)
    if over and (use_ell or init != "random"):
        warnings.warn(
            "shard store: the shard (%d bytes) exceeds the resident budget "
            "but the %s lane has no slab-looped pass program — staging "
            "resident anyway"
            % (shard_bytes, "ELL" if use_ell else f"init={init!r}"),
            RuntimeWarning, stacklevel=2)
        over = False
    return use_ell, over and beta in (2.0, 1.0, 0.0)


def _sketch_of(recipe):
    """The sketch recipe's ``(rows, exact_every)`` (at least one row);
    ``None`` for the other recipes."""
    if recipe.algo != "sketch":
        return None
    return (max(1, int(recipe.sketch_dim)), int(recipe.sketch_exact_every))


def _ooc_group_pass(Xg, Hg, W, A, B, err_acc, beta, h_tol, chunk_max_iter,
                    l1_H, l2_H, kl_newton: bool = False, sketch=None,
                    pass_idx: int = 0, group_idx: int = 0, group=None):
    """One slab group's share of a slab-looped pass: its usage block
    solved with W fixed, then beta=2 adds its statistics to the carried
    ``(A, B)``; beta in {1, 0} returns the group's MU numerator and
    denominator (in ``A``/``B``'s place) for the caller's per-group W
    step. The objective accumulates in ``err_acc``; groups add strictly
    in order. Returns ``(Hg, A', B', err')``."""
    WWT = W @ W.mT if beta == 2.0 else None
    rows = _dense_row_block(Xg)
    h = _chunk_h_solve(Xg, Hg, W, WWT, beta, l1_H, l2_H, chunk_max_iter,
                       h_tol, kl_newton=kl_newton, row_block=rows)
    if beta == 2.0:
        A = A + _psum(h.mT @ Xg, group)
        B = B + _psum(h.mT @ h, group)
        err = err_acc + _psum(_dense_err(Xg, h, W, beta, rows), group)
        return h, A, B, err
    if (beta == 1.0 and sketch is not None
            and pass_idx % max(int(sketch[1]), 1) != 0):
        # a sketched pass: the group's ratio whole, its sampled rows'
        # statistics
        WH = torch.clamp_min(h @ W, EPS)
        m = min(int(sketch[0]), int(h.shape[1]))
        idx = _sketch_rows(group_idx, m, int(h.shape[1]), 3, None, h.device)
        hs = h[:, idx]
        numer_l, denom_l = hs.mT @ (Xg / WH)[:, idx], hs.sum(1)
        err_l = _beta_div_dense(Xg, WH, beta)
    else:
        numer_l, denom_l, err_l = _dense_w_stats(Xg, h, W, beta, rows,
                                                 with_err=True)
    numer, denom = _psum(numer_l, group), _psum(denom_l, group)
    if beta == 1.0:
        denom = denom[:, :, None].expand(W.shape)
    return h, numer, denom, err_acc + _psum(err_l, group)


def _fit_rowsharded_ooc(store, k, beta, seed, tol, h_tol, n_passes,
                        chunk_max_iter, l1_H, l2_H, l1_W, l2_W, shard_budget,
                        device, ckpt=None, kl_newton: bool = False,
                        sketch=None, events=None,
                        stats: StreamStats | None = None,
                        init_factors=None, group=None):
    """Slab-looped out-of-core solve: X never becomes resident. Each pass
    streams slab groups (resident bytes bounded by ``shard_budget``) from
    the store, solves each group's usage block with W fixed and
    accumulates the pass statistics; H stays on the card as one block a
    group. This is the online solver's block-coordinate pass with the
    group as the chunk: beta=2 solves W once a pass from the accumulated
    statistics, beta in {1, 0} takes one MU W step a group. It is within
    solver tolerance of the resident pass, not bit for bit (the resident
    pass solves its usage block jointly). The stopping rule, the pass cap
    and the checkpoint protocol are the resident loop's.

    Returns ``(H (n_pad, k) np, W (k, g) np, err, trace, passes,
    nonfinite)``."""
    n_orig, g = store.shape
    k = int(k)
    rows = max(8, int(shard_budget) // max(g * 4, 1))
    group_rows = min(rows, max(n_orig, 1))
    n_groups = max(-(-n_orig // group_rows), 1)
    n_pad = n_groups * group_rows

    def split_h(H_full):
        return [torch.as_tensor(np.ascontiguousarray(
            H_full[gi * group_rows:(gi + 1) * group_rows],
            dtype=np.float32)).to(device)[None] for gi in range(n_groups)]

    if init_factors is None:
        # the manifest's f64 value sum stands in for the resident path's
        # on-device mean
        H0_full, W0 = random_init(int(seed), n_pad, g, k,
                                  store.value_sum / max(n_pad * g, 1))
    else:
        H0_full, W0 = (torch.as_tensor(np.array(a, np.float32))
                       for a in init_factors)
    H_groups = split_h(_restore_h(H0_full.numpy(), n_pad))
    del H0_full
    W = W0.to(device)[None]

    def stage_group(gi):
        lo = gi * group_rows
        hi = min(lo + group_rows, n_orig)
        return stream_store(SlabCursor(store, rows=(lo, hi), events=events),
                            device, stats=stats, events=events,
                            pad_rows=group_rows - (hi - lo))

    zero_A = torch.zeros((1, k, g), dtype=torch.float32, device=device)
    zero_B = torch.zeros((1, k, k), dtype=torch.float32, device=device)
    zero_err = torch.zeros((1,), dtype=torch.float32, device=device)

    def one_pass(W, pass_i):
        A, B, err_acc = zero_A, zero_B, zero_err
        for gi in range(n_groups):
            Xg = stage_group(gi)
            Hg, A, B, err_acc = _ooc_group_pass(
                Xg, H_groups[gi], W, A, B, err_acc, beta, h_tol,
                chunk_max_iter, l1_H, l2_H, kl_newton=kl_newton,
                sketch=sketch, pass_idx=pass_i,
                group_idx=pass_i * n_groups + gi, group=group)
            if beta != 2.0:
                if (sketch is not None and beta == 1.0
                        and pass_i % max(int(sketch[1]), 1) != 0):
                    sc = min(1.0, sketch[0] / max(group_rows, 1))
                    W = _apply_rate_sketched(W, A, B, l1_W * sc, l2_W * sc)
                else:
                    W = _apply_rate(W, A, B, l1_W, l2_W,
                                    gamma=mu_gamma(beta))
                A, B = zero_A, zero_B
            del Xg
            H_groups[gi] = Hg
        if beta == 2.0:
            W = _solve_w_from_stats(W, A, B, l1_W, l2_W, chunk_max_iter,
                                    h_tol, None)
            return W, float(err_acc[0]), A, B
        return W, float(err_acc[0]), None, None

    cur = _PassCursor(tol)
    A = B = None
    ran_pass = False
    state = (ckpt.load(n_rows_min=n_orig, n_genes=g)
             if ckpt is not None and ckpt.every > 0 else None)
    if state is not None:
        W = torch.as_tensor(state["W"]).to(device)[None]
        if state["H"] is not None:
            H_groups = split_h(_restore_h(state["H"], n_pad))
        cur.restore(state)
        A, B = state["A"], state["B"]
    else:
        W, err0, A, B = one_pass(W, 0)
        ran_pass = True
        cur.start(err0)

    def save():
        cur.save(ckpt, W, A, B, torch.cat(H_groups, dim=1)[0].cpu().numpy()
                 if n_pad * k * 4 <= ckpt.h_budget else None)

    if ran_pass and cur.due(ckpt):
        save()
    obs_metrics.counter_inc("cnmf_rowshard_passes_total")
    while cur.active(n_passes, sketch):
        W, err_new, A, B = one_pass(W, cur.it)
        cur.advance(err_new)
        if cur.due(ckpt):
            save()
        obs_metrics.counter_inc("cnmf_rowshard_passes_total")
    H = torch.cat(H_groups, dim=1)[0].cpu().numpy()
    return (H, W[0].cpu().numpy(), float(cur.err), cur.trace, cur.it,
            cur.nonfinite())


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


def nmf_fit_rowsharded(X, k: int, beta_loss="frobenius", seed: int = 0,
                       tol: float = 1e-4, h_tol: float = 0.05,
                       n_passes: int | None = None,
                       chunk_max_iter: int = 1000, alpha_W: float = 0.0,
                       l1_ratio_W: float = 0.0, alpha_H: float = 0.0,
                       l1_ratio_H: float = 0.0, n_orig: int | None = None,
                       init: str = "random", telemetry_sink=None,
                       checkpoint=None, recipe=None, events=None,
                       store_slab_loop: bool = False, init_factors=None,
                       device="cuda", group=None):
    """Factorize a cells-sharded X. Returns ``(H (n, k), W (k, g), err)``
    as numpy arrays and a float.

    ``X``: a host matrix (dense or CSR, staged through the stream), a
    tensor or :class:`EllMatrix` already on the device (from
    :func:`prepare_rowsharded` / :func:`stream_ell_to_mesh`; pass its
    ``n_orig``), or a :class:`ShardStore`. A CSR matrix or store with
    beta in {1, 0} under the ELL rule (and the random init) stages as ELL,
    and its KL statistics are the CUDA kernels on the card. A store under
    the resident budget stages resident (bit for bit the in-memory
    staging); over it, the dense random-init solve runs the slab-looped
    tier (``store_slab_loop`` forces that tier: the caller sized the
    decision).

    ``init_factors``: an explicit ``(H0 (n, k), W0 (k, g))``, else the
    init of ``init`` from ``seed`` (``random``: ``ops/nmf.py:random_init``
    at ``mean(X)``; the nndsvd family from the gram,
    ``ops/nmf.py:nndsvd_init_gram``). ``checkpoint``: a
    ``runtime.checkpoint.PassCheckpointer`` (see
    :func:`_fit_rowsharded_loop`). ``recipe``: the resolved
    ``SolverRecipe`` (``dna`` threads Newton usage steps into the pass,
    ``sketch`` the sampled W statistics), else resolved from the knobs for
    ``rowshard``. ``events`` receives the staging of a host matrix or
    store as the ``rowshard_staging`` stream (the ELL encoding's host time
    under ``host_prep_s``) and the slab-looped tier's as
    ``rowshard_ooc_passes``. ``telemetry_sink`` receives the solve's
    convergence record
    (per-pass objectives, passes, the nonfinite flag; the JAX package's
    payload keys).

    The pass schedule is the online solver's (``resolve_online_schedule``),
    so crossing the row-shard threshold keeps the convergence schedule."""
    dev = resolve_device(device)
    beta = beta_loss_to_float(beta_loss)
    _, n_passes, _ = resolve_online_schedule(beta, h_tol, n_passes)
    if beta not in (2.0, 1.0, 0.0):
        raise ValueError(
            f"nmf_fit_rowsharded supports beta in {{2, 1, 0}}, got {beta}")
    l1_W, l2_W = split_regularization(alpha_W, l1_ratio_W)
    l1_H, l2_H = split_regularization(alpha_H, l1_ratio_H)
    ooc_deep = False
    stats = StreamStats()
    if isinstance(X, (torch.Tensor, EllMatrix)):
        Xd = X
        if n_orig is None:
            n_orig = _n_rows(X)
    elif isinstance(X, ShardStore):
        store = X
        n_orig = store.n_rows
        if store_slab_loop:
            use_ell, ooc_deep = False, True
        else:
            use_ell, ooc_deep = store_dispatch(store, beta, init=init,
                                               device=dev)
        if ooc_deep:
            Xd = None
        elif use_ell:
            Xd, _ = stream_ell_to_mesh(store, dev, stats=stats,
                                       events=events)
        else:
            Xd, _ = stream_rows_to_mesh(store, dev, stats=stats,
                                        events=events)
    else:
        n_orig = int(X.shape[0])
        if (sp.issparse(X) and init == "random" and resolve_sparse_beta(
                beta, density=X.nnz / max(X.shape[0] * X.shape[1], 1),
                width=ell_row_width(X), g=X.shape[1])):
            Xd, _ = stream_ell_to_mesh(X, dev, stats=stats, events=events)
        else:
            Xd, _ = stream_rows_to_mesh(X, dev, stats=stats, events=events)
    if events is not None and not ooc_deep and stats.nbytes:
        events.emit_stream("rowshard_staging", stats)
    ell = isinstance(Xd, EllMatrix)
    if recipe is None:
        from ..ops.recipe import resolve_recipe

        if ooc_deep:
            n, g = X.shape
        else:
            n, g = _n_rows(Xd), int(Xd.g if ell else Xd.shape[1])
        recipe = resolve_recipe(beta, "rowshard", ell=ell, n=int(n), g=int(g),
                                k=int(k), ell_width=Xd.width if ell else None)
    if (recipe.kl_newton or recipe.algo == "sketch") and beta != 1.0:
        raise ValueError(
            f"recipe {recipe.label!r} requires beta=1 (KL), got "
            f"beta={beta}")
    sketch = _sketch_of(recipe)
    ckpt = (checkpoint if checkpoint is not None
            and getattr(checkpoint, "every", 0) > 0 else None)
    if ooc_deep:
        H, W, err, trace, passes, nonfin = _fit_rowsharded_ooc(
            X, int(k), beta, int(seed), float(tol), float(h_tol),
            int(n_passes), int(chunk_max_iter), l1_H, l2_H, l1_W, l2_W,
            _ooc_shard_budget_bytes(dev), dev, ckpt=ckpt,
            kl_newton=bool(recipe.kl_newton), sketch=sketch, events=events,
            stats=stats, init_factors=init_factors, group=group)
        if events is not None:
            events.emit_stream("rowshard_ooc_passes", stats)
        if telemetry_sink is not None:
            telemetry_sink(_telemetry_payload(
                k, beta, seed, n_passes, trace, passes, nonfin, err, recipe,
                "dense", mode="rowshard-ooc"))
        return H[:n_orig], W, float(err)

    n = _n_rows(Xd)
    g = int(Xd.g if ell else Xd.shape[1])
    if init_factors is not None:
        H0, W0 = (torch.as_tensor(np.array(a, np.float32)).to(dev)
                  for a in init_factors)
    elif init == "random":
        # the ELL mean counts the implicit zeros
        x_mean = float((Xd.vals.sum() if ell else Xd.sum()) / (n * g))
        H0, W0 = random_init(int(seed) & 0x7FFFFFFF, n, g, int(k), x_mean,
                             device=dev)
    elif ell:
        raise ValueError(
            f"ELL-encoded rowshard solves require init='random', "
            f"got {init!r} (the nndsvd gram base needs the dense matrix)")
    elif init in ("nndsvd", "nndsvda", "nndsvdar"):
        variant = "nndsvdar" if init == "nndsvd" else init
        H0, W0 = nndsvd_init_gram(Xd, int(k), variant,
                                  seed=int(seed) & 0x7FFFFFFF)
    else:
        raise ValueError(f"unknown init {init!r}")
    H, W, err, trace, passes, nonfin = _fit_rowsharded_loop(
        Xd, H0[None].contiguous(), W0[None].contiguous(), beta, float(tol),
        float(h_tol), int(n_passes), int(chunk_max_iter), l1_H, l2_H, l1_W,
        l2_W, ckpt=ckpt, n_orig=n_orig if ckpt is not None else None,
        kl_newton=bool(recipe.kl_newton), sketch=sketch, group=group)
    if telemetry_sink is not None:
        telemetry_sink(_telemetry_payload(
            k, beta, seed, n_passes, trace, passes, nonfin, err, recipe,
            kernel_label(ell, dev, False, beta)))
    return H[0, :n_orig].cpu().numpy(), W[0].cpu().numpy(), float(err)


def fit_h_rowsharded(X, W, h_tol: float = 0.05, chunk_max_iter: int = 200,
                     l1_reg_H: float = 0.0, l2_reg_H: float = 0.0, beta=2.0,
                     seed: int = 0, n_orig: int | None = None, H0=None,
                     device="cuda", events=None) -> np.ndarray:
    """Row-sharded fixed-W usage refit (no communication: W is
    replicated and every H row depends on its own X row), the whole shard
    solved as one block. ``X``: a host matrix (a CSR one under the ELL
    rule stages as ELL without the transpose set, and its KL statistics
    are the ``h_stats`` kernel on the card), a staged tensor or
    :class:`EllMatrix`, or a :class:`ShardStore`. ``H0``: an explicit
    init, else ``uniform(0, 1)`` from ``seed``. Returns numpy ``(n, k)``."""
    from ..ops.nmf import fit_h_default_init

    dev = resolve_device(device)
    beta = beta_loss_to_float(beta)
    if isinstance(X, (torch.Tensor, EllMatrix)):
        Xd = X
        if n_orig is None:
            n_orig = _n_rows(X)
    else:
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
            Xd, _ = stream_ell_to_mesh(X, dev, transpose=False,
                                       events=events)
        else:
            Xd, _ = stream_rows_to_mesh(X, dev, events=events)
    Wt = torch.as_tensor(np.ascontiguousarray(W, dtype=np.float32)).to(dev)
    k = int(Wt.shape[0])
    n = _n_rows(Xd)
    if H0 is None:
        H = fit_h_default_init(n, k, seed=int(seed), device=dev)
    else:
        H = torch.as_tensor(np.array(H0, np.float32)).to(dev)
    W1 = Wt[None]
    H = _chunk_h_solve(Xd, H[None].contiguous(), W1,
                       W1 @ W1.mT if beta == 2.0 else None, beta,
                       float(l1_reg_H), float(l2_reg_H), int(chunk_max_iter),
                       float(h_tol), row_block=0 if isinstance(Xd, EllMatrix)
                       else _dense_row_block(Xd))
    return H[0, :n_orig].cpu().numpy()


def refit_w_rowsharded(X, H, beta=2.0, h_tol: float = 0.05,
                       max_iter: int = 200, l1_reg_W: float = 0.0,
                       l2_reg_W: float = 0.0, seed: int = 0,
                       row_block: int = 100_000, stage: bool | str = "auto",
                       stage_budget_bytes: int | None = None, W0=None,
                       device="cuda") -> np.ndarray:
    """Fixed-usage spectra refit at atlas scale without the transpose
    trick (whose row chunks would be ``chunk x cells`` dense buffers).

    * beta=2: the MU fixed point depends on X only through ``A = H^T X``
      (one sparse host product) and ``B = H^T H``; the MU iterations run
      on the card on k-sized arrays.
    * beta in {1, 0}: each MU step needs WH per row. When the dense matrix
      fits the card's headroom (``stage='auto'``) it is staged once and
      every iteration loops over row blocks on the card; above it, host
      blocks of ``row_block`` rows stream every iteration.

    The stopping rule is :func:`fit_h`'s (relative change of W below
    ``h_tol``, ``max_iter`` cap). ``W0``: an explicit init, else
    ``uniform(0, 1)`` from ``seed``. Returns numpy ``W (k, g)``."""
    dev = resolve_device(device)
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
        stage = n * g * 4 <= budget

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
                      max(n, 8)))
        Xd, pad = stream_rows_to_mesh(X, dev, pad_multiple=blk)
        Hd = torch.as_tensor(np.pad(H, ((0, pad), (0, 0)))).to(dev)[None]
        blocks = [(b, b + blk) for b in range(0, n + pad, blk)]
        # the KL denominator is loop-invariant
        kl_denom = Hd.sum(1)[:, :, None].expand(W.shape)
        for _ in range(int(max_iter)):
            numer = torch.zeros_like(W)
            denom = torch.zeros_like(W) if beta == 0.0 else kl_denom
            for lo, hi in blocks:
                nb, db = block_stats(Xd[lo:hi], Hd[:, lo:hi], W)
                numer = numer + nb
                if beta == 0.0:
                    denom = denom + db
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
