"""The consensus-NMF pipeline: prepare -> factorize -> combine -> consensus
-> k-selection statistics.

Port of ``cnmf_torch_tpu/models/cnmf.py`` (the JAX package, which stays the
reference) for the single-device batched lane. The stages, the path
registry, the replicate seed ledger and the artifact layout are the same,
so the JAX package's ``load_df_from_npz`` reads this port's spectra,
usages, gene scores and k-selection statistics. Differences of format, all
pandas/h5py/PyYAML-free: labelled matrices are :class:`Frame`; the
normalized-counts and TPM intermediates are scipy-sparse (or dense)
``.npz`` files with their names beside them; the solver-parameter file is
JSON at the ``.yaml`` path (JSON is valid YAML).

Every device step runs on ``device`` (default ``"cuda"``; the constructor
raises when no card is present unless the caller asked for ``"cpu"``). On
a sparse count matrix with the Kullback-Leibler or Itakura-Saito loss the
factorize sweep and the consensus usage refit run on the ELL encoding,
whose KL statistics are the CUDA kernels of ``csrc/kl_ell.cu`` on the
card (IS is the dense-WH hybrid, plain torch). Factorize runs the mode and
``algo`` of the run-parameters file: ``online`` and ``mu`` (what
``prepare`` writes), or ``batch`` and ``halsvar`` (set by editing that
file), under the solver recipe resolved from the env knobs
(``ops/recipe.py``: batch KL runs ``dna``, batch IS ``amu``), as one
batched sweep per K or, with ``batched=False``, one ``run_nmf`` call a
task. Both lanes report each replicate's health to one
``runtime/resilience.py`` guard: an unhealthy replicate is retried at
derived seeds and quarantined when its retries fail, and
``skip_completed_runs`` resumes a run from its validated artifacts.
With ``CNMF_TPU_SKETCH`` engaged, consensus clusters a seeded
projection of the spectra (``ops/sketch.py``).

Telemetry, as in the JAX package: every stage (``prepare``,
``factorize``, ``combine``, ``consensus``, ``k_selection_plot``) and the
consensus sub-stages land in ``cnmf_tmp/<name>.timings.tsv`` and, under
``CNMF_TPU_TELEMETRY=1``, in the event stream
``cnmf_tmp/<name>.events.jsonl`` (``utils/telemetry.py``) beside the
dispatch decisions, one ``replicates`` record list per K, the guard's
faults and a device-memory watermark after each stage;
``CNMF_TPU_PROFILE_DIR`` traces each stage with ``torch.profiler``.
Consensus keeps the dense matrices its refits read on the device once an
object (:meth:`cNMF._stage_dense`), and each staging's phase walls land
in the TSV as ``stage_dense:<key>/host_prep|h2d|device|wall``. One
departure: the JAX package's ``consensus`` stage times a file probe, and
here it times the ``consensus`` call itself.

The atlas path, as in the JAX package: at or above ``rowshard_threshold``
cells (default 200,000) ``factorize`` runs the row-sharded solver
(``parallel/rowshard.py``) one replicate at a time on the staged matrix,
with pass checkpoints (``runtime/checkpoint.py``) and resume, and the
consensus refits run row-sharded too (``fit_h_rowsharded`` on the ELL
encoding of a sparse matrix, whose KL statistics are the ``h_stats``
kernel on the card; ``refit_w_rowsharded``). ``prepare`` writes the
row-slab shard store of the normalized counts (``utils/shardstore.py``)
when ``CNMF_TPU_OOC`` asks for it (``auto``: above the host budget;
``1``: always, and the store is then the only copy); factorize streams it
from disk, and consensus and the K-selection statistics stream it slab
by slab when it is the only copy.
"""

from __future__ import annotations

import datetime
import errno
import functools
import itertools
import json
import os
import time
import uuid
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from ..ops.hvg import highvar_genes
from ..ops.kernels import kernel_label
from ..ops.kmeans import kmeans
from ..ops.metrics import local_density as knn_local_density
from ..ops.metrics import pairwise_euclidean, silhouette_score
from ..ops.nmf import (beta_loss_to_float, dense_on_device, fit_h,
                       resolve_online_schedule, run_nmf, run_nmf_use_ell,
                       sweep_x_mean, takes_ell_lane)
from ..ops.ols import ols_all_cols
from ..ops.recipe import resolve_recipe
from ..ops.sketch import project_rows, resolve_consensus_sketch
from ..ops.sparse import (EllMatrix, csr_to_ell, ell_chunk_rows,
                          ell_row_width)
from ..ops.stats import (cell_scale_factors, column_moments_staged,
                         normalize_total, row_sums, scale_columns,
                         scale_hvg_columns_device)
from ..parallel.replicates import (default_mesh, replicate_sweep,
                                   worker_filter)
from ..runtime import faults, resilience
from ..runtime.planner import DeviceInventory, InputStats, build_plan
from ..utils.autotune import maybe_autotune_plan, maybe_autotune_rho
from ..utils.io import (Counts, Frame, atomic_artifact, load_counts,
                        load_df_from_npz, load_df_from_text, load_matrix,
                        peek_matrix, save_df_to_npz, save_df_to_text,
                        save_matrix)
from ..utils.paths import build_paths
from ..utils.profiling import StageTimer, trace
from ..utils.telemetry import EventLog, replicate_records
from . import plots

__all__ = ["cNMF", "compute_tpm", "DensityFilterError"]

_LEDGER_COLUMNS = ["n_components", "iter", "nmf_seed", "completed"]


class DensityFilterError(RuntimeError):
    """Consensus's density filter kept no replicate spectrum; a larger
    ``density_threshold`` keeps more."""


def _positions(names, wanted) -> np.ndarray:
    """Positions of ``wanted`` labels in ``names``; raises on a missing
    label (as a pandas ``.loc`` would)."""
    where = {str(v): i for i, v in enumerate(names)}
    missing = [w for w in wanted if str(w) not in where]
    if missing:
        raise KeyError(f"{len(missing)} label(s) not found, e.g. "
                       f"{missing[:4]}")
    return np.asarray([where[str(w)] for w in wanted], dtype=np.int64)


def _ledger_ints(ledger: Frame, column: str) -> np.ndarray:
    return np.asarray(ledger.column(column), dtype=np.int64)


def compute_tpm(input_counts: Counts, totals=None, device="cuda") -> Counts:
    """Each cell scaled to 1e6 total counts (the JAX package's
    ``compute_tpm``), on ``device``; ``totals`` threads precomputed row
    sums through (one matrix pass). The names and the ``obs``/``var``
    columns are carried over."""
    X = normalize_total(input_counts.X, 1e6, totals,
                        device=resolve_device(device))
    return Counts(X, input_counts.obs_names, input_counts.var_names,
                  obs=dict(input_counts.obs), var=dict(input_counts.var))


def _timed(stage_name: str):
    """Record a pipeline stage in the run's timing ledger (a ``stage``
    event under telemetry), trace it with ``torch.profiler`` when
    ``CNMF_TPU_PROFILE_DIR`` is set, and emit a device-memory watermark at
    its boundary."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            try:
                with self._timer.stage(stage_name), trace(stage_name):
                    return fn(self, *args, **kwargs)
            finally:
                self._events.emit_memory(stage_name)
        return wrapper
    return deco


class cNMF:
    """Consensus NMF over an output-directory artifact store: every
    artifact lives under ``output_dir/name/`` with intermediates in
    ``cnmf_tmp/``; unnamed runs get ``YYYY_MM_DD_<6-hex>`` names."""

    def __init__(self, output_dir: str = ".", name: str | None = None,
                 device="cuda", rowshard_threshold: int = 200_000):
        self.device = resolve_device(device)
        # cell count at which factorize and the consensus refits switch to
        # the row-sharded solvers
        self.rowshard_threshold = int(rowshard_threshold)
        self.output_dir = output_dir
        if name is None:
            now = datetime.datetime.now()
            name = "%s_%s" % (now.strftime("%Y_%m_%d"), uuid.uuid4().hex[:6])
        self.name = name
        self.paths = build_paths(output_dir, name)
        # the run's event stream (inert unless CNMF_TPU_TELEMETRY is set,
        # checked per emit) and the per-stage wall-clock ledger, whose rows
        # mirror into the stream as `stage` events
        tmp = os.path.join(output_dir, name, "cnmf_tmp")
        self._events = EventLog(os.path.join(tmp, name + ".events.jsonl"),
                                manifest_extra={"run_name": name},
                                device=self.device)
        self._timer = StageTimer(os.path.join(tmp, name + ".timings.tsv"),
                                 events=self._events)
        # what the last factorize ran: lane, kernel label, solver recipe
        # and, per K, the solver trace of every slice of replicates
        # (online: ``(passes, R)`` per-pass objectives; batch: a
        # ``SolverTelemetry``) and, for dna, each replicate's fallback
        # fraction; and what the retries and quarantines did
        self.factorize_info: dict = {}
        # per K, the consensus stage's sketch decision (and, under
        # "k_selection", the sweep-level one of k_selection_stats)
        self.consensus_info: dict = {}
        # while a factorize path runs under CNMF_TPU_TELEMETRY: per K, the
        # solver iterations its `replicates` events record (the pass
        # multiplicity of its `perf_model` event), else None
        self._perf_iters: dict | None = None
        # the streamed consensus passes' StreamStats (walls, bytes, host
        # residency peak) by context
        self.stream_stats: dict = {}
        # the ExecutionPlan (runtime/planner.py) the last batched or
        # sequential factorize resolved its dispatch through
        self.plan = None
        # consensus residency: key -> (content token, dense device
        # tensor) of the matrices the refits read (:meth:`_stage_dense`)
        self._dev_cache: dict = {}

    # dense device bytes above which consensus matrices are not kept
    # resident (the JAX package's budget)
    _DEV_CACHE_BUDGET_BYTES = 2 << 30

    def _stageable(self, X) -> bool:
        n, g = X.shape
        return (n < self.rowshard_threshold
                and n * g * 4 <= self._DEV_CACHE_BUDGET_BYTES)

    def _refits_dense(self, X) -> bool:
        """True when every usage and spectra refit of ``X`` runs the dense
        lane: neither ``X`` (the usage refits) nor ``X.T`` (the spectra
        refits) takes the ELL lane (``ops/nmf.py:takes_ell_lane``). A
        matrix that does stays on the host (the kernels' path)."""
        beta = beta_loss_to_float(self._solver_params()["beta_loss"])
        return not (takes_ell_lane(X, beta) or takes_ell_lane(X.T, beta))

    @staticmethod
    def _content_token(X) -> tuple:
        """Shape, stored count, f64 sum and a strided 64-value sample: tells
        two same-shape matrices apart for the residency cache."""
        buf = X.data if sp.issparse(X) else np.asarray(X).ravel()
        step = max(1, buf.size // 64)
        return (tuple(X.shape), int(getattr(X, "nnz", buf.size)),
                float(buf.sum(dtype=np.float64)),
                buf[::step][:64].astype(np.float64).tobytes())

    def _stage_dense(self, key: str, X):
        """``X`` as a dense f32 tensor on the device, staged once per
        matrix and reused by every later refit of this object (the JAX
        package's residency cache). The upload runs through the pipelined
        staging engine (``parallel/streaming.py``): a sparse matrix crosses
        as CSR slabs and densifies on the card. Its phase walls land in the
        timings TSV as ``stage_dense:<key>/...`` (:meth:`StreamStats.
        record_to`) and in a ``stream`` event. Returns ``X`` unchanged
        when it is over the residency budget, at or above
        ``rowshard_threshold`` rows, or a sparse KL/IS matrix
        (:meth:`_refits_dense`)."""
        from ..parallel.streaming import StreamStats, stream_to_device

        if not (self._stageable(X) and self._refits_dense(X)):
            return X
        token = self._content_token(X)
        ent = self._dev_cache.get(key)
        if ent is not None and ent[0] == token:
            return ent[1]
        stats = StreamStats()
        Xd = stream_to_device(X, self.device, stats=stats,
                              events=self._events)
        stats.record_to(self._timer, f"stage_dense:{key}")
        self._events.emit_stream(f"stage_dense:{key}", stats)
        self._dev_cache[key] = (token, Xd)
        return Xd

    # ------------------------------------------------------------------
    # prepare
    # ------------------------------------------------------------------

    @_timed("prepare")
    def prepare(self, counts_fn, components, n_iter=100, densify=False,
                tpm_fn=None, seed=None, beta_loss="frobenius",
                num_highvar_genes=2000, genes_file=None, alpha_usage=0.0,
                alpha_spectra=0.0, init="random", total_workers=-1,
                use_gpu=False, batch_size=5000, max_NMF_iter=1000):
        """Load counts, select HVGs, variance-normalize, and write the
        replicate ledger and the solver parameters. ``use_gpu`` is kept for
        the ledger's schema only; ``device`` places the work."""
        dev = self.device
        counts = load_counts(counts_fn, densify=densify)
        if tpm_fn is None:
            # TPM = diag(1e6 / rowsum) @ counts: its moments and the
            # raw-count moments come from one pass over the counts
            totals = row_sums(counts.X, device=dev)
            tpm = compute_tpm(counts, totals=totals, device=dev)
            counts_moments, tpm_moments = column_moments_staged(
                counts.X, row_scale=cell_scale_factors(totals, 1e6),
                device=dev)
        else:
            # an h5ad or 10x TPM stays as stored (the JAX package's rule)
            tpm = load_counts(tpm_fn, densify=densify and not tpm_fn.endswith(
                (".h5ad", ".mtx", ".mtx.gz")))
            tpm_moments, _ = column_moments_staged(tpm.X, device=dev)
            counts_moments, _ = column_moments_staged(counts.X, device=dev)
        # a re-prepare invalidates the consensus residency
        self._dev_cache.clear()
        save_matrix(self.paths["tpm"], tpm.X, tpm.obs_names, tpm.var_names)
        mean, var = tpm_moments
        save_df_to_npz(Frame(np.stack([mean, np.sqrt(var)], axis=1),
                             tpm.var_names, np.asarray(["__mean", "__std"])),
                       self.paths["tpm_stats"])
        hvgs = None
        if genes_file is not None:
            with open(genes_file) as f:
                hvgs = f.read().rstrip().split("\n")
        norm_counts = self.get_norm_counts(
            counts, tpm, num_highvar_genes=num_highvar_genes,
            high_variance_genes_filter=hvgs, tpm_moments=tpm_moments,
            counts_var0=counts_moments[1])
        self.save_norm_counts(norm_counts)
        replicate_params, run_params = self.get_nmf_iter_params(
            ks=components, n_iter=n_iter, random_state_seed=seed,
            beta_loss=beta_loss, alpha_usage=alpha_usage,
            alpha_spectra=alpha_spectra, init=init,
            total_workers=total_workers, use_gpu=use_gpu,
            batch_size=batch_size, max_iter=max_NMF_iter)
        self.save_nmf_iter_params(replicate_params, run_params)

    def get_norm_counts(self, counts: Counts, tpm: Counts,
                        high_variance_genes_filter=None,
                        num_highvar_genes=None, tpm_moments=None,
                        counts_var0=None) -> Counts:
        """HVG subset and unit-variance gene scaling without centering;
        raises on cells with zero HVG counts. ``tpm_moments`` /
        ``counts_var0``: precomputed TPM (mean, var) and raw-count
        population variance over all genes (a column's moments do not
        change under subsetting)."""
        if high_variance_genes_filter is None:
            gene_stats, _ = highvar_genes(
                tpm.X, numgenes=num_highvar_genes,
                precomputed_moments=tpm_moments, device=self.device)
            high_variance_genes_filter = list(
                np.asarray(tpm.var_names)[gene_stats["high_var"]])
        hvgs = [str(v) for v in high_variance_genes_filter]
        pos = _positions(counts.var_names, hvgs)
        X = counts.X[:, pos]
        n = counts.X.shape[0]
        sub_var1 = None
        if counts_var0 is not None and n > 1:
            sub_var1 = np.asarray(counts_var0)[pos] * (n / (n - 1))
        # sparse input: zero-variance genes pass through unchanged; dense
        # input divides by the zero std, as the reference does (NaN)
        X, _ = scale_columns(X, ddof=1, zero_std_to_one=sp.issparse(tpm.X),
                             precomputed_var=sub_var1, out_dtype=np.float32,
                             device=self.device)
        vals = X.data if sp.issparse(X) else X
        if np.isnan(vals).any():
            print("Warning NaNs in normalized counts matrix")
        with atomic_artifact(self.paths["nmf_genes_list"]) as tmp:
            with open(tmp, "w") as f:
                f.write("\n".join(hvgs))
        zerocells = np.asarray(X.sum(axis=1) == 0).reshape(-1)
        if zerocells.any():
            examples = np.asarray(counts.obs_names)[zerocells]
            raise ValueError(
                "Error: %d cells have zero counts of overdispersed genes. "
                "E.g. %s. Filter those cells and re-run or adjust the number "
                "of overdispersed genes. Quitting!"
                % (zerocells.sum(), ", ".join(map(str, examples[:4]))))
        return Counts(X, counts.obs_names, np.asarray(hvgs))

    def save_norm_counts(self, norm_counts: Counts):
        """Write the normalized matrix: the matrix file and/or the
        row-slab shard store (``utils/shardstore.py``).

        ``CNMF_TPU_OOC=auto`` (default) writes the store too when the
        matrix's host bytes exceed the slab budget; ``=1`` writes the
        store and makes it the only copy (the matrix file is skipped);
        ``=0`` writes the matrix file only. Order: remove the old store,
        write (or remove) the matrix file, write the store — each write is
        atomic, so a crash leaves a consistent pair."""
        from ..utils import shardstore

        self._dev_cache.clear()
        mode = shardstore.ooc_mode()
        write_store = mode == "1" or (
            mode == "auto"
            and shardstore.host_matrix_bytes(norm_counts.X)
            > shardstore.ooc_budget_bytes())
        shardstore.remove_store(self.paths["shard_store"])
        if mode == "1" and write_store:
            print("prepare: CNMF_TPU_OOC=1 — normalized counts live in "
                  "the shard store only (matrix file skipped); consensus "
                  "and k-selection stream it slab-wise, resident readers "
                  "assemble it loudly.")
            try:
                os.unlink(self.paths["normalized_counts"])
            except OSError:
                pass
        else:
            save_matrix(self.paths["normalized_counts"], norm_counts.X,
                        norm_counts.obs_names, norm_counts.var_names)
        if write_store:
            with self._timer.stage("prepare.shard_store"):
                shardstore.write_shard_store(
                    self.paths["shard_store"], norm_counts.X,
                    obs_names=norm_counts.obs_names,
                    var_names=norm_counts.var_names, events=self._events)

    def _probe_store(self):
        """This run's shard store, or ``None`` (absent, invalid, or
        ``CNMF_TPU_OOC=0``)."""
        from ..utils import shardstore

        if shardstore.ooc_mode() == "0":
            return None
        store, _reason = shardstore.probe_shard_store(
            self.paths["shard_store"], events=self._events)
        return store

    def _read_norm_counts(self, store=None) -> Counts:
        """The normalized counts: the matrix file when it exists, else
        assembled from the shard store (the only copy under
        ``CNMF_TPU_OOC=1``), loudly, since that holds the whole matrix on
        the host."""
        from ..utils import shardstore

        if os.path.exists(self.paths["normalized_counts"]):
            return load_matrix(self.paths["normalized_counts"])
        if store is None:
            store = self._probe_store()
        if store is None:
            _, reason = shardstore.probe_shard_store(
                self.paths["shard_store"])
            if reason is not None and reason != "missing":
                raise shardstore.TornShardError(
                    "normalized counts are unreadable: the matrix file is "
                    "absent (store-authoritative prepare) and the shard "
                    "store failed validation — re-run prepare. (%s)"
                    % reason)
            return load_matrix(self.paths["normalized_counts"])
        warnings.warn(
            "the normalized-counts matrix file is absent (CNMF_TPU_OOC=1 "
            "store-authoritative prepare); assembling the full matrix from "
            "the shard store on the host", RuntimeWarning, stacklevel=2)
        return self._store_counts(store, with_matrix=True)

    @staticmethod
    def _store_counts(store, with_matrix=False) -> Counts:
        """A shard store as :class:`Counts`: the names always, the matrix
        only ``with_matrix`` (else an all-zero CSR of the right shape that
        no solver reads)."""
        X = (store.to_matrix() if with_matrix
             else sp.csr_matrix(store.shape, dtype=np.float32))
        obs = store.obs_names() or [str(i) for i in range(store.shape[0])]
        var = store.var_names() or [str(j) for j in range(store.shape[1])]
        return Counts(X, np.asarray(obs), np.asarray(var))

    def _store_stale(self, store) -> bool:
        """True when the store disagrees with the matrix file on shape or
        genes (metadata reads only); with no matrix file the store is the
        only copy and never stale by this test."""
        path = self.paths["normalized_counts"]
        if not os.path.exists(path):
            return False
        try:
            shape, var = peek_matrix(path)
            return (shape != tuple(store.shape)
                    or [str(v) for v in var] != list(store.var_names()))
        except Exception as exc:
            warnings.warn(
                "shard store staleness probe failed (%s); treating the "
                "store as stale" % (exc,), RuntimeWarning, stacklevel=2)
            return True

    def _sweep_stale_store(self, store) -> bool:
        """Worker 0's fresh-run sweep: remove the store's orphaned write
        temps, and delete a store that disagrees with the current
        prepare. True when the store was removed."""
        from ..utils import shardstore

        shardstore.sweep_store_temps(self.paths["shard_store"])
        if store is not None and self._store_stale(store):
            warnings.warn(
                "shard store at %s does not match the current prepare's "
                "normalized counts — removing the stale store"
                % self.paths["shard_store"], RuntimeWarning, stacklevel=2)
            shardstore.remove_store(self.paths["shard_store"])
            return True
        return False

    # ------------------------------------------------------------------
    # replicate ledger + solver parameters
    # ------------------------------------------------------------------

    def get_nmf_iter_params(self, ks, n_iter=100, random_state_seed=None,
                            beta_loss="kullback-leibler", alpha_usage=0.0,
                            alpha_spectra=0.0, init="random",
                            total_workers=-1, use_gpu=False,
                            batch_size=5000, max_iter=1000):
        """The (K x iter) task ledger with derived per-run seeds, and the
        persisted solver parameters. Seeds: a master-seeded
        ``np.random.randint(1, 2**31 - 1)`` draw of ``len(ks) * n_iter``
        values consumed in ``product(sorted(set(ks)), range(n_iter))``
        order (the draw length counts duplicate Ks, as the reference's
        does)."""
        if isinstance(ks, int):
            ks = [ks]
        k_list = sorted(set(list(ks)))
        np.random.seed(seed=random_state_seed)
        nmf_seeds = np.random.randint(low=1, high=(2 ** 31) - 1,
                                      size=len(ks) * n_iter)
        rows = []
        for i, (k, r) in enumerate(itertools.product(k_list, range(n_iter))):
            completed = os.path.exists(self.paths["iter_spectra"] % (k, r))
            rows.append([int(k), int(r), int(nmf_seeds[i]), completed])
        values = np.empty((len(rows), 4), dtype=object)
        for i, row in enumerate(rows):
            values[i, :] = row
        replicate_params = Frame(values, np.arange(len(rows)),
                                 np.asarray(_LEDGER_COLUMNS))
        n_completed = sum(r[3] for r in rows)
        if n_completed > 0:
            warnings.warn(
                "{n} runs already appear completed. If this is unexpected, "
                "consider re-initializing the cnmf object with a different "
                "run name or output directory".format(n=n_completed),
                UserWarning)
        # alpha_W / alpha_H are switched with respect to sklearn
        nmf_kwargs = dict(
            alpha_W=alpha_spectra, alpha_H=alpha_usage, l1_ratio_H=0.0,
            l1_ratio_W=0.0, beta_loss=beta_loss, algo="mu", tol=1e-4,
            mode="online", online_chunk_max_iter=max_iter,
            online_chunk_size=batch_size, init=init, n_jobs=total_workers,
            use_gpu=use_gpu)
        return replicate_params, nmf_kwargs

    def update_nmf_iter_params(self):
        """Re-probe the ``iter_spectra`` files and rewrite the ledger's
        ``completed`` column (the JAX package's method). Must not run while
        factorize workers are active."""
        run_params = self._solver_params()
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        ks = _ledger_ints(ledger, "n_components")
        iters = _ledger_ints(ledger, "iter")
        values = np.asarray(ledger.values, dtype=object).copy()
        col = list(np.asarray(ledger.columns)).index("completed")
        for i in range(len(ks)):
            values[i, col] = os.path.exists(
                self.paths["iter_spectra"] % (ks[i], iters[i]))
        remaining = int(sum(not v for v in values[:, col]))
        print("{n} NMF runs are currently incomplete".format(n=remaining))
        self.save_nmf_iter_params(Frame(values, ledger.index, ledger.columns),
                                  run_params)

    def save_nmf_iter_params(self, replicate_params: Frame, run_params):
        # the ledger summary must ride the manifest, which flushes with the
        # FIRST event (prepare's own stage event beats factorize to it)
        self._set_ledger_manifest(replicate_params, run_params)
        save_df_to_npz(replicate_params,
                       self.paths["nmf_replicate_parameters"])
        with atomic_artifact(self.paths["nmf_run_parameters"]) as tmp:
            with open(tmp, "w") as f:
                json.dump(run_params, f, indent=1, sort_keys=True)

    def _set_ledger_manifest(self, replicate_params: Frame, run_params,
                             n_worker_tasks=None):
        """Seed/K summary for the telemetry manifest: set from prepare
        (the ledger's creation) and from factorize (a factorize-only
        worker never saw prepare), before the first emit."""
        if not self._events.enabled or not len(replicate_params.index):
            return
        seeds = _ledger_ints(replicate_params, "nmf_seed")
        ledger = {
            "ks": sorted(set(_ledger_ints(replicate_params,
                                          "n_components").tolist())),
            "n_tasks": int(len(seeds)),
            "seed_min": int(seeds.min()),
            "seed_max": int(seeds.max()),
            "beta_loss": str(run_params.get("beta_loss")),
            "init": str(run_params.get("init", "random")),
            "mode": str(run_params.get("mode", "online"))}
        if n_worker_tasks is not None:
            ledger["n_worker_tasks"] = int(n_worker_tasks)
        self._events.set_manifest_extra(ledger=ledger)

    def _solver_params(self) -> dict:
        with open(self.paths["nmf_run_parameters"]) as f:
            return json.load(f)

    def ledger_components(self) -> list[int]:
        """The sorted distinct Ks of the replicate ledger."""
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        return sorted(set(_ledger_ints(ledger, "n_components").tolist()))

    # ------------------------------------------------------------------
    # factorize
    # ------------------------------------------------------------------

    @_timed("factorize")
    def factorize(self, worker_i=0, total_workers=1,
                  skip_completed_runs=False, batched=True,
                  replicates_per_batch=None, packed=None, rowshard=None,
                  rowshard_threshold: int | None = None, mesh_shape=None,
                  mesh=None):
        """Run this worker's share of the replicate ledger.

        Batched lane (default): the tasks are grouped per K and each group
        runs as one batched replicate sweep (``parallel/replicates.py``) in
        the parameters file's ``mode``. A sparse normalized matrix with a
        KL or IS ledger and the random init takes the ELL lane under the
        dispatch rule (density <= 0.10 and width <= genes / 8): row chunks
        online, the whole matrix with its transpose index set in batch
        mode. The solver recipe is resolved once (``ops/recipe.py``) and
        recorded in ``factorize_info`` and the provenance. Sequential lane
        (``batched=False``, CLI ``--sequential``): each task is one
        ``run_nmf`` call under the recipe recorded once for the run.

        Fault tolerance (``runtime/resilience.py``, as in the JAX
        package): each replicate is graded by ``lane_health``; an
        unhealthy one is retried at derived seeds (``seed XOR attempt``, up
        to ``CNMF_TPU_MAX_RETRIES``) and quarantined in the per-worker
        resilience ledger when the budget runs out; fewer than
        ``CNMF_TPU_MIN_HEALTHY_FRAC`` healthy replicates in a K raise
        ``UnhealthySweepError``. ``skip_completed_runs`` probes and
        validates every artifact (a torn file reruns), carries unresolved
        quarantines, and reruns the batched lane by whole K groups, so a
        resumed run writes bit for bit the files of an uninterrupted one.

        ``packed`` (default None: the JAX planner's rule, a dense
        random-init ``mu`` ledger of >= 4 Ks with <= 32 replicates a K
        across the workers; ``True``/``False`` pin it, CLI
        ``--per-k-programs`` is ``False``) is accepted for parity with the
        JAX package, with its refusals, and recorded in ``factorize_info``
        and the provenance (``batched-packed``). It selects no other work:
        the JAX package packs the Ks into one program so that XLA compiles
        once, and eager PyTorch compiles nothing per K, so a packed run is
        the per-K sweeps and writes their iter spectra.

        The atlas path (``rowshard=True``, or by default when the matrix
        has at least ``rowshard_threshold`` cells — the constructor's
        unless given — and the lane is batched; CLI ``--rowshard``,
        ``--no-rowshard``, ``--rowshard-threshold``): the row-sharded
        solver (``parallel/rowshard.py``) solves one replicate at a time on
        the matrix staged once (dense, as the JAX package stages it, so a
        store-backed run is bit for bit the in-memory one), with pass
        checkpoints every ``CNMF_TPU_CKPT_EVERY_PASSES`` passes and resume
        from them. A shard store written by ``prepare`` is read from disk:
        the row-sharded path streams it, the others assemble it.

        Layouts (``parallel/``, as the JAX package names them): with no
        ``mesh`` the batched sweep and the row-sharded path run on
        ``self.device`` alone (the JAX package spreads them over every
        device; on several H100s the port's spread was slower than one
        card, so it is asked for: ``mesh=parallel.default_mesh()``
        spreads the batched sweep's replicates over every visible card).
        ``mesh_shape`` ``'1d'`` / ``'rowshard'`` forces the row-sharded
        path over the cells mesh (every visible card, or every process's
        cards after ``parallel.multihost.initialize_distributed``);
        ``'2d'`` (or
        ``mesh='2d'``, CLI ``--mesh-2d``) runs the (replicates x cells)
        mesh (``parallel/multihost.py``); ``'grid2d'``/``'grid'`` (or
        ``mesh='grid2d'``, CLI ``--mesh-grid2d``) the (cells x genes) grid
        (``parallel/grid2d.py``). ``mesh`` may also be a
        ``parallel.mesh.Mesh`` whose axes name the layout. A conflicting
        pair raises ``ValueError``. Across processes only process 0 writes
        artifacts. Under ``CNMF_TPU_HEARTBEAT_S`` each worker stamps its
        liveness (``runtime/elastic.py``); a host loss on the row-sharded
        and grid paths (a ``hostloss`` fault or a lost device) re-plans
        the mesh over the survivors, re-stages X and resumes from the pass
        checkpoint (``fault`` events ``host_loss`` and ``remesh``), and on
        the 2-D path reruns the K's sweep.

        Observability (``obs/``): the worker's ``factorize.worker`` span
        (under ``CNMF_TPU_TRACE_SAMPLE``), the
        ``cnmf_factorize_workers_total`` counter and a closing
        ``metrics_snapshot`` (under ``CNMF_TPU_METRICS``), all no-ops with
        the knobs unset."""
        obs_metrics.counter_inc("cnmf_factorize_workers_total")
        # a parent-planted ambient context when present; a direct run
        # mints its own root, so a sampled run always traces
        ctx = obs_tracing.child(obs_tracing.process_context())
        if ctx is None:
            ctx = obs_tracing.new_trace()
        t0 = time.perf_counter()
        try:
            return self._factorize_impl(
                worker_i=worker_i, total_workers=total_workers,
                skip_completed_runs=skip_completed_runs, batched=batched,
                replicates_per_batch=replicates_per_batch, packed=packed,
                rowshard=rowshard, rowshard_threshold=rowshard_threshold,
                mesh_shape=mesh_shape, mesh=mesh)
        finally:
            obs_tracing.emit_span(
                self._events, ctx, "factorize.worker",
                obs_tracing.perf_to_wall(t0),
                (time.perf_counter() - t0) * 1e3, worker=int(worker_i))
            obs_metrics.emit_snapshot(self._events)

    def _factorize_impl(self, worker_i, total_workers, skip_completed_runs,
                        batched, replicates_per_batch, packed, rowshard=None,
                        rowshard_threshold=None, mesh_shape=None, mesh=None):
        from ..parallel.mesh import Mesh, process_count, process_index
        from ..runtime.planner import maybe_apply_plan_env

        # a replayed plan (CNMF_TPU_PLAN, the CLI's --plan) pins the whole
        # dispatch before any knob below resolves; a missing or invalid
        # plan file raises here
        maybe_apply_plan_env()

        # a layout request is checked before any file is read (the JAX
        # package's named layout dispatch)
        if mesh_shape is not None and mesh_shape not in (
                "1d", "rowshard", "2d", "grid2d", "grid"):
            raise ValueError(
                f"mesh_shape={mesh_shape!r}: expected '1d'/'rowshard', "
                "'2d' (replicates x cells), or 'grid2d' (cells x genes)")
        axes = tuple(mesh.axis_names) if isinstance(mesh, Mesh) else None
        wants_2d = (mesh == "2d" or mesh_shape == "2d"
                    or axes == ("replicates", "cells"))
        if mesh_shape in ("1d", "rowshard"):
            if wants_2d:
                raise ValueError(
                    "conflicting execution layouts: mesh requests the "
                    "(replicates x cells) mesh while mesh_shape "
                    "requests the 1-D cells mesh — pass one of them")
            rowshard = True
        grid = (mesh == "grid2d" or mesh_shape in ("grid2d", "grid")
                or axes == ("cells", "genes"))
        if grid and wants_2d:
            raise ValueError(
                "conflicting execution layouts: mesh requests the "
                "(replicates x cells) mesh while mesh_shape requests the "
                "(cells x genes) grid — pass one of them")
        layout_mesh = mesh if isinstance(mesh, Mesh) else None
        if (layout_mesh is None and mesh_shape in ("1d", "rowshard")
                and process_count() == 1):
            # the 1-D layout asked for by name spans every visible card
            layout_mesh = default_mesh(axis_name="cells", device=self.device)
        # only process 0 writes artifacts when the mesh spans processes
        self._writer = process_index() == 0
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        # a shard store defers reading the matrix: the row-sharded path
        # streams it from disk, the resident lanes assemble it below
        store = self._probe_store()
        # worker 0's fresh run sweeps the store's write debris, and a
        # store that disagrees with the current prepare is never read
        if (not skip_completed_runs and int(worker_i) == 0
                and self._sweep_stale_store(store)):
            store = None
        norm = (self._store_counts(store) if store is not None
                else self._read_norm_counts())
        kw = self._solver_params()
        beta = beta_loss_to_float(kw["beta_loss"])
        # the autotuner (utils/autotune.py): the rho scales measure only
        # when the accel knobs explicitly engage amu, the plan points only
        # under CNMF_TPU_AUTOTUNE=1; an existing cache of this device is
        # consumed by the resolvers from here on
        maybe_autotune_rho(beta=beta, device=self.device)
        maybe_autotune_plan(device=self.device)
        mode = kw.get("mode", "online")
        init = kw.get("init", "random")
        algo = kw.get("algo", "mu")
        X = norm.X
        n, g = X.shape
        chunk = int(min(kw.get("online_chunk_size", 5000), n))
        ks = _ledger_ints(ledger, "n_components")
        iters = _ledger_ints(ledger, "iter")
        seeds = _ledger_ints(ledger, "nmf_seed")
        ledger_fn = self.paths["resilience_ledger"]
        my_tasks = list(worker_filter(range(len(ks)), worker_i,
                                      total_workers))
        quarantined_idx: dict[int, int | None] = {}
        if not skip_completed_runs:
            jobs = my_tasks
            if int(worker_i) == 0:
                # a fresh run voids every earlier quarantine record;
                # ledgers of worker indices outside this fleet have no
                # owner to rewrite them
                resilience.sweep_stale_ledgers(ledger_fn,
                                               max(int(total_workers), 1))
        else:
            # probe and validate this worker's own artifacts: a torn file
            # counts as incomplete and its rerun overwrites it atomically
            quarantined_prev = resilience.load_quarantine_records(ledger_fn)
            jobs = []
            # torn-artifact events wait for the ledger manifest below: the
            # first emit flushes the manifest
            deferred_torn: list[dict] = []
            for idx in my_tasks:
                k_t, it_t = int(ks[idx]), int(iters[idx])
                reason = resilience.probe_spectra_file(
                    self.paths["iter_spectra"] % (k_t, it_t), k=k_t,
                    n_genes=g)
                if reason is None:
                    continue
                if (k_t, it_t) in quarantined_prev:
                    attempts = quarantined_prev[(k_t, it_t)]
                    if (attempts is not None
                            and attempts < resilience.max_retries()):
                        # a raised retry budget reruns the lane
                        jobs.append(idx)
                        continue
                    # deliberately absent: rerunning it would burn the
                    # retry ladder again on every resume
                    quarantined_idx[idx] = attempts
                    continue
                if reason != "missing":
                    warnings.warn(
                        "resume: replicate artifact failed validation and "
                        "will be rerun — %s" % reason, RuntimeWarning,
                        stacklevel=2)
                    deferred_torn.append({
                        "path": self.paths["iter_spectra"] % (k_t, it_t),
                        "reason": reason})
                jobs.append(idx)
        # n_worker_tasks counts the tasks needing work (before a resume's
        # whole-K expansion)
        self._set_ledger_manifest(ledger, kw, n_worker_tasks=len(jobs))
        if skip_completed_runs:
            for torn in deferred_torn:
                self._events.emit("fault", kind="torn_artifact",
                                  context=torn)
        if store is not None:
            self._events.emit(
                "dispatch", decision="ooc_ingest",
                context={"slabs": len(store.slabs),
                         "store_bytes": int(store.store_bytes),
                         "format": store.format, "rows": int(store.n_rows),
                         "backend": store.backend.kind,
                         "h5ad_present": os.path.exists(
                             self.paths["normalized_counts"])})
        guard = resilience.ReplicateGuard(
            events=self._events, ledger_path=ledger_fn % int(worker_i))
        self._written: dict[int, int] = {}

        def credit_completed(final_jobs):
            # resume accounting: valid artifacts count as healthy toward
            # the floor, unresolved quarantines toward the total only
            if not skip_completed_runs:
                return
            per_k: dict[int, int] = {}
            for i in set(my_tasks) - set(final_jobs):
                kk = int(ks[i])
                if i in quarantined_idx:
                    guard.carry_quarantined(kk, int(iters[i]),
                                            int(seeds[i]),
                                            attempts=quarantined_idx[i])
                else:
                    per_k[kk] = per_k.get(kk, 0) + 1
            for kk, cnt in per_k.items():
                guard.credit_existing(kk, cnt)

        if skip_completed_runs and not jobs:
            # nothing to solve, but the floor accounting still runs: a
            # resume after a below-floor run must fail as that run did
            self.factorize_info = {"jobs": 0, "written": {}, "retries": [],
                                   "quarantined": []}
            credit_completed(jobs)
            self._record_resilience(guard)
            guard.finalize()
            print("[Worker %d]. All assigned replicates already have valid "
                  "artifacts%s; nothing to resume."
                  % (worker_i, " or quarantine records"
                     if quarantined_idx else ""))
            return

        heartbeat = None
        from ..runtime import elastic

        if elastic.heartbeat_s() > 0:
            heartbeat = elastic.Heartbeat(
                os.path.dirname(self.paths["resilience_ledger"]), self.name,
                int(worker_i), events=self._events)
        if wants_2d and not grid:
            credit_completed(jobs)
            self._factorize_2d(jobs, ks, iters, seeds, norm, kw, worker_i,
                               layout_mesh, replicates_per_batch,
                               store=store)
            return
        if grid:
            credit_completed(jobs)
            self._factorize_rowsharded(jobs, ks, iters, seeds, norm, kw,
                                       guard, worker_i,
                                       resume=skip_completed_runs,
                                       store=store, mesh=layout_mesh,
                                       grid=True, heartbeat=heartbeat)
            return
        if rowshard_threshold is None:
            rowshard_threshold = self.rowshard_threshold
        if rowshard is None:
            # auto only for the batched lane: --sequential keeps its solver
            rowshard = batched and n >= int(rowshard_threshold)
            if rowshard:
                print("factorize: %d cells >= rowshard threshold %d — "
                      "auto-engaging the row-sharded solver (pass "
                      "rowshard=False / --no-rowshard to keep the batched "
                      "replicate sweep)." % (n, int(rowshard_threshold)))
        if rowshard:
            # replicates solve one at a time, so a resume reruns only the
            # incomplete ones
            credit_completed(jobs)
            self._factorize_rowsharded(jobs, ks, iters, seeds, norm, kw,
                                       guard, worker_i,
                                       resume=skip_completed_runs,
                                       store=store, mesh=layout_mesh,
                                       heartbeat=heartbeat)
            return
        if store is not None:
            norm = self._read_norm_counts(store)
            X = norm.X
        if batched and skip_completed_runs:
            # a K with any incomplete replicate reruns this worker's whole
            # K group (quarantined lanes excepted): on the card a lane's
            # last bits can depend on how many lanes share its batched
            # reductions, so only the same groups give the uninterrupted
            # run's files bit for bit
            ks_incomplete = {int(ks[i]) for i in jobs}
            expanded = [i for i in my_tasks if int(ks[i]) in ks_incomplete
                        and i not in quarantined_idx]
            if len(expanded) > len(jobs):
                print("[Worker %d]. Resume reruns %d replicate(s) (whole-K "
                      "groups for K=%s) so resumed sweeps are bit-identical "
                      "to uninterrupted ones."
                      % (worker_i, len(expanded),
                         ",".join(str(k) for k in sorted(ks_incomplete))))
            jobs = expanded
        credit_completed(jobs)
        by_k: dict[int, list] = {}
        for idx in jobs:
            by_k.setdefault(int(ks[idx]), []).append(
                (int(iters[idx]), int(seeds[idx])))
        # the whole dispatch of both lanes in one plan (runtime/planner.py):
        # the lane, the recipe, the bf16 chain and the kernel label, the
        # packed rule, streaming and the serve schedule, each with who
        # decided it (pin > autotuned > heuristic)
        sparse_in = sp.issparse(X)
        density = X.nnz / max(n * g, 1) if sparse_in else 1.0
        overrides = {"packed": packed if batched else False, "layout": "1d",
                     "mesh_devices": (1 if layout_mesh is None
                                      else int(layout_mesh.devices.size)),
                     "ooc_engaged": store is not None}
        if not batched:
            # each run_nmf call resolves its own lane (fp_precision too)
            # and is given the recipe resolved here, unsized
            overrides.update(sequential=True, use_ell=run_nmf_use_ell(
                X, beta, init=init, algo=algo,
                fp_precision=kw.get("fp_precision", "float")))
        plan = build_plan(
            InputStats(
                n=n, g=g, beta=beta, mode=mode, init=init, algo=algo,
                sparse=sparse_in, density=density if sparse_in else None,
                ell_width=ell_row_width(X) if sparse_in else None,
                k_max=int(ks.max()) if ks.size else None, n_ks=len(by_k),
                max_replicates=max((len(t) for t in by_k.values()),
                                   default=0),
                total_workers=max(1, int(total_workers)),
                has_store=store is not None),
            DeviceInventory.probe(self.device), overrides)
        self.plan = plan
        self._events.emit("plan", plan=plan.to_dict(),
                          signature=plan.signature())
        use_ell = plan.use_ell
        if batched and packed:
            if use_ell:
                raise ValueError(
                    "packed K-sweeps run dense only; set "
                    "CNMF_TPU_SPARSE_BETA=0 to keep packed=True, or drop "
                    "packed for the ELL path")
            if init != "random":
                raise ValueError(
                    "packed K-sweeps require init='random' (the nndsvd "
                    "family's SVD base is K-truncated); rerun with "
                    "packed=False / --per-k-programs")
        packed = plan.packed and batched
        X_host = X
        if use_ell:
            Xe = (ell_chunk_rows(X, chunk)[0] if mode == "online"
                  else csr_to_ell(X))
            X = Xe.to(self.device)
            print("factorize: ELL sparse path engaged for beta=%g "
                  "(density %.3f, width %d of %d genes)."
                  % (beta, density, X.width, g))
        elif batched and sparse_in:
            # the plan's dense lane: a host CSR would be re-resolved by the
            # sweep's staging under the static rule, so it gets the matrix
            # dense on the device, once for every K
            X = dense_on_device(X, self.device)
        recipe = plan.solver_recipe()
        bf16 = plan.bf16_ratio
        kernel = plan.kernel
        if batched and sparse_in and beta in (1.0, 0.0):
            self._events.emit(
                "dispatch", decision="ell_vs_dense",
                context={"use_ell": bool(use_ell), "beta": float(beta),
                         "density": round(float(density), 4),
                         "ell_width": int(ell_row_width(X_host)),
                         "genes": int(g), "kernel": kernel})
        self._events.emit("dispatch", decision="solver_recipe",
                          context=recipe.as_context())
        self.factorize_info = {
            "lane": "ell" if use_ell else "dense", "mode": mode,
            "packed": packed,
            "kernel": kernel,
            "solver_recipe": recipe.label,
            "inner_repeats": int(recipe.inner_repeats),
            "kl_newton": bool(recipe.kl_newton), "bf16_ratio": bf16,
            "trace": {}, "errs": {}, "dna_fallback": {}, "jobs": len(jobs)}
        if not batched:
            self._factorize_sequential(jobs, ks, iters, seeds, norm, kw,
                                       recipe, X, guard, worker_i)
            return
        h_tol, n_passes, h_tol_start = resolve_online_schedule(beta)
        self.factorize_info.update(online_h_tol=h_tol, n_passes=n_passes,
                                   online_h_tol_start=h_tol_start)
        self._save_factorize_provenance(
            "batched-" + ("packed" if packed else
                          "ell" if use_ell else "dense"), worker_i, kw)
        sweep_kw = dict(
            beta_loss=kw["beta_loss"], init=init, mode=mode,
            tol=kw.get("tol", 1e-4), online_chunk_size=chunk,
            online_chunk_max_iter=kw.get("online_chunk_max_iter", 1000),
            alpha_W=kw.get("alpha_W", 0.0),
            l1_ratio_W=kw.get("l1_ratio_W", 0.0),
            alpha_H=kw.get("alpha_H", 0.0),
            l1_ratio_H=kw.get("l1_ratio_H", 0.0),
            replicates_per_batch=replicates_per_batch,
            n_rows=n if use_ell else None, recipe=recipe,
            device=self.device, mesh=layout_mesh)
        self._perf_iters = {}
        perf_t0 = time.perf_counter()
        for k, tasks in sorted(by_k.items()):
            its = [t[0] for t in tasks]
            seeds_k = [t[1] for t in tasks]
            print("[Worker %d]. Running %d replicates for k=%d as one "
                  "batched solve." % (worker_i, len(tasks), k))
            if heartbeat is not None:
                heartbeat.beat(phase="sweep", cursor=k)
            faults.maybe_straggle(context="factorize", worker=worker_i)
            trace: list = []
            payloads: list = []
            spectra, _, errs = replicate_sweep(
                X, seeds_k, k, trace=trace, telemetry_sink=payloads.append,
                **sweep_kw)
            spectra, errs = faults.maybe_poison_lanes(k, its, spectra, errs,
                                                      seeds=seeds_k)
            self.factorize_info["trace"][k] = trace
            self.factorize_info["errs"][k] = errs
            if recipe.kl_newton and mode == "batch":
                self.factorize_info["dna_fallback"][k] = np.concatenate(
                    [t.dna_fallback for t in trace])
            healthy = guard.observe(
                k, its, seeds_k,
                resilience.lane_health(errs, spectra=spectra))
            for r, it in enumerate(its):
                if healthy[r]:
                    self._write_iter_spectra(k, it, spectra[r],
                                             norm.var_names)
            for payload in payloads:
                self._emit_replicates_event(payload)
            faults.maybe_kill("factorize", worker_i)

        def rerun(k_r, seeds_r, iters=None, attempt=0):
            # a fresh per-K sweep over the staged X at the derived seeds
            spectra_r, _, errs_r = replicate_sweep(X, seeds_r, k_r,
                                                   **sweep_kw)
            return spectra_r, errs_r

        self._finish_resilience(guard, rerun, norm.var_names, worker_i)
        perf_iters, self._perf_iters = self._perf_iters, None
        self._emit_perf_model(
            "factorize", kernel, n, g, perf_iters,
            time.perf_counter() - perf_t0, beta=beta,
            ell_width=int(ell_row_width(X_host)) if use_ell else None,
            bf16_ratio=bf16)

    def _factorize_rowsharded(self, jobs, ks, iters, seeds, norm, kw, guard,
                              worker_i, resume=False, store=None, mesh=None,
                              grid=False, heartbeat=None):
        """The atlas path: the matrix staged once, dense (as the JAX package
        stages it, so a store-backed run is bit for bit the in-memory one),
        over the cells mesh (``mesh``, else every process's cards when
        ``torch.distributed`` joins processes, else a one-entry mesh on
        ``self.device``), then one row-sharded solve a replicate
        (``parallel/rowshard.py:nmf_fit_rowsharded``). A store whose dense
        shard exceeds the resident budget is not staged: each solve runs
        the slab-looped tier on it. ``grid``: the same shell over the
        (cells x genes) grid (``parallel/grid2d.py``; ``mesh`` a grid mesh,
        else ``mesh_grid2d()``), X staged as tiles.

        Pass checkpoints (``runtime/checkpoint.py``): every
        ``CNMF_TPU_CKPT_EVERY_PASSES`` passes (default 1; 0 off) a
        replicate's pass state lands in ``pass_checkpoint``, pinned to the
        matrix (its digest, or the store's), the solver parameters, the
        recipe, the ingest tier and the layout; a resume
        (``skip_completed_runs``) continues an interrupted replicate from
        it, bit for bit while H fits the checkpoint's byte budget. A
        staging fault (an exhausted upload retry, a stall, a slab torn
        past its re-reads, a remote store down past its retries with no
        cached copy) lands in the resilience ledger before the run aborts.

        Elastic (``runtime/elastic.py``, one process, ``CNMF_TPU_ELASTIC``
        on): a host loss (a ``hostloss`` fault at a pass or replicate
        boundary, or a lost device) re-plans the mesh over the surviving
        entries, re-stages X and re-enters the solve from its pass
        checkpoint (``fault`` events ``host_loss`` and ``remesh``)."""
        import glob

        from ..parallel.grid2d import mesh_grid2d, nmf_fit_grid2d, \
            stage_x_grid
        from ..parallel.mesh import Mesh, global_devices, process_count
        from ..parallel.multihost import local_devices, sync_hosts
        from ..parallel.rowshard import (RowShards, nmf_fit_rowsharded,
                                         prepare_rowsharded, store_dispatch)
        from ..parallel.streaming import (ShardStallError, ShardUploadError,
                                          StreamStats)
        from ..runtime import checkpoint as ckpt_mod
        from ..runtime import elastic
        from ..utils.shardstore import RemoteStoreError, TornShardError

        if mesh is None and grid:
            mesh = mesh_grid2d(device=self.device)
        if mesh is None and process_count() > 1:
            devices, owners = global_devices(local_devices(self.device))
            mesh = Mesh(devices, ("cells",), owners=owners)
        if mesh is None:
            mesh = Mesh([self.device], ("cells",))
        beta = beta_loss_to_float(kw["beta_loss"])
        init = kw.get("init", "random")
        n, g = norm.X.shape
        elastic_on = elastic.elastic_enabled() and not mesh.spans_processes
        if heartbeat is not None:
            heartbeat.beat(phase="stage_x", force=True)
        topo = {"mesh": mesh, "slab_loop": False}

        def stage(mesh_):
            """Stage (or re-stage, after a degraded re-mesh) X on
            ``mesh_``."""
            stage_stats = StreamStats() if self._events.enabled else None
            try:
                if grid:
                    Xd_, _, _ = stage_x_grid(
                        store if store is not None else norm.X, mesh_,
                        stats=stage_stats, events=self._events,
                        liveness=heartbeat)
                    n_orig_ = int(n)
                else:
                    if store is not None:
                        _, topo["slab_loop"] = store_dispatch(
                            store, beta, init=init, force_dense=True,
                            mesh=mesh_)
                    if topo["slab_loop"]:
                        print("[Worker %d]. Store-backed shard exceeds the "
                              "resident budget — running slab-looped "
                              "out-of-core passes "
                              "(CNMF_TPU_OOC_SHARD_BYTES)." % worker_i)
                        Xd_, n_orig_ = store, store.n_rows
                    else:
                        Xd_, n_orig_ = prepare_rowsharded(
                            store if store is not None else norm.X, mesh_,
                            stats=stage_stats, events=self._events,
                            liveness=heartbeat)
            except (ShardUploadError, ShardStallError, TornShardError,
                    RemoteStoreError) as exc:
                kind = ("shard_stall" if isinstance(exc, ShardStallError)
                        else "shard_read_torn"
                        if isinstance(exc, TornShardError)
                        else "remote_store"
                        if isinstance(exc, RemoteStoreError)
                        else "shard_upload_failed")
                guard.record_shard_fault(kind, {"stage": "rowshard_stage_x",
                                                "error": str(exc)})
                guard.finalize()
                raise
            self._events.emit_stream("rowshard_stage_x", stage_stats)
            return Xd_, n_orig_

        topo["Xd"], n_orig = stage(mesh)
        slab_loop = topo["slab_loop"]
        _, n_passes, _ = resolve_online_schedule(beta, 0.05,
                                                 kw.get("n_passes"))
        chunk_max_iter = int(kw.get("online_chunk_max_iter", 1000))
        layout = "grid2d" if grid else "rowshard"
        if grid:
            c_dim, g_dim = (int(d) for d in mesh.devices.shape)
            print("[Worker %d]. 2-D grid factorize: %d cells x %d genes over "
                  "a %d x %d (cells x genes) grid, %d tasks."
                  % (worker_i, n_orig, g, c_dim, g_dim, len(jobs)))
        else:
            print("[Worker %d]. Row-sharded factorize: %d cells over %d "
                  "shard(s), %d tasks." % (worker_i, n_orig, mesh.size,
                                           len(jobs)))
        recipe = resolve_recipe(
            beta, "rowshard", algo="mu", n=int(n), g=int(g),
            k=max((int(ks[i]) for i in jobs), default=None))
        self._events.emit("dispatch", decision="solver_recipe",
                          context=dict(recipe.as_context(), mode=layout))
        tier = "slab_loop" if slab_loop else "resident"
        grid_ctx = {}
        if grid:
            from ..parallel.grid2d import grid_blocks, grid_overlap_enabled

            gx = topo["Xd"]
            grid_ctx = {"mesh_shape": [c_dim, g_dim],
                        "overlap": bool(grid_overlap_enabled()),
                        "blocks": [grid_blocks(gx.cols_per),
                                   grid_blocks(gx.rows_per)]}
        self.factorize_info = dict(grid_ctx, **{
            "lane": "dense", "mode": layout, "packed": False,
            "kernel": kernel_label(False, self.device, False, beta),
            "solver_recipe": recipe.label,
            "kl_newton": bool(recipe.kl_newton), "bf16_ratio": False,
            "n_passes": n_passes, "online_h_tol": 0.05,
            "mesh_devices": int(mesh.size),
            "ooc_ingest": None if store is None else
            ("slab_loop" if slab_loop else "store_resident"),
            "ledger_keys_ignored": ["mode", "online_chunk_size"],
            "trace": {}, "errs": {}, "jobs": len(jobs)})
        if self._writer:
            self._save_factorize_provenance(layout, worker_i, kw)

        ckpt_every = ckpt_mod.ckpt_every_passes()
        if ckpt_every <= 0:
            digest = None
        elif store is not None:
            digest = "store:" + store.store_digest
        else:
            digest = ckpt_mod.input_digest(norm.X)
        # the identity pins a checkpoint to the settings it ran under: a
        # changed cap, penalty, recipe, ingest tier or layout restarts the
        # replicate instead of splicing two trajectories
        params_sig = repr(sorted({
            "init": str(init), "tol": float(kw.get("tol", 1e-4)),
            "n_passes": int(n_passes), "chunk_max_iter": chunk_max_iter,
            "alpha_W": float(kw.get("alpha_W", 0.0)),
            "l1_ratio_W": float(kw.get("l1_ratio_W", 0.0)),
            "alpha_H": float(kw.get("alpha_H", 0.0)),
            "l1_ratio_H": float(kw.get("l1_ratio_H", 0.0)),
            "recipe": recipe.signature(), "ingest_tier": tier,
            "layout": layout, "encoding": "dense"}.items()))

        def make_ckpt(k_c, it_c, seed_c, attempt=0, force_resume=False):
            """A replicate's checkpoint policy; a retry checkpoints under
            an attempt-suffixed path with its derived seed, and always
            resumes (the retry ladder's seeds are deterministic);
            ``force_resume`` (the elastic continuation) loads the
            checkpoint this session's interrupted solve just wrote."""
            if ckpt_every <= 0:
                return None
            path = self.paths["pass_checkpoint"] % (int(k_c), int(it_c))
            if int(attempt) > 0:
                path = path[:-4] + ".a%d.npz" % int(attempt)
            elif not resume and not force_resume and self._writer:
                # a fresh run voids the retry cursors with the base one
                for stale in glob.glob(path[:-4] + ".a*.npz"):
                    try:
                        os.unlink(stale)
                    except OSError:
                        pass
            return ckpt_mod.PassCheckpointer(
                path, ckpt_every,
                meta={"k": int(k_c), "iter": int(it_c), "seed": int(seed_c),
                      "attempt": int(attempt), "digest": digest,
                      "beta": float(beta), "params": params_sig},
                events=self._events, worker=worker_i,
                resume=(bool(resume or force_resume) if int(attempt) == 0
                        else True))

        def sink(payload):
            self.factorize_info["trace"].setdefault(
                int(payload["k"]), []).append(payload["trace"][0])
            self._emit_replicates_event(payload)

        def solve(k_r, seed_r, ckpt):
            common = dict(
                beta_loss=kw["beta_loss"], init=init, seed=int(seed_r),
                tol=float(kw.get("tol", 1e-4)), n_passes=n_passes,
                chunk_max_iter=chunk_max_iter,
                alpha_W=kw.get("alpha_W", 0.0),
                l1_ratio_W=kw.get("l1_ratio_W", 0.0),
                alpha_H=kw.get("alpha_H", 0.0),
                l1_ratio_H=kw.get("l1_ratio_H", 0.0), n_orig=n_orig,
                telemetry_sink=sink, checkpoint=ckpt, recipe=recipe,
                events=self._events, heartbeat=heartbeat)
            if grid:
                _H, spectra, err = nmf_fit_grid2d(
                    topo["Xd"], int(k_r), topo["mesh"], g_orig=int(g),
                    **common)
            else:
                _H, spectra, err = nmf_fit_rowsharded(
                    topo["Xd"], int(k_r),
                    store_slab_loop=not isinstance(topo["Xd"], RowShards),
                    mesh=topo["mesh"], device=self.device, **common)
            return np.asarray(spectra), float(err)

        def remesh_after_loss(exc):
            """Re-plan the mesh over the surviving entries, free the staged
            matrix and re-stage X from the original input."""
            lost = elastic.resolve_lost_devices(exc, topo["mesh"])
            old_n = topo["mesh"].size
            guard.record_shard_fault(
                "host_loss", {"context": layout, "lost_devices": lost,
                              "error": str(exc)})
            new_mesh = elastic.plan_degraded_mesh(topo["mesh"], lost)
            warnings.warn(
                "host/device loss mid-factorize (%s); continuing degraded "
                "on %d of %d devices — in-flight replicates resume from "
                "their pass checkpoints" % (exc, new_mesh.size, old_n),
                RuntimeWarning, stacklevel=2)
            topo["Xd"] = None
            topo["mesh"] = new_mesh
            topo["Xd"], _ = stage(new_mesh)
            self._events.emit(
                "fault", kind="remesh",
                context={"context": layout, "from_devices": int(old_n),
                         "to_devices": int(new_mesh.size)})

        def solve_elastic(k_r, it_r, seed_r, attempt=0):
            """One replicate solve that survives a topology loss: the mesh
            shrinks to the survivors and the solve re-enters from its pass
            checkpoint."""
            force_resume = False
            while True:
                ckpt = make_ckpt(k_r, it_r, seed_r, attempt=attempt,
                                 force_resume=force_resume)
                try:
                    out = solve(k_r, seed_r, ckpt)
                    # a loss at the replicate boundary: after the final
                    # checkpoint, before the artifact write
                    faults.maybe_hostloss(context="replicate",
                                          worker=worker_i)
                    return out + (ckpt,)
                except BaseException as exc:
                    if not (elastic_on and elastic.is_device_loss(exc)):
                        raise
                    remesh_after_loss(exc)  # DegradedMeshError aborts
                    force_resume = True

        perf_t0 = time.perf_counter()
        perf_passes: dict[int, int] = {}
        for idx in jobs:
            k, it, seed = int(ks[idx]), int(iters[idx]), int(seeds[idx])
            # the cost unit is one pass, counted as the pass cap of each
            # job, as the JAX package counts it
            perf_passes[k] = perf_passes.get(k, 0) + int(n_passes)
            faults.maybe_straggle(context="factorize", worker=worker_i)
            spectra, err, ckpt = solve_elastic(k, it, seed)
            sp3, errs = faults.maybe_poison_lanes(
                k, [it], spectra[None], np.asarray([err]), seeds=[seed])
            self.factorize_info["errs"].setdefault(k, []).append(
                float(errs[0]))
            healthy = guard.observe(k, [it], [seed],
                                    resilience.lane_health(errs, spectra=sp3))
            if healthy[0]:
                self._write_iter_spectra(k, it, sp3[0], norm.var_names)
            if ckpt is not None and self._writer:
                # the artifact (or the quarantine record) supersedes the
                # cursor; discarded after the write, so a kill in between
                # resumes from the final checkpoint
                ckpt.discard()
            faults.maybe_kill("factorize", worker_i)
        self.factorize_info["errs"] = {
            k: np.asarray(v) for k, v in self.factorize_info["errs"].items()}
        self.factorize_info["mesh_devices_final"] = int(topo["mesh"].size)

        def rerun(k_r, seeds_r, iters=None, attempt=0):
            outs = []
            for j, s in enumerate(seeds_r):
                spectra, err, ckpt = solve_elastic(k_r, iters[j], s,
                                                   attempt=attempt)
                outs.append((spectra, err))
                if ckpt is not None and self._writer:
                    ckpt.discard()
            return (np.stack([o[0] for o in outs]),
                    np.asarray([o[1] for o in outs], np.float64))

        self._finish_resilience(guard, rerun, norm.var_names, worker_i)
        self._emit_perf_model(
            "factorize_grid2d" if grid else "factorize_rowshard",
            "grid2d" if grid else self.factorize_info["kernel"], int(n),
            int(g), perf_passes, time.perf_counter() - perf_t0, beta=beta,
            grid_shape=grid_ctx.get("mesh_shape"),
            grid_blocks=(max(grid_ctx["blocks"]) if grid_ctx else None))
        sync_hosts("factorize_rowshard", heartbeat=heartbeat)

    def _factorize_2d(self, jobs, ks, iters, seeds, norm, kw, worker_i,
                      mesh=None, replicates_per_batch=None, store=None):
        """Factorize over the (replicates, cells) mesh
        (``parallel/multihost.py``): each replicate row-shards its cells
        over its replicate row's cells fiber, the replicate axis spreads
        the replicates (across processes, one row a process, with no
        cross-process sum). X stages once, reused by every per-K sweep.
        A host loss (one process) re-plans the mesh over the survivors,
        re-stages X and reruns the K's sweep. Only process 0 writes
        artifacts; the processes meet at a barrier at the end."""
        from ..parallel.mesh import process_count
        from ..parallel.multihost import (mesh_2d, replicate_sweep_2d,
                                          stage_x_2d, sync_hosts)
        from ..runtime import elastic

        if mesh is None:
            mesh = mesh_2d(device=self.device)
        heartbeat = None
        if elastic.heartbeat_s() > 0:
            from ..parallel.mesh import process_index

            heartbeat = elastic.Heartbeat(
                os.path.dirname(self.paths["resilience_ledger"]), self.name,
                int(process_index()), events=self._events)
            heartbeat.beat(phase="stage_x_2d", force=True)
        elastic_on = elastic.elastic_enabled() and process_count() == 1
        x_src = store if store is not None else norm.X
        Xd = stage_x_2d(x_src, mesh, events=self._events,
                        liveness=heartbeat)
        beta = beta_loss_to_float(kw["beta_loss"])
        _, n_passes, _ = resolve_online_schedule(beta, 0.05,
                                                 kw.get("n_passes"))
        r_dim, c_dim = mesh.devices.shape
        print("[Worker %d]. 2-D factorize: %d cells x %d replicate shards "
              "(%d x %d mesh, %d processes), %d tasks."
              % (worker_i, norm.X.shape[0], r_dim, r_dim, c_dim,
                 process_count(), len(jobs)))
        self.factorize_info = {
            "lane": "dense", "mode": "mesh2d", "packed": False,
            "kernel": kernel_label(False, self.device, False, beta),
            "mesh_shape": [int(r_dim), int(c_dim)],
            "num_processes": int(process_count()), "n_passes": n_passes,
            "ledger_keys_ignored": ["mode", "online_chunk_size"],
            "errs": {}, "jobs": len(jobs)}
        if self._writer:
            self._save_factorize_provenance("mesh2d", worker_i, kw)
        by_k: dict[int, list] = {}
        for idx in jobs:
            by_k.setdefault(int(ks[idx]), []).append(
                (int(iters[idx]), int(seeds[idx])))
        for k, tasks in sorted(by_k.items()):
            its = [t[0] for t in tasks]
            sds = [t[1] for t in tasks]
            if heartbeat is not None:
                heartbeat.beat(phase="sweep2d", cursor=k, force=True)
            while True:
                try:
                    spectra, errs = replicate_sweep_2d(
                        Xd, sds, k, mesh, beta_loss=kw["beta_loss"],
                        init=kw.get("init", "random"),
                        tol=kw.get("tol", 1e-4), n_passes=n_passes,
                        chunk_max_iter=kw.get("online_chunk_max_iter", 1000),
                        alpha_W=kw.get("alpha_W", 0.0),
                        l1_ratio_W=kw.get("l1_ratio_W", 0.0),
                        alpha_H=kw.get("alpha_H", 0.0),
                        l1_ratio_H=kw.get("l1_ratio_H", 0.0),
                        replicates_per_batch=replicates_per_batch)
                    break
                except BaseException as exc:
                    if not (elastic_on and elastic.is_device_loss(exc)):
                        raise
                    lost = elastic.resolve_lost_devices(exc, mesh)
                    old_n = mesh.size
                    self._events.emit(
                        "fault", kind="host_loss",
                        context={"context": "sweep2d", "lost_devices": lost,
                                 "error": str(exc)})
                    mesh = elastic.plan_degraded_mesh(mesh, lost)
                    warnings.warn(
                        "host/device loss mid-sweep (%s); re-planned a "
                        "%d x %d mesh over %d of %d devices and rerunning "
                        "k=%d" % (exc, *mesh.devices.shape, mesh.size,
                                  old_n, k), RuntimeWarning, stacklevel=2)
                    Xd = stage_x_2d(x_src, mesh, events=self._events,
                                    liveness=heartbeat)
                    self._events.emit(
                        "fault", kind="remesh",
                        context={"context": "sweep2d",
                                 "from_devices": int(old_n),
                                 "to_devices": int(mesh.size)})
            self.factorize_info["errs"][k] = errs
            for r, it in enumerate(its):
                self._write_iter_spectra(k, it, spectra[r], norm.var_names)
        sync_hosts("factorize_2d", heartbeat=heartbeat)

    def _factorize_sequential(self, jobs, ks, iters, seeds, norm, kw,
                              recipe, Xs, guard, worker_i):
        """The sequential lane: one ``run_nmf`` call a task under
        ``recipe``, the one ``factorize`` resolved and recorded, pinned on
        every call so the provenance names the engaged math even if a knob
        changes mid-run. On the ELL lane each call starts from the random
        init's scale of the batched lane's staged encoding ``Xs``
        (``sweep_x_mean``), so both lanes start a seed alike."""
        self._save_factorize_provenance("sequential", worker_i, kw)
        run_kw = {key: v for key, v in kw.items() if key != "n_jobs"}
        x_mean = (sweep_x_mean(Xs, *norm.X.shape)
                  if isinstance(Xs, EllMatrix) else None)

        def solve(k_r, seed_r):
            _usages, spectra, err = run_nmf(
                norm.X, **dict(run_kw, n_components=int(k_r),
                               random_state=int(seed_r)),
                recipe=recipe, x_mean=x_mean, device=self.device)
            return spectra, err

        for idx in jobs:
            k_t, it_t, seed_t = int(ks[idx]), int(iters[idx]), int(seeds[idx])
            print("[Worker %d]. Starting task %d." % (worker_i, idx))
            faults.maybe_straggle(context="factorize", worker=worker_i)
            spectra, err = solve(k_t, seed_t)
            sp3, errs = faults.maybe_poison_lanes(
                k_t, [it_t], spectra[None], np.asarray([err]),
                seeds=[seed_t])
            self.factorize_info["errs"].setdefault(k_t, []).append(
                float(errs[0]))
            healthy = guard.observe(k_t, [it_t], [seed_t],
                                    resilience.lane_health(errs, spectra=sp3))
            if healthy[0]:
                self._write_iter_spectra(k_t, it_t, sp3[0], norm.var_names)
            faults.maybe_kill("factorize", worker_i)
        self.factorize_info["errs"] = {
            k: np.asarray(v) for k, v in self.factorize_info["errs"].items()}

        def rerun(k_r, seeds_r, iters=None, attempt=0):
            outs = [solve(k_r, s) for s in seeds_r]
            return (np.stack([o[0] for o in outs]),
                    np.asarray([o[1] for o in outs], np.float64))

        self._finish_resilience(guard, rerun, norm.var_names, worker_i)

    def _save_factorize_provenance(self, engaged_path: str, worker_i, kw):
        """What factorize ran: the engaged path and the effective
        parameters (the run-parameters file's, and what factorize_info
        records of the lane, recipe and schedule)."""
        effective = dict(
            {k: v for k, v in kw.items() if k != "n_jobs"},
            **{k: v for k, v in self.factorize_info.items()
               if k not in ("trace", "errs", "dna_fallback")})
        with atomic_artifact(self.paths["factorize_provenance"]
                             % int(worker_i)) as tmp:
            with open(tmp, "w") as f:
                json.dump({"worker_index": int(worker_i),
                           "engaged_path": engaged_path,
                           "effective_params": effective},
                          f, indent=1, sort_keys=True)
        # the engaged solver family and its parameters are the dispatch
        # decision: every factorize lane records it here
        self._events.emit("dispatch", decision="solver_path",
                          context=dict({"engaged_path": engaged_path},
                                       **effective))

    def _emit_replicates_event(self, payload):
        """One sweep's convergence records
        (``parallel.replicates._sweep_telemetry_payload``) as a
        ``replicates`` event."""
        records = replicate_records(payload)
        self._events.emit("replicates", k=payload["k"], beta=payload["beta"],
                          mode=payload["mode"], cap=int(payload["cap"]),
                          cadence=payload["cadence"],
                          recipe=payload.get("recipe"),
                          kernel=payload.get("kernel"),
                          records=records)
        # while a factorize path runs, total the solver iterations a K:
        # the multiplicity its perf_model event scales one iteration's
        # analytic cost by
        if self._perf_iters is not None:
            k = int(payload["k"])
            self._perf_iters[k] = self._perf_iters.get(k, 0) + sum(
                int(r.get("iters", 0)) for r in records)

    def _emit_perf_model(self, stage, lane, n, g, iters_by_k, wall_s, *,
                         beta, ell_width=None, bf16_ratio=False,
                         grid_shape=None, grid_blocks=None):
        """One ``perf_model`` event: the lane's analytic cost
        (``obs/costmodel.py``) times the iterations a K, joined with the
        measured wall into the roofline verdict against the peaks of this
        run's device. Only when the telemetry and ``CNMF_TPU_PERF_MODEL``
        are both on; a failure here warns and never takes factorize
        down."""
        from ..obs.costmodel import (device_peaks, lane_cost,
                                     perf_model_enabled, roofline)

        if not (self._events.enabled and perf_model_enabled()):
            return
        if not iters_by_k or wall_s is None:
            return
        try:
            peaks = device_peaks(self.device)
            exempt = self.device.type != "cuda"
            tot_f = tot_b = 0.0
            passes = 0
            for k, n_iters in sorted(iters_by_k.items()):
                c = lane_cost(lane, n, g, int(k), beta=beta,
                              ell_width=ell_width, bf16_ratio=bf16_ratio,
                              device=self.device, grid_shape=grid_shape,
                              grid_blocks=grid_blocks)
                exempt = exempt or bool(c.get("perf_exempt"))
                tot_f += c["flops"] * int(n_iters)
                tot_b += c["bytes"] * int(n_iters)
                passes += int(n_iters)
            roof = roofline(tot_f, tot_b, wall_s, peaks, perf_exempt=exempt)
        except Exception as exc:
            warnings.warn("perf_model event of %s skipped: %s: %s"
                          % (stage, type(exc).__name__, exc),
                          RuntimeWarning, stacklevel=2)
            return
        self._events.emit(
            "perf_model", stage=stage, lane=lane,
            predicted={"flops": tot_f, "bytes": tot_b,
                       "by_k": {str(k): int(v)
                                for k, v in sorted(iters_by_k.items())}},
            measured={"wall_s": round(float(wall_s), 4), "passes": passes},
            roofline=roof)

    def _write_iter_spectra(self, k, it, spectrum, columns):
        """One replicate's spectra artifact (atomic; stored, not
        deflated); process 0 writes it when the mesh spans processes."""
        if not getattr(self, "_writer", True):
            return
        save_df_to_npz(Frame(spectrum, np.arange(1, int(k) + 1), columns),
                       self.paths["iter_spectra"] % (int(k), int(it)),
                       compress=False)
        self._written[int(k)] = self._written.get(int(k), 0) + 1

    def _record_resilience(self, guard):
        """The guard's records in ``factorize_info``: the replicates
        written per K, every retry and every quarantine."""
        self.factorize_info.update(written=dict(self._written),
                                   retries=list(guard.retries),
                                   quarantined=list(guard.quarantined))

    def _finish_resilience(self, guard, rerun, columns, worker_i=0):
        """The retry waves and the final accounting of one factorize call.

        ``rerun(k, seeds, iters=, attempt=) -> (spectra (R, k, g), errs
        (R,))`` re-solves replicates of one K (each lane its own solver
        family). The seeds are derived per attempt
        (``resilience.derive_retry_seed``), so a resumed run retries with
        the uninterrupted run's seeds; the guard's ledger records every
        (seed, attempt, derived seed, outcome) and the quarantines, then
        the floor is enforced."""
        attempt = 1
        while attempt <= guard.max_retries:
            wave = guard.take_pending()
            if not wave:
                break
            by_k: dict[int, list] = {}
            for t in wave:
                by_k.setdefault(int(t["k"]), []).append(t)
            for k, tasks in sorted(by_k.items()):
                its = [t["iter"] for t in tasks]
                orig_seeds = [t["seed"] for t in tasks]
                derived = [resilience.derive_retry_seed(s, attempt)
                           for s in orig_seeds]
                print("[Worker %d]. Retrying %d unhealthy replicate(s) for "
                      "k=%d with derived seeds (attempt %d/%d)."
                      % (worker_i, len(tasks), k, attempt,
                         guard.max_retries))
                spectra, errs = rerun(k, derived, iters=its,
                                      attempt=attempt)
                spectra, errs = faults.maybe_poison_lanes(
                    k, its, spectra, errs, attempt=attempt,
                    seeds=orig_seeds)
                healthy = guard.observe(
                    k, its, orig_seeds,
                    resilience.lane_health(errs, spectra=spectra),
                    attempt=attempt, derived_seeds=derived)
                for j, it in enumerate(its):
                    if healthy[j]:
                        self._write_iter_spectra(k, it, spectra[j][:k],
                                                 columns)
            attempt += 1
        self._record_resilience(guard)
        guard.finalize()

    # ------------------------------------------------------------------
    # combine
    # ------------------------------------------------------------------

    @_timed("combine")
    def combine(self, components=None, skip_missing_files=False):
        if isinstance(components, int):
            ks = [components]
        elif components is None:
            ks = self.ledger_components()
        else:
            ks = components
        for k in ks:
            self.combine_nmf(int(k), skip_missing_files=skip_missing_files)

    def combine_nmf(self, k, skip_missing_files=False):
        """Stack the per-iter spectra into the merged ``(n_iter * k,
        genes)`` matrix with ``iter%d_topic%d`` row labels. Every file is
        validated (``resilience.load_spectra_checked``: a readable archive
        of ``k x genes`` finite values). A missing file raises
        ``FileNotFoundError`` and an invalid one ``TornArtifactError``, or
        either is skipped with ``skip_missing_files``; a replicate that
        factorize quarantined (the resilience ledgers) is skipped without
        the flag, unless a valid artifact of it is on disk."""
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        print("Combining factorizations for k=%d." % k)
        ks = _ledger_ints(ledger, "n_components")
        iters = np.sort(_ledger_ints(ledger, "iter")[ks == k])
        quarantined = resilience.load_quarantined_tasks(
            self.paths["resilience_ledger"])
        n_genes = None
        if os.path.exists(self.paths["nmf_genes_list"]):
            n_genes = len(self._hvgs())
        parts, labels, columns = [], [], None
        for it in iters:
            fn = self.paths["iter_spectra"] % (k, it)
            quarantined_here = (int(k), int(it)) in quarantined
            if not os.path.exists(fn):
                if quarantined_here:
                    print("Skipping quarantined replicate k=%d iter=%d "
                          "(see the resilience ledger)." % (k, it))
                    continue
                if not skip_missing_files:
                    print("Missing file: %s, run with skip_missing=True to "
                          "override" % fn)
                    raise FileNotFoundError(errno.ENOENT,
                                            os.strerror(errno.ENOENT), fn)
                print("Missing file: %s. Skipping." % fn)
                continue
            try:
                df = resilience.load_spectra_checked(fn, k=int(k),
                                                     n_genes=n_genes)
            except resilience.TornArtifactError as exc:
                if quarantined_here:
                    print("Skipping quarantined replicate k=%d iter=%d "
                          "(see the resilience ledger)." % (k, it))
                    continue
                self._events.emit("fault", kind="torn_artifact",
                                  context={"path": fn, "reason": str(exc)})
                if not skip_missing_files:
                    raise resilience.TornArtifactError(
                        "%s — rerun `factorize --skip-completed-runs` to "
                        "regenerate it, or combine with "
                        "skip_missing_files=True to drop it" % exc) from exc
                print("Corrupt file: %s. Skipping. (%s)" % (fn, exc))
                continue
            parts.append(df.values)
            columns = df.columns
            labels += ["iter%d_topic%d" % (it, t + 1) for t in range(k)]
        if not parts:
            print("No spectra found for k=%d" % k)
            return None
        merged = Frame(np.concatenate(parts), np.asarray(labels), columns)
        save_df_to_npz(merged, self.paths["merged_spectra"] % k)
        return merged

    # ------------------------------------------------------------------
    # refits
    # ------------------------------------------------------------------

    def refit_usage(self, X, spectra, usage=None) -> np.ndarray:
        """Fixed-spectra usage refit (``ops/nmf.py:fit_h``) of the run's
        own beta subproblem; a sparse ``X`` with KL takes the ELL lane under
        the dispatch rule. ``usage`` warm-starts the solve. At or above
        ``rowshard_threshold`` rows (without ``usage``) the refit runs
        row-sharded (``parallel/rowshard.py:fit_h_rowsharded``: the staged
        shard solved as one block; the ELL encoding of a sparse KL matrix
        runs the ``h_stats`` kernel on the card)."""
        kw = self._solver_params()
        if X.shape[0] >= self.rowshard_threshold and usage is None:
            from ..parallel.rowshard import fit_h_rowsharded

            return fit_h_rowsharded(
                X, np.asarray(spectra, dtype=np.float32), h_tol=0.05,
                chunk_max_iter=int(kw["online_chunk_max_iter"]),
                l1_reg_H=float(kw["l1_ratio_H"]), l2_reg_H=0.0,
                beta=beta_loss_to_float(kw["beta_loss"]),
                device=self.device, events=self._events)
        return fit_h(
            X, np.asarray(spectra, dtype=np.float32),
            H_init=None if usage is None else np.asarray(usage),
            chunk_size=int(kw["online_chunk_size"]),
            chunk_max_iter=int(kw["online_chunk_max_iter"]), h_tol=0.05,
            l1_reg_H=float(kw["l1_ratio_H"]), l2_reg_H=0.0,
            beta=beta_loss_to_float(kw["beta_loss"]), device=self.device)

    def refit_spectra(self, X, usage) -> np.ndarray:
        """Spectra for fixed usages by the transpose trick: the usage refit
        of ``X.T`` against ``usage.T``. At or above ``rowshard_threshold``
        rows the W subproblem is solved directly
        (``parallel/rowshard.py:refit_w_rowsharded``), whose row blocks
        never become ``chunk x cells`` dense buffers. A staged tensor
        (:meth:`_stage_dense`) transposes on the card; a sparse host
        matrix that the lane rule keeps off the ELL lane is staged first,
        its walls in the timings TSV as ``refit_spectra.stage/...``."""
        if X.shape[0] >= self.rowshard_threshold:
            from ..parallel.rowshard import refit_w_rowsharded

            kw = self._solver_params()
            return refit_w_rowsharded(
                X, np.asarray(usage),
                beta=beta_loss_to_float(kw["beta_loss"]), h_tol=0.05,
                max_iter=int(kw["online_chunk_max_iter"]),
                l1_reg_W=float(kw["l1_ratio_W"]), device=self.device)
        if isinstance(X, torch.Tensor):
            Xt = X.T  # a staged matrix transposes on the card
        elif sp.issparse(X):
            beta = beta_loss_to_float(self._solver_params()["beta_loss"])
            if takes_ell_lane(X.T, beta):
                Xt = X.T.tocsr()  # the ELL lane's transposed refit
            else:
                # the dense lane: stage the row-major matrix slab by slab
                # and transpose on the card (no dense copy on the host)
                from ..parallel.streaming import StreamStats, stream_to_device

                stats = StreamStats()
                Xt = stream_to_device(X, self.device, stats=stats,
                                      events=self._events).T
                stats.record_to(self._timer, "refit_spectra.stage")
        else:
            Xt = np.asarray(X).T
        return self.refit_usage(Xt, np.asarray(usage).T).T

    # ------------------------------------------------------------------
    # consensus
    # ------------------------------------------------------------------

    def _consensus(self, k, density_threshold=0.5,
                   local_neighborhood_size=0.30, show_clustering=True,
                   build_ref=True, skip_density_and_return_after_stats=False,
                   close_clustergram_fig=False, refit_usage=True,
                   normalize_tpm_spectra=False,
                   norm_counts=None, _sketch=None, _stream_store=None,
                   _stream_error_collector=None):
        """Consensus spectra and usages from the merged replicate matrix:
        L2-normalize, filter outliers by KNN local density (cached), k-means
        (k, 10 inits, seed 1), cluster medians, usage refits, TPM- and
        z-score-unit spectra. With ``skip_density_and_return_after_stats``
        returns the K-selection statistics instead of writing artifacts.
        ``show_clustering`` also draws the clustergram
        (``paths["clustering_plot"]``, ``models/plots.py``): the filtered
        distances of the density pass, or on a sketched run or a cached
        density those of the clustered features. Without matplotlib the
        figure is skipped with a warning and everything else is written
        (``ROADMAP.md`` D17).

        Sketched consensus (``ops/sketch.py``, ``CNMF_TPU_SKETCH``): when
        it engages, the density filter, k-means and the silhouette run on
        a seeded Gaussian projection of the L2-normalized spectra (the
        projected densities are neither read from nor written to the
        cache), and the cluster medians still come from the full-width
        spectra. The decision is recorded in ``consensus_info[k]``
        and the ``consensus_path`` dispatch event.

        Timed as the ``consensus`` stage, with the sub-stages
        ``consensus.sketch``, ``.density``, ``.kmeans``, ``.refit_usage``,
        ``.refit_spectra``, ``.ols``, ``.final_refit``, ``.writes`` and
        ``.build_ref`` (those the call runs); the K-selection sweep's
        stats passes call it as ``_consensus``, with no ``consensus``
        stage of their own. ``_sketch``: the sweep-level decision of
        :meth:`k_selection_stats`, in place of a per-K one.

        Streaming consensus: when the shard store is the only copy of the
        normalized counts (a ``CNMF_TPU_OOC=1`` prepare), the usage refit
        and the prediction error loop over the store's row blocks under
        the host slab budget (:meth:`_refit_usage_streamed`,
        :meth:`_streamed_prediction_errors`); no stage assembles the cells
        x genes matrix. ``_stream_store`` / ``_stream_error_collector``:
        :meth:`k_selection_stats` hands its store over and collects each
        K's spectra for its one shared error pass."""
        dev = self.device
        k = int(k)
        merged = load_df_from_npz(self.paths["merged_spectra"] % k)
        store = _stream_store
        if norm_counts is None:
            if store is None:
                store = self._consensus_stream_store()
            norm_counts = (self._store_counts(store) if store is not None
                           else self._read_norm_counts())
        dt_str = str(density_threshold)
        if skip_density_and_return_after_stats:
            dt_str = "2"
        dt_repl = dt_str.replace(".", "_")
        n_neighbors = int(local_neighborhood_size * merged.shape[0] / k)

        spectra = np.asarray(merged.values)
        l2 = spectra / np.sqrt((spectra ** 2).sum(axis=1))[:, None]
        index = np.asarray(merged.index)
        sk = (_sketch if _sketch is not None
              else resolve_consensus_sketch(int(l2.shape[0]),
                                            int(l2.shape[1])))
        feats = l2
        if sk.engaged:
            with self._timer.stage("consensus.sketch"):
                feats = project_rows(l2, sk.dim, device=dev)
        self.consensus_info[k] = dict(
            sk.as_context(),
            stage=("k_selection_stats" if skip_density_and_return_after_stats
                   else "consensus"),
            replicates=int(l2.shape[0]),
            distance_width=int(feats.shape[1]))
        self._events.emit(
            "dispatch", decision="consensus_path",
            context=dict(self.consensus_info[k], k=k, packed=False,
                         distance_shape=[int(l2.shape[0])] * 2))
        keep = np.ones(l2.shape[0], dtype=bool)
        density = topics_dist = None
        if not skip_density_and_return_after_stats:
            cache = self.paths["local_density_cache"] % k
            if not sk.engaged and os.path.isfile(cache):
                density = load_df_from_npz(cache).values[:, 0]
            else:
                with self._timer.stage("consensus.density"):
                    density, topics_dist = knn_local_density(
                        feats, n_neighbors, device=dev)
                if not sk.engaged:
                    # projected densities never enter the exact cache
                    save_df_to_npz(Frame(density[:, None], index,
                                         np.asarray(["local_density"])),
                                   cache)
            keep = density < density_threshold
            if not keep.any():
                raise DensityFilterError(
                    "Zero components remain after density filtering. "
                    "Consider increasing density threshold")
            if keep.sum() < k:
                warnings.warn(
                    "density_threshold=%s keeps only %d of %d replicate "
                    "spectra, fewer than k=%d, so consensus will produce "
                    "only %d programs" % (density_threshold, keep.sum(),
                                          len(keep), k, keep.sum()),
                    UserWarning, stacklevel=2)
        l2, feats = l2[keep], feats[keep]
        with self._timer.stage("consensus.kmeans"):
            labels, _centers, _inertia = kmeans(feats, k, n_init=10, seed=1,
                                                device=dev)
        # cluster medians from the full-width spectra (clusters in label
        # order), rows renormalized
        clusters = np.unique(labels)
        median = np.stack([np.median(l2[labels == c], axis=0)
                           for c in clusters])
        median = median / median.sum(axis=1, keepdims=True)

        with self._timer.stage("consensus.refit_usage"):
            if store is None:
                usages = self.refit_usage(
                    self._stage_dense("norm_counts", norm_counts.X), median)
            elif skip_density_and_return_after_stats:
                # the usages feed only the prediction error, whose slab
                # pass solves them itself
                usages = None
            else:
                usages = self._refit_usage_streamed(store, median)
        if skip_density_and_return_after_stats:
            silhouette = silhouette_score(feats, labels, k, device=dev)
            if store is None:
                error = _frobenius_prediction_error(norm_counts.X, usages,
                                                    median)
            elif _stream_error_collector is not None:
                # filled by the caller's one shared slab pass
                _stream_error_collector[k] = median
                error = float("nan")
            else:
                error = self._streamed_prediction_errors(
                    store, {k: median})[k]
            return Frame(np.asarray([[k], [density_threshold], [silhouette],
                                     [error]], dtype=np.float64),
                         np.asarray(["k", "local_density_threshold",
                                     "silhouette", "prediction_error"]),
                         np.asarray(["stats"]))

        # order the programs by their total share of usage
        norm_usages = usages / usages.sum(axis=1, keepdims=True)
        order = np.argsort(-norm_usages.sum(axis=0), kind="stable")
        usages, norm_usages, median = (usages[:, order],
                                       norm_usages[:, order], median[order])
        programs = np.arange(1, len(order) + 1)

        with self._timer.stage("consensus.refit_spectra"):
            tpm = load_matrix(self.paths["tpm"])
            tpm_stats = load_df_from_npz(self.paths["tpm_stats"])
            tpm_resident = self._stage_dense("tpm", tpm.X)
            spectra_tpm = self.refit_spectra(tpm_resident,
                                             norm_usages.astype(np.float32))
        if normalize_tpm_spectra:
            spectra_tpm = (spectra_tpm / spectra_tpm.sum(axis=1,
                                                         keepdims=True)
                           * 1e6)
        with self._timer.stage("consensus.ols"):
            usage_coef = ols_all_cols(usages, tpm.X, normalize_y=True,
                                      device=dev)

        if refit_usage:
            with self._timer.stage("consensus.final_refit"):
                usages = self._final_refit(tpm, tpm_stats, spectra_tpm,
                                           resident=tpm_resident)

        median_f = Frame(median.astype(np.float32), programs,
                         np.asarray(norm_counts.var_names))
        usages_f = Frame(usages, np.asarray(norm_counts.obs_names), programs)
        tpm_f = Frame(spectra_tpm, programs, np.asarray(tpm.var_names))
        score_f = Frame(usage_coef, programs, np.asarray(tpm.var_names))
        with self._timer.stage("consensus.writes"):
            for key, frame in (("consensus_spectra", median_f),
                               ("consensus_usages", usages_f),
                               ("gene_spectra_tpm", tpm_f),
                               ("gene_spectra_score", score_f)):
                save_df_to_npz(frame, self.paths[key] % (k, dt_repl))
                save_df_to_text(frame,
                                self.paths[key + "__txt"] % (k, dt_repl))
        if show_clustering:
            png = self.paths["clustering_plot"] % (k, dt_repl)
            # the distances are computed only when the figure is drawn
            if plots.pyplot_or_skip(png) is not None:
                topics_dist = (pairwise_euclidean(feats, device=dev)
                               if topics_dist is None
                               else topics_dist[np.ix_(keep, keep)])
                plots.clustergram(topics_dist, labels + 1, density, keep,
                                  density_threshold, png,
                                  close_fig=close_clustergram_fig)
        if build_ref:
            with self._timer.stage("consensus.build_ref"):
                self.build_reference(k, density_threshold, spectra_tpm=tpm_f)
        return None

    consensus = _timed("consensus")(_consensus)

    def _consensus_stream_store(self):
        """The shard store consensus and the K-selection statistics stream
        from, or ``None``: only when the store is the only copy (the matrix
        file is absent after a ``CNMF_TPU_OOC=1`` prepare)."""
        if os.path.exists(self.paths["normalized_counts"]):
            return None
        return self._probe_store()

    def _stream_blocks(self, store, chunk_size, stats=None,
                       f64_extra=False, peak_base=0):
        """``(lo, hi, dense f32 block)`` row blocks of the store, their
        boundaries multiples of ``chunk_size`` (the bit-identity contract
        of ``ops/nmf.py:fit_h_slabbed``) and their size such that the live
        set — the raw slab read (CSR runs about twice the dense bytes at
        single-cell density), the f32 block and, with ``f64_extra``, the
        consumer's f64 copy — stays under ``CNMF_TPU_OOC_BUDGET_BYTES`` (at
        least one chunk a block). ``stats`` collects the block walls and
        bytes and the residency peak, ``peak_base`` the caller's own
        pass-long buffers."""
        from ..utils.shardstore import host_matrix_bytes, ooc_budget_bytes
        from ..utils.storebackend import backend_counter_snapshot

        bk_before = backend_counter_snapshot(store)
        n, g = store.shape
        chunk_size = int(min(int(chunk_size), max(n, 1)))
        chunk_bytes = max(chunk_size * g * 4, 1)
        divisor = 6 if f64_extra else 3
        rows_per = max(1, (ooc_budget_bytes() // divisor) // chunk_bytes) \
            * chunk_size
        if stats is not None and peak_base > stats.host_peak_bytes:
            stats.host_peak_bytes = int(peak_base)
        t_start = time.perf_counter()
        for lo in range(0, n, rows_per):
            hi = min(lo + rows_per, n)
            t0 = time.perf_counter()
            blk = store.row_block(lo, hi, events=self._events)
            raw = host_matrix_bytes(blk)
            dense = (blk.toarray() if sp.issparse(blk)
                     else np.asarray(blk)).astype(np.float32, copy=False)
            if stats is not None:
                stats.add(disk_s=time.perf_counter() - t0, disk_nbytes=raw,
                          slabs=1, nbytes=dense.nbytes)
                peak = (int(peak_base) + raw
                        + dense.nbytes * (3 if f64_extra else 1))
                stats.host_peak_bytes = max(stats.host_peak_bytes, peak)
            del blk
            yield lo, hi, dense
        if stats is not None:
            stats.wall_s += time.perf_counter() - t_start
            # a remote store's transport counters of this pass's reads
            stats.fold_store_counters(bk_before,
                                      backend_counter_snapshot(store))

    def _refit_usage_streamed(self, store, spectra, collect=None,
                              context="consensus_stream"):
        """:meth:`refit_usage` streamed from the shard store: the same
        solver parameters, chunk partition and default init, so bit for
        bit ``fit_h`` on the assembled dense matrix, with one block on the
        host at a time."""
        from ..ops.nmf import fit_h_slabbed
        from ..parallel.streaming import StreamStats

        kw = self._solver_params()
        stats = StreamStats()
        chunk = int(kw["online_chunk_size"])
        usage_bytes = 2 * store.n_rows * int(np.asarray(spectra).shape[0]) * 4
        H = fit_h_slabbed(
            self._stream_blocks(store, chunk, stats=stats,
                                peak_base=usage_bytes),
            store.n_rows, np.asarray(spectra), chunk_size=chunk,
            chunk_max_iter=int(kw["online_chunk_max_iter"]), h_tol=0.05,
            l1_reg_H=float(kw["l1_ratio_H"]), l2_reg_H=0.0,
            beta=beta_loss_to_float(kw["beta_loss"]), collect=collect,
            device=self.device)
        self._events.emit_stream(context, stats)
        self.stream_stats[context] = stats
        return H

    def _streamed_prediction_errors(self, store, spectra_by_k):
        """Every K's prediction error from ONE slab pass over the store:
        ``||X - HW||^2`` needs only ``H^T X``, ``H^T H`` and ``||X||^2``,
        so each block is read once and serves every K (its usages solved
        block-wise, as the resident refit solves them, then folded into
        f64 statistics). Returns ``{k: prediction_error}``."""
        from ..ops.nmf import _fit_h_block, fit_h_default_init
        from ..parallel.streaming import StreamStats

        kw = self._solver_params()
        beta = beta_loss_to_float(kw["beta_loss"])
        n, g = store.shape
        chunk = int(min(int(kw["online_chunk_size"]), max(n, 1)))
        cmi = int(kw["online_chunk_max_iter"])
        l1 = float(kw["l1_ratio_H"])
        W32 = {kk: np.asarray(W, np.float32)
               for kk, W in spectra_by_k.items()}
        H0 = {kk: fit_h_default_init(n, W.shape[0]).numpy()
              for kk, W in W32.items()}
        HtX = {kk: np.zeros((W.shape[0], g)) for kk, W in W32.items()}
        HtH = {kk: np.zeros((W.shape[0], W.shape[0]))
               for kk, W in W32.items()}
        x_sq = 0.0
        stats = StreamStats()
        usage_bytes = sum(H0[kk].nbytes + HtX[kk].nbytes + HtH[kk].nbytes
                          for kk in H0)
        for lo, hi, Xb in self._stream_blocks(store, chunk, stats=stats,
                                              f64_extra=True,
                                              peak_base=usage_bytes):
            Xb64 = Xb.astype(np.float64)
            x_sq += float(np.vdot(Xb64, Xb64))
            for kk, W in W32.items():
                Hb = _fit_h_block(Xb, H0[kk][lo:hi], W, beta, chunk, cmi,
                                  0.05, l1, 0.0, self.device
                                  ).astype(np.float64)
                HtX[kk] += Hb.T @ Xb64
                HtH[kk] += Hb.T @ Hb
        self._events.emit_stream("kselection_stream", stats)
        self.stream_stats["kselection_stream"] = stats
        out = {}
        for kk, W in spectra_by_k.items():
            W64 = np.asarray(W, np.float64)
            cross = float(np.sum(HtX[kk] * W64))
            hw_sq = float(np.sum((HtH[kk] @ W64) * W64))
            out[kk] = max(x_sq - 2.0 * cross + hw_sq, 0.0)
        return out

    def _final_refit(self, tpm: Counts, tpm_stats: Frame, spectra_tpm,
                     resident=None):
        """The final usage refit on the HVG TPM scaled to unit (ddof=1)
        variance, with the spectra in the same units. ``resident``: the
        TPM staged by :meth:`_stage_dense`, whose HVG columns are cut and
        scaled on the card (``ops/stats.py:scale_hvg_columns_device``,
        the same f32 quotients as the host path)."""
        hv = _positions(tpm.var_names, self._hvgs())
        std = np.asarray(tpm_stats.column("__std"), np.float64)[hv]
        spectra_rf = spectra_tpm[:, hv] / std[None, :]
        n_rows = tpm.X.shape[0]
        bessel = n_rows / (n_rows - 1.0) if n_rows > 1 else 1.0
        div = np.sqrt(std ** 2 * bessel).astype(np.float32)
        if sp.issparse(tpm.X):
            div[div == 0] = 1.0
        if isinstance(resident, torch.Tensor):
            X_rf = scale_hvg_columns_device(resident, hv, div)
        elif sp.issparse(tpm.X):
            X_rf = tpm.X[:, hv].tocsr().astype(np.float32)
            X_rf.data = X_rf.data / div[X_rf.indices]
        else:
            X_rf = np.asarray(tpm.X, np.float32)[:, hv] / div[None, :]
        return self.refit_usage(X_rf, spectra_rf.astype(np.float32))

    def _hvgs(self) -> list[str]:
        with open(self.paths["nmf_genes_list"]) as f:
            return f.read().split("\n")

    def build_reference(self, k, density_threshold=0.5, target_sum=1e6,
                        spectra_tpm: Frame | None = None):
        """starCAT reference spectra: TPM spectra renormalized to
        ``target_sum`` per program, divided by the per-gene TPM std, cut to
        the HVGs, rows labelled ``GEP%d``."""
        dt_repl = str(density_threshold).replace(".", "_")
        if spectra_tpm is None:
            spectra_tpm = load_df_from_npz(
                self.paths["gene_spectra_tpm"] % (k, dt_repl))
        tpm_std = np.asarray(
            load_df_from_npz(self.paths["tpm_stats"]).column("__std"),
            np.float64)
        vals = np.asarray(spectra_tpm.values, np.float64)
        renorm = vals / vals.sum(axis=1, keepdims=True) * target_sum
        hv = _positions(spectra_tpm.columns, self._hvgs())
        ref = Frame(renorm[:, hv] / tpm_std[None, hv],
                    np.asarray(["GEP%s" % v for v in spectra_tpm.index]),
                    np.asarray(spectra_tpm.columns)[hv])
        save_df_to_npz(ref, self.paths["starcat_spectra"] % (k, dt_repl))
        save_df_to_text(ref, self.paths["starcat_spectra__txt"]
                        % (k, dt_repl))

    def k_selection_stats(self) -> Frame:
        """Stability (silhouette) and prediction error for every K of the
        ledger, written as ``k_selection_stats``; the figure is
        :meth:`k_selection_plot`'s."""
        ks = self.ledger_components()
        if not ks:
            raise ValueError("the replicate ledger lists no components; "
                             "run prepare() with a non-empty components list")
        # a store that is the only copy streams: one shared slab pass
        # gives every K's prediction error
        store = self._consensus_stream_store()
        norm_counts = (self._store_counts(store) if store is not None
                       else self._read_norm_counts())
        collector = {} if store is not None else None
        # one sweep-level sketch decision, from the largest merged matrix:
        # a per-K one could compare Ks in different feature spaces
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        ledger_ks = _ledger_ints(ledger, "n_components")
        r_max = max(int((ledger_ks == k).sum()) * int(k) for k in ks)
        sk = resolve_consensus_sketch(r_max, int(norm_counts.X.shape[1]))
        self.consensus_info["k_selection"] = dict(
            sk.as_context(), ks=[int(k) for k in ks], R_max=r_max)
        # one stats pass a K, each its own program set: nothing is packed
        self._events.emit(
            "dispatch", decision="k_selection",
            context=dict(self.consensus_info["k_selection"],
                         K_max=int(max(ks)), packed=False))
        rows = [self._consensus(k, skip_density_and_return_after_stats=True,
                                show_clustering=False,
                                norm_counts=norm_counts, _sketch=sk,
                                _stream_store=store,
                                _stream_error_collector=collector
                                ).values[:, 0]
                for k in ks]
        if collector:
            with self._timer.stage("k_selection.stream_errors"):
                errs = self._streamed_prediction_errors(store, collector)
            for row in rows:
                row[3] = errs[int(row[0])]
        stats = Frame(np.stack(rows), np.arange(len(rows)),
                      np.asarray(["k", "local_density_threshold",
                                  "silhouette", "prediction_error"]))
        save_df_to_npz(stats, self.paths["k_selection_stats"])
        return stats

    @_timed("k_selection_plot")
    def k_selection_plot(self, close_fig=False):
        """The K-selection step: writes the statistics of
        :meth:`k_selection_stats` (``<name>.k_selection_stats.df.npz``),
        draws the stability/error figure (``<name>.k_selection.png``;
        skipped with a warning without matplotlib, ``ROADMAP.md`` D17) and
        returns the statistics."""
        stats = self.k_selection_stats()
        plots.k_selection_figure(stats, self.paths["k_selection_plot"],
                                 close_fig=close_fig)
        return stats

    def load_results(self, K, density_threshold, n_top_genes=100,
                     norm_usage=True):
        """Read the final text artifacts; returns ``(usage,
        spectra_scores, spectra_tpm, top_genes)`` as :class:`Frame`s
        (scores and TPM spectra genes x programs; ``top_genes`` the
        ``n_top_genes`` best-scoring genes per program)."""
        dt_repl = str(density_threshold).replace(".", "_")

        def read(key):
            return load_df_from_text(self.paths[key] % (K, dt_repl))

        scores = read("gene_spectra_score__txt")
        spectra_tpm = read("gene_spectra_tpm__txt")
        usage = read("consensus_usages__txt")
        scores = Frame(scores.values.T, scores.columns, scores.index)
        spectra_tpm = Frame(spectra_tpm.values.T, spectra_tpm.columns,
                            spectra_tpm.index)
        if norm_usage:
            usage = Frame(usage.values / usage.values.sum(axis=1,
                                                          keepdims=True),
                          usage.index, usage.columns)
        top = np.stack([
            np.asarray(scores.index)[np.argsort(-scores.values[:, j],
                                                kind="stable")[:n_top_genes]]
            for j in range(scores.shape[1])], axis=1)
        top_genes = Frame(top, np.arange(top.shape[0]), scores.columns)
        return usage, scores, spectra_tpm, top_genes


def _frobenius_prediction_error(X, H, W) -> float:
    """``||X - HW||_F^2`` in float64 from ``H^T X``, ``H^T H`` and
    ``||X||^2``, without a dense cells x genes buffer for sparse X."""
    H = np.asarray(H, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64)
    if sp.issparse(X):
        # the squares and their sum in f64, as the streamed pass takes them
        # (an f32 sum of f32 squares is off by about 1e-6 of ||X||^2);
        # numpy's pairwise sum, not a BLAS dot, whose order follows the
        # thread count
        Xc = X.tocsr()
        if not Xc.has_canonical_format:
            Xc = Xc.copy()
            Xc.sum_duplicates()
        data = Xc.data.astype(np.float64)
        data *= data
        x_sq = float(data.sum())
        HtX = np.asarray((X.T @ H).T)
    else:
        Xd = np.asarray(X, dtype=np.float64)
        x_sq = float((Xd * Xd).sum())
        HtX = H.T @ Xd
    cross = float(np.sum(HtX * W))
    hw_sq = float(np.sum(((H.T @ H) @ W) * W))
    return max(x_sq - 2.0 * cross + hw_sq, 0.0)
