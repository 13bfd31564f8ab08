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
``CNMF_TPU_PROFILE_DIR`` traces each stage with ``torch.profiler``. One
departure: the JAX package's ``consensus`` stage times a file probe, and
here it times the ``consensus`` call itself.
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

from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import tracing as obs_tracing
from ..ops.hvg import highvar_genes
from ..ops.kernels import kernel_label
from ..ops.kmeans import kmeans
from ..ops.metrics import local_density as knn_local_density
from ..ops.metrics import silhouette_score
from ..ops.nmf import (beta_loss_to_float, fit_h, resolve_bf16_ratio,
                       resolve_online_schedule, run_nmf, run_nmf_use_ell,
                       sweep_x_mean)
from ..ops.ols import ols_all_cols
from ..ops.recipe import resolve_recipe
from ..ops.sketch import project_rows, resolve_consensus_sketch
from ..ops.sparse import (EllMatrix, csr_to_ell, ell_chunk_rows,
                          ell_row_width)
from ..ops.stats import (cell_scale_factors, column_moments_staged,
                         normalize_total, row_sums, scale_columns)
from ..parallel.replicates import (_auto_packed, replicate_sweep,
                                   worker_filter)
from ..runtime import faults, resilience
from ..utils.io import (Counts, Frame, atomic_artifact, load_counts,
                        load_df_from_npz, load_df_from_text, load_matrix,
                        save_df_to_npz, save_df_to_text, save_matrix)
from ..utils.paths import build_paths
from ..utils.profiling import StageTimer, trace
from ..utils.telemetry import EventLog, replicate_records

__all__ = ["cNMF"]

_LEDGER_COLUMNS = ["n_components", "iter", "nmf_seed", "completed"]


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
                 device="cuda"):
        self.device = resolve_device(device)
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
            tpm = Counts(normalize_total(counts.X, 1e6, totals, device=dev),
                         counts.obs_names, counts.var_names)
            counts_moments, tpm_moments = column_moments_staged(
                counts.X, row_scale=cell_scale_factors(totals, 1e6),
                device=dev)
        else:
            tpm = load_counts(tpm_fn, densify=densify)
            tpm_moments, _ = column_moments_staged(tpm.X, device=dev)
            counts_moments, _ = column_moments_staged(counts.X, device=dev)
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
        save_matrix(self.paths["normalized_counts"], norm_counts.X,
                    norm_counts.obs_names, norm_counts.var_names)

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
                  replicates_per_batch=None, packed=None):
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
                replicates_per_batch=replicates_per_batch, packed=packed)
        finally:
            obs_tracing.emit_span(
                self._events, ctx, "factorize.worker",
                obs_tracing.perf_to_wall(t0),
                (time.perf_counter() - t0) * 1e3, worker=int(worker_i))
            obs_metrics.emit_snapshot(self._events)

    def _factorize_impl(self, worker_i, total_workers, skip_completed_runs,
                        batched, replicates_per_batch, packed):
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        norm = load_matrix(self.paths["normalized_counts"])
        kw = self._solver_params()
        beta = beta_loss_to_float(kw["beta_loss"])
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
        # the lane, the recipe and the bf16 decision, resolved once for
        # both lanes. The lane: the JAX planner's rule (resolve_encoding:
        # sparse input, beta in {1, 0}, random init and plain MU, then the
        # dispatch rule); the sequential lane's run_nmf also reads
        # fp_precision
        use_ell = run_nmf_use_ell(
            X, beta, init=init, algo=algo,
            fp_precision=("float" if batched
                          else kw.get("fp_precision", "float")))
        by_k: dict[int, list] = {}
        if batched:
            if use_ell and packed:
                raise ValueError(
                    "packed K-sweeps run dense only; set "
                    "CNMF_TPU_SPARSE_BETA=0 to keep packed=True, or drop "
                    "packed for the ELL path")
            if packed and init != "random":
                raise ValueError(
                    "packed K-sweeps require init='random' (the nndsvd "
                    "family's SVD base is K-truncated); rerun with "
                    "packed=False / --per-k-programs")
            for idx in jobs:
                by_k.setdefault(int(ks[idx]), []).append(
                    (int(iters[idx]), int(seeds[idx])))
            if packed is None:
                packed = _auto_packed(
                    use_ell, algo, init, len(by_k),
                    max((len(t) for t in by_k.values()), default=0),
                    total_workers)
        packed = bool(packed) and batched
        X_host = X
        density = X.nnz / max(n * g, 1) if sp.issparse(X) else 1.0
        if use_ell:
            Xe = (ell_chunk_rows(X, chunk)[0] if mode == "online"
                  else csr_to_ell(X))
            X = Xe.to(self.device)
            print("factorize: ELL sparse path engaged for beta=%g "
                  "(density %.3f, width %d of %d genes)."
                  % (beta, density, X.width, g))
        # the batched lane sizes the recipe to its sweeps; the sequential
        # lane resolves it as a run_nmf call would (the JAX package's
        # rule), and pins it on every call
        sizes = (dict(n=n, g=g, k=int(ks.max()) if ks.size else None,
                      ell_width=X.width if use_ell else None)
                 if batched else {})
        recipe = resolve_recipe(beta, mode, algo=algo, ell=use_ell, **sizes)
        bf16 = (False if recipe.kl_newton or recipe.algo == "sketch"
                else resolve_bf16_ratio(beta, mode))
        kernel = kernel_label(use_ell, self.device, bf16, beta)
        if batched and sp.issparse(X_host) and beta in (1.0, 0.0):
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
            device=self.device)
        for k, tasks in sorted(by_k.items()):
            its = [t[0] for t in tasks]
            seeds_k = [t[1] for t in tasks]
            print("[Worker %d]. Running %d replicates for k=%d as one "
                  "batched solve." % (worker_i, len(tasks), k))
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
        self._events.emit("replicates", k=payload["k"], beta=payload["beta"],
                          mode=payload["mode"], cap=int(payload["cap"]),
                          cadence=payload["cadence"],
                          recipe=payload.get("recipe"),
                          kernel=payload.get("kernel"),
                          records=replicate_records(payload))

    def _write_iter_spectra(self, k, it, spectrum, columns):
        """One replicate's spectra artifact (atomic; stored, not
        deflated)."""
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
        the dispatch rule. ``usage`` warm-starts the solve."""
        kw = self._solver_params()
        return fit_h(
            X, np.asarray(spectra, dtype=np.float32),
            H_init=None if usage is None else np.asarray(usage),
            chunk_size=int(kw["online_chunk_size"]),
            chunk_max_iter=int(kw["online_chunk_max_iter"]), h_tol=0.05,
            l1_reg_H=float(kw["l1_ratio_H"]), l2_reg_H=0.0,
            beta=beta_loss_to_float(kw["beta_loss"]), device=self.device)

    def refit_spectra(self, X, usage) -> np.ndarray:
        """Spectra for fixed usages by the transpose trick: the usage refit
        of ``X.T`` against ``usage.T``."""
        Xt = X.T.tocsr() if sp.issparse(X) else np.asarray(X).T
        return self.refit_usage(Xt, np.asarray(usage).T).T

    # ------------------------------------------------------------------
    # consensus
    # ------------------------------------------------------------------

    def _consensus(self, k, density_threshold=0.5,
                   local_neighborhood_size=0.30, show_clustering=False,
                   build_ref=True, skip_density_and_return_after_stats=False,
                   refit_usage=True, normalize_tpm_spectra=False,
                   norm_counts=None, _sketch=None):
        """Consensus spectra and usages from the merged replicate matrix:
        L2-normalize, filter outliers by KNN local density (cached), k-means
        (k, 10 inits, seed 1), cluster medians, usage refits, TPM- and
        z-score-unit spectra. With ``skip_density_and_return_after_stats``
        returns the K-selection statistics instead of writing artifacts.
        The clustergram figure is not ported (no matplotlib on the card's
        machine).

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
        :meth:`k_selection_stats`, in place of a per-K one."""
        if show_clustering:
            raise NotImplementedError(
                "the clustergram figure is not ported yet")
        dev = self.device
        k = int(k)
        merged = load_df_from_npz(self.paths["merged_spectra"] % k)
        if norm_counts is None:
            norm_counts = load_matrix(self.paths["normalized_counts"])
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
        if not skip_density_and_return_after_stats:
            cache = self.paths["local_density_cache"] % k
            if not sk.engaged and os.path.isfile(cache):
                density = load_df_from_npz(cache).values[:, 0]
            else:
                with self._timer.stage("consensus.density"):
                    density, _ = knn_local_density(feats, n_neighbors,
                                                   device=dev)
                if not sk.engaged:
                    # projected densities never enter the exact cache
                    save_df_to_npz(Frame(density[:, None], index,
                                         np.asarray(["local_density"])),
                                   cache)
            keep = density < density_threshold
            if not keep.any():
                raise RuntimeError(
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
            usages = self.refit_usage(norm_counts.X, median)
        if skip_density_and_return_after_stats:
            silhouette = silhouette_score(feats, labels, k, device=dev)
            error = _frobenius_prediction_error(norm_counts.X, usages,
                                                median)
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
            spectra_tpm = self.refit_spectra(tpm.X,
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
                usages = self._final_refit(tpm, tpm_stats, spectra_tpm)

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
        if build_ref:
            with self._timer.stage("consensus.build_ref"):
                self.build_reference(k, density_threshold, spectra_tpm=tpm_f)
        return None

    consensus = _timed("consensus")(_consensus)

    def _final_refit(self, tpm: Counts, tpm_stats: Frame, spectra_tpm):
        """The final usage refit on the HVG TPM scaled to unit (ddof=1)
        variance, with the spectra in the same units."""
        hv = _positions(tpm.var_names, self._hvgs())
        std = np.asarray(tpm_stats.column("__std"), np.float64)[hv]
        spectra_rf = spectra_tpm[:, hv] / std[None, :]
        n_rows = tpm.X.shape[0]
        bessel = n_rows / (n_rows - 1.0) if n_rows > 1 else 1.0
        div = np.sqrt(std ** 2 * bessel).astype(np.float32)
        if sp.issparse(tpm.X):
            div[div == 0] = 1.0
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
        norm_counts = load_matrix(self.paths["normalized_counts"])
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
                                norm_counts=norm_counts,
                                _sketch=sk).values[:, 0]
                for k in ks]
        stats = Frame(np.stack(rows), np.arange(len(rows)),
                      np.asarray(["k", "local_density_threshold",
                                  "silhouette", "prediction_error"]))
        save_df_to_npz(stats, self.paths["k_selection_stats"])
        return stats

    @_timed("k_selection_plot")
    def k_selection_plot(self, close_fig=False):
        """The JAX package's K-selection step: writes the statistics of
        :meth:`k_selection_stats` (``<name>.k_selection_stats.df.npz``)
        and returns them. The stability/error figure is not written yet:
        the plots (matplotlib) come to the port later. ``close_fig`` is
        accepted for the JAX package's signature."""
        stats = self.k_selection_stats()
        print("k_selection_plot: wrote %s; the K-selection figure is not "
              "written yet (plots are not ported)."
              % self.paths["k_selection_stats"])
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
        x_sq = float(X.multiply(X).sum())
        HtX = np.asarray((X.T @ H).T)
    else:
        Xd = np.asarray(X, dtype=np.float64)
        x_sq = float((Xd * Xd).sum())
        HtX = H.T @ Xd
    cross = float(np.sum(HtX * W))
    hw_sq = float(np.sum(((H.T @ H) @ W) * W))
    return max(x_sq - 2.0 * cross + hw_sq, 0.0)
