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
(``ops/recipe.py``: batch KL runs ``dna``, batch IS ``amu``).
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import uuid
import warnings

import numpy as np
import scipy.sparse as sp

from ..device import resolve_device
from ..ops.hvg import highvar_genes
from ..ops.kernels import kernel_label
from ..ops.kmeans import kmeans
from ..ops.metrics import local_density as knn_local_density
from ..ops.metrics import silhouette_score
from ..ops.nmf import (beta_loss_to_float, fit_h, lane_health,
                       resolve_bf16_ratio, resolve_online_schedule,
                       run_nmf_use_ell)
from ..ops.ols import ols_all_cols
from ..ops.recipe import resolve_recipe
from ..ops.sparse import csr_to_ell, ell_chunk_rows
from ..ops.stats import (cell_scale_factors, column_moments_staged,
                         normalize_total, row_sums, scale_columns)
from ..parallel.replicates import (_auto_packed, replicate_sweep,
                                   worker_filter)
from ..utils.io import (Counts, Frame, atomic_artifact, load_counts,
                        load_df_from_npz, load_df_from_text, load_matrix,
                        save_df_to_npz, save_df_to_text, save_matrix)
from ..utils.paths import build_paths

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
        # what the last factorize ran: lane, kernel label, solver recipe
        # and, per K, the solver trace of every slice of replicates
        # (online: ``(passes, R)`` per-pass objectives; batch: a
        # ``SolverTelemetry``) and, for dna, each replicate's fallback
        # fraction
        self.factorize_info: dict = {}

    # ------------------------------------------------------------------
    # prepare
    # ------------------------------------------------------------------

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

    def save_nmf_iter_params(self, replicate_params: Frame, run_params):
        save_df_to_npz(replicate_params,
                       self.paths["nmf_replicate_parameters"])
        with atomic_artifact(self.paths["nmf_run_parameters"]) as tmp:
            with open(tmp, "w") as f:
                json.dump(run_params, f, indent=1, sort_keys=True)

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

    def factorize(self, worker_i=0, total_workers=1,
                  replicates_per_batch=None, packed=None):
        """Run this worker's share of the replicate ledger: the tasks are
        grouped per K and each group runs as one batched replicate sweep
        (``parallel/replicates.py``) in the parameters file's ``mode``. A
        sparse normalized matrix with a KL or IS ledger takes the ELL lane
        under the dispatch rule (density <= 0.10 and width <= genes / 8):
        row chunks online, the whole matrix with its transpose index set in
        batch mode. The solver recipe is resolved once (``ops/recipe.py``)
        and recorded in ``factorize_info`` and the provenance. A replicate
        whose objective or spectra are not finite is reported and not
        written.

        ``packed`` (default None: the JAX planner's rule, a dense
        random-init ``mu`` ledger of >= 4 Ks with <= 32 replicates a K
        across the workers; ``True``/``False`` pin it, CLI
        ``--per-k-programs`` is ``False``) is accepted for parity with the
        JAX package, with its refusals, and recorded in ``factorize_info``
        and the provenance (``batched-packed``). It selects no other work:
        the JAX package packs the Ks into one program so that XLA compiles
        once, and eager PyTorch compiles nothing per K, so a packed run is
        the per-K sweeps and writes their iter spectra."""
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
        # the JAX planner's lane rule (resolve_encoding): sparse input,
        # beta in {1, 0}, random init and plain MU, then the dispatch rule
        use_ell = run_nmf_use_ell(X, beta, init=init, algo=algo)
        if use_ell and packed:
            raise ValueError(
                "packed K-sweeps run dense only; set CNMF_TPU_SPARSE_BETA=0 "
                "to keep packed=True, or drop packed for the ELL path")
        if packed and init != "random":
            raise ValueError(
                "packed K-sweeps require init='random' (the nndsvd family's "
                "SVD base is K-truncated); rerun with packed=False / "
                "--per-k-programs")
        ks = _ledger_ints(ledger, "n_components")
        iters = _ledger_ints(ledger, "iter")
        seeds = _ledger_ints(ledger, "nmf_seed")
        by_k: dict[int, list] = {}
        for idx in worker_filter(range(len(ks)), worker_i, total_workers):
            by_k.setdefault(int(ks[idx]), []).append(
                (int(iters[idx]), int(seeds[idx])))
        if packed is None:
            packed = _auto_packed(
                use_ell, algo, init, len(by_k),
                max((len(t) for t in by_k.values()), default=0),
                total_workers)
        packed = bool(packed)
        if use_ell:
            Xe = (ell_chunk_rows(X, chunk)[0] if mode == "online"
                  else csr_to_ell(X))
            density = X.nnz / max(n * g, 1)
            X = Xe.to(self.device)
            print("factorize: ELL sparse path engaged for beta=%g "
                  "(density %.3f, width %d of %d genes)."
                  % (beta, density, X.width, g))
        recipe = resolve_recipe(
            beta, mode, algo=algo, ell=use_ell, n=n, g=g,
            k=int(ks.max()) if ks.size else None,
            ell_width=X.width if use_ell else None)
        bf16 = False if recipe.kl_newton else resolve_bf16_ratio(beta, mode)
        h_tol, n_passes, h_tol_start = resolve_online_schedule(beta)
        self.factorize_info = {
            "lane": "ell" if use_ell else "dense", "mode": mode,
            "packed": packed,
            "kernel": kernel_label(use_ell, self.device, bf16, beta),
            "solver_recipe": recipe.label,
            "inner_repeats": int(recipe.inner_repeats),
            "kl_newton": bool(recipe.kl_newton),
            "bf16_ratio": bf16, "online_h_tol": h_tol, "n_passes": n_passes,
            "online_h_tol_start": h_tol_start, "trace": {}, "errs": {},
            "dna_fallback": {}}
        with atomic_artifact(self.paths["factorize_provenance"]
                             % int(worker_i)) as tmp:
            with open(tmp, "w") as f:
                json.dump({"worker_index": int(worker_i),
                           "engaged_path": "batched-" + (
                               "packed" if packed else
                               "ell" if use_ell else "dense"),
                           "effective_params": dict(
                               {k: v for k, v in kw.items()
                                if k != "n_jobs"},
                               **{k: v for k, v in self.factorize_info.items()
                                  if k not in ("trace", "errs",
                                               "dna_fallback")})},
                          f, indent=1, sort_keys=True)
        for k, tasks in sorted(by_k.items()):
            print("[Worker %d]. Running %d replicates for k=%d as one "
                  "batched solve." % (worker_i, len(tasks), k))
            trace: list = []
            spectra, _, errs = replicate_sweep(
                X, [t[1] for t in tasks], k, beta_loss=kw["beta_loss"],
                init=init, mode=mode, tol=kw.get("tol", 1e-4),
                online_chunk_size=chunk,
                online_chunk_max_iter=kw.get("online_chunk_max_iter", 1000),
                alpha_W=kw.get("alpha_W", 0.0),
                l1_ratio_W=kw.get("l1_ratio_W", 0.0),
                alpha_H=kw.get("alpha_H", 0.0),
                l1_ratio_H=kw.get("l1_ratio_H", 0.0),
                replicates_per_batch=replicates_per_batch,
                n_rows=n if use_ell else None, trace=trace, recipe=recipe,
                device=self.device)
            self.factorize_info["trace"][k] = trace
            self.factorize_info["errs"][k] = errs
            if recipe.kl_newton and mode == "batch":
                self.factorize_info["dna_fallback"][k] = np.concatenate(
                    [t.dna_fallback for t in trace])
            healthy = lane_health(errs, spectra=spectra)
            for r, (it, seed) in enumerate(tasks):
                if not healthy[r]:
                    print("[Worker %d]. Replicate k=%d iter=%d (seed %d) "
                          "diverged (objective %r); not written."
                          % (worker_i, k, it, seed, float(errs[r])))
                    continue
                save_df_to_npz(Frame(spectra[r], np.arange(1, k + 1),
                                     norm.var_names),
                               self.paths["iter_spectra"] % (k, it),
                               compress=False)

    # ------------------------------------------------------------------
    # combine
    # ------------------------------------------------------------------

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
        genes)`` matrix with ``iter%d_topic%d`` row labels. A missing or
        invalid file raises, or is skipped with ``skip_missing_files``."""
        ledger = load_df_from_npz(self.paths["nmf_replicate_parameters"])
        print("Combining factorizations for k=%d." % k)
        ks = _ledger_ints(ledger, "n_components")
        iters = np.sort(_ledger_ints(ledger, "iter")[ks == k])
        parts, labels, columns = [], [], None
        for it in iters:
            fn = self.paths["iter_spectra"] % (k, it)
            problem = None
            if not os.path.exists(fn):
                problem = "missing"
            else:
                df = load_df_from_npz(fn)
                if df.values.shape[0] != k or not np.isfinite(
                        df.values).all():
                    problem = f"invalid (shape {df.values.shape})"
            if problem is not None:
                if not skip_missing_files:
                    raise FileNotFoundError(
                        f"{fn} is {problem}; combine with "
                        "skip_missing_files=True to drop it")
                print("Skipping %s file: %s" % (problem, fn))
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

    def consensus(self, k, density_threshold=0.5,
                  local_neighborhood_size=0.30, show_clustering=False,
                  build_ref=True, skip_density_and_return_after_stats=False,
                  refit_usage=True, normalize_tpm_spectra=False,
                  norm_counts=None):
        """Consensus spectra and usages from the merged replicate matrix:
        L2-normalize, filter outliers by KNN local density (cached), k-means
        (k, 10 inits, seed 1), cluster medians, usage refits, TPM- and
        z-score-unit spectra. With ``skip_density_and_return_after_stats``
        returns the K-selection statistics instead of writing artifacts.
        The clustergram figure is not ported (no matplotlib on the card's
        machine)."""
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
        keep = np.ones(l2.shape[0], dtype=bool)
        if not skip_density_and_return_after_stats:
            cache = self.paths["local_density_cache"] % k
            if os.path.isfile(cache):
                density = load_df_from_npz(cache).values[:, 0]
            else:
                density, _ = knn_local_density(l2, n_neighbors, device=dev)
                save_df_to_npz(Frame(density[:, None], index,
                                     np.asarray(["local_density"])), cache)
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
        l2 = l2[keep]
        labels, _centers, _inertia = kmeans(l2, k, n_init=10, seed=1,
                                            device=dev)
        # cluster medians (clusters in label order), rows renormalized
        clusters = np.unique(labels)
        median = np.stack([np.median(l2[labels == c], axis=0)
                           for c in clusters])
        median = median / median.sum(axis=1, keepdims=True)

        if skip_density_and_return_after_stats:
            usages = self.refit_usage(norm_counts.X, median)
            silhouette = silhouette_score(l2, labels, k, device=dev)
            error = _frobenius_prediction_error(norm_counts.X, usages,
                                                median)
            return Frame(np.asarray([[k], [density_threshold], [silhouette],
                                     [error]], dtype=np.float64),
                         np.asarray(["k", "local_density_threshold",
                                     "silhouette", "prediction_error"]),
                         np.asarray(["stats"]))

        usages = self.refit_usage(norm_counts.X, median)
        # order the programs by their total share of usage
        norm_usages = usages / usages.sum(axis=1, keepdims=True)
        order = np.argsort(-norm_usages.sum(axis=0), kind="stable")
        usages, norm_usages, median = (usages[:, order],
                                       norm_usages[:, order], median[order])
        programs = np.arange(1, len(order) + 1)

        tpm = load_matrix(self.paths["tpm"])
        tpm_stats = load_df_from_npz(self.paths["tpm_stats"])
        spectra_tpm = self.refit_spectra(tpm.X,
                                         norm_usages.astype(np.float32))
        if normalize_tpm_spectra:
            spectra_tpm = (spectra_tpm / spectra_tpm.sum(axis=1,
                                                         keepdims=True)
                           * 1e6)
        usage_coef = ols_all_cols(usages, tpm.X, normalize_y=True,
                                  device=dev)

        hvgs = self._hvgs()
        if refit_usage:
            # final usage refit on the HVG TPM scaled to unit (ddof=1)
            # variance, with the spectra in the same units
            hv = _positions(tpm.var_names, hvgs)
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
            usages = self.refit_usage(X_rf, spectra_rf.astype(np.float32))

        median_f = Frame(median.astype(np.float32), programs,
                         np.asarray(norm_counts.var_names))
        usages_f = Frame(usages, np.asarray(norm_counts.obs_names), programs)
        tpm_f = Frame(spectra_tpm, programs, np.asarray(tpm.var_names))
        score_f = Frame(usage_coef, programs, np.asarray(tpm.var_names))
        for key, frame in (("consensus_spectra", median_f),
                           ("consensus_usages", usages_f),
                           ("gene_spectra_tpm", tpm_f),
                           ("gene_spectra_score", score_f)):
            save_df_to_npz(frame, self.paths[key] % (k, dt_repl))
            save_df_to_text(frame, self.paths[key + "__txt"] % (k, dt_repl))
        if build_ref:
            self.build_reference(k, density_threshold, spectra_tpm=tpm_f)
        return None

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
        ledger, written as ``k_selection_stats`` (the figure is not ported:
        no matplotlib on the card's machine)."""
        ks = self.ledger_components()
        if not ks:
            raise ValueError("the replicate ledger lists no components; "
                             "run prepare() with a non-empty components list")
        norm_counts = load_matrix(self.paths["normalized_counts"])
        rows = [self.consensus(k, skip_density_and_return_after_stats=True,
                               norm_counts=norm_counts).values[:, 0]
                for k in ks]
        stats = Frame(np.stack(rows), np.arange(len(rows)),
                      np.asarray(["k", "local_density_threshold",
                                  "silhouette", "prediction_error"]))
        save_df_to_npz(stats, self.paths["k_selection_stats"])
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
