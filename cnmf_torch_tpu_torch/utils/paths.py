"""Artifact path registry — the JAX package's filenames (``utils/paths.py``
there), with the two h5ad intermediates stored as matrix ``.npz`` files
(``utils/io.py:save_matrix``) and the solver-parameter file written as
JSON at the same ``.yaml`` path (JSON is valid YAML)."""

from __future__ import annotations

import os

from .io import check_dir_exists

__all__ = ["build_paths"]


def build_paths(output_dir: str, name: str, create: bool = True) -> dict:
    if create:
        check_dir_exists(os.path.join(output_dir, name, "cnmf_tmp"))
    tmp = os.path.join(output_dir, name, "cnmf_tmp")
    top = os.path.join(output_dir, name)

    def t(suffix):
        return os.path.join(tmp, name + suffix)

    def o(suffix):
        return os.path.join(top, name + suffix)

    return {
        "normalized_counts": t(".norm_counts.npz"),
        "nmf_replicate_parameters": t(".nmf_params.df.npz"),
        "nmf_run_parameters": t(".nmf_idvrun_params.yaml"),
        "nmf_genes_list": o(".overdispersed_genes.txt"),
        "tpm": t(".tpm.npz"),
        "tpm_stats": t(".tpm_stats.df.npz"),
        "iter_spectra": t(".spectra.k_%d.iter_%d.df.npz"),
        "iter_usages": t(".usages.k_%d.iter_%d.df.npz"),
        "merged_spectra": t(".spectra.k_%d.merged.df.npz"),
        "local_density_cache": t(".local_density_cache.k_%d.merged.df.npz"),
        "consensus_spectra": t(".spectra.k_%d.dt_%s.consensus.df.npz"),
        "consensus_spectra__txt": o(".spectra.k_%d.dt_%s.consensus.txt"),
        "consensus_usages": t(".usages.k_%d.dt_%s.consensus.df.npz"),
        "consensus_usages__txt": o(".usages.k_%d.dt_%s.consensus.txt"),
        "consensus_stats": t(".stats.k_%d.dt_%s.df.npz"),
        "clustering_plot": o(".clustering.k_%d.dt_%s.png"),
        "gene_spectra_score": t(".gene_spectra_score.k_%d.dt_%s.df.npz"),
        "gene_spectra_score__txt": o(".gene_spectra_score.k_%d.dt_%s.txt"),
        "gene_spectra_tpm": t(".gene_spectra_tpm.k_%d.dt_%s.df.npz"),
        "gene_spectra_tpm__txt": o(".gene_spectra_tpm.k_%d.dt_%s.txt"),
        "starcat_spectra": t(".starcat_spectra.k_%d.dt_%s.df.npz"),
        "starcat_spectra__txt": o(".starcat_spectra.k_%d.dt_%s.txt"),
        "k_selection_plot": o(".k_selection.png"),
        "k_selection_stats": o(".k_selection_stats.df.npz"),
        "factorize_provenance": t(".factorize_provenance.w%d.yaml"),
        # per-worker resilience ledger: derived-seed retries and the
        # quarantined (k, iter) pairs that combine skips
        "resilience_ledger": t(".resilience.w%d.json"),
        # the out-of-core row-slab store of the normalized counts, and
        # the row-sharded solver's pass checkpoints (the JAX package's
        # names)
        "shard_store": t(".norm_counts.store"),
        "pass_checkpoint": t(".ckpt.k_%d.iter_%d.npz"),
    }
