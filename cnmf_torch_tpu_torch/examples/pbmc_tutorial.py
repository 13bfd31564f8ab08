"""Tutorial: PBMC-style end-to-end cNMF workflow from an .h5ad file.

The port's counterpart of the JAX package's ``examples/pbmc_tutorial.py``
(the reference's PBMC3k walkthrough,
``Tutorials/analyze_pbmc_example_data.ipynb``; a PBMC3k-SHAPED dataset —
2,700 cells, sparse counts, ~10 planted immune-like programs, matched
library-size distribution — is simulated in-process). The workflow is the
reference's:

1. write the counts as ``.h5ad`` (the tutorial's input format; without
   h5py, as a 10x ``matrix.mtx`` directory, said on stderr);
2. ``prepare``: TPM + 2,000 HVGs + variance normalization + seed ledger
   for K = 5..11 x n_iter replicates;
3. ``factorize`` all replicates (one batched sweep per K);
4. ``combine`` + ``k_selection_plot`` -> pick K at the stability peak;
5. two-pass ``consensus`` (unfiltered 2.0 pass to read the distance
   histogram, then the 0.1-filtered pass — `Stepwise_Guide.md:98`);
6. ``load_results``: usages, z-score spectra, TPM spectra, top genes.

Run:  python -m cnmf_torch_tpu_torch.examples.pbmc_tutorial [DIR]
      [--device cpu]
"""

import os

import numpy as np

from ._common import ensure_dir, head_text, run_cli, write_counts


def simulate_pbmc_like(n_cells=2700, n_genes=3000, k_true=10, seed=3):
    """PBMC3k-shaped counts: a few dominant cell-identity programs plus
    minor activity programs, steep depth distribution, sparse."""
    rng = np.random.default_rng(seed)
    programs = rng.gamma(0.25, 1.0, size=(k_true, n_genes))
    block = n_genes // k_true
    for k in range(k_true):
        programs[k, k * block:(k + 1) * block] *= 10.0
    programs /= programs.sum(axis=1, keepdims=True)
    # identity-like usage: most cells dominated by one program
    usage = rng.dirichlet(np.full(k_true, 0.08), size=n_cells)
    depth = np.exp(rng.normal(7.6, 0.35, size=(n_cells, 1)))  # ~2k median
    counts = rng.poisson(usage @ programs * depth).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return counts, usage, programs


def main(output_dir=None, n_cells=2700, n_genes=3000, n_iter=20,
         ks=None, k_final=None, device="cuda"):
    import scipy.sparse as sp

    from ..device import resolve_device
    from ..models.cnmf import cNMF
    from ..utils.io import Counts, load_df_from_npz

    resolve_device(device)
    output_dir = ensure_dir(output_dir, "cnmf_pbmc_")
    counts, usage_true, programs_true = simulate_pbmc_like(
        n_cells=n_cells, n_genes=n_genes)

    # the notebook starts from an .h5ad of raw counts — same here
    adata = Counts(sp.csr_matrix(counts),
                   np.asarray([f"cell_{i}" for i in range(n_cells)]),
                   np.asarray([f"gene_{j}" for j in range(n_genes)]))
    counts_fn = write_counts(
        os.path.join(output_dir, "pbmc_like_counts.h5ad"), adata)
    print(f"wrote {n_cells} x {n_genes} sparse counts -> {counts_fn}")

    ks = ks or list(range(5, 12))
    obj = cNMF(output_dir=output_dir, name="pbmc", device=device)
    obj.prepare(counts_fn, components=ks, n_iter=n_iter, seed=14,
                num_highvar_genes=2000)
    obj.factorize()            # the notebook's `cnmf factorize` worker pool
    obj.combine()
    obj.k_selection_plot(close_fig=True)
    print(f"K selection plot -> {obj.paths['k_selection_plot']}")

    # pick K the way the notebook does — at the stability (silhouette)
    # peak of the selection curve — unless the caller pinned one
    kstats = load_df_from_npz(obj.paths["k_selection_stats"])
    if k_final is None:
        k_final = int(kstats.column("k")[
            np.nanargmax(kstats.column("silhouette"))])
    print(f"chosen K = {k_final} (stability peak)")

    # two-pass consensus at the chosen K (Stepwise_Guide.md:98): first pass
    # unfiltered to see the replicate-distance histogram, then filtered
    obj.consensus(k_final, density_threshold=2.0, show_clustering=True,
                  close_clustergram_fig=True)
    obj.consensus(k_final, density_threshold=0.1, show_clustering=True,
                  close_clustergram_fig=True)
    usage, scores, tpm_spectra, top_genes = obj.load_results(
        K=k_final, density_threshold=0.1)
    print(f"consensus usages {usage.shape}; z-score spectra {scores.shape}")
    print("top genes per program:\n", head_text(top_genes))

    # sanity: recovered TPM spectra line up with planted programs (when
    # the chosen K is below the planted count, merged programs dilute the
    # tail correlations — require recovery for the top min(K, k_true))
    gene_idx = [int(g.split("_")[1]) for g in tpm_spectra.index]
    truth = programs_true[:, gene_idx]
    corr = np.corrcoef(np.vstack([truth, tpm_spectra.values.T]))[
        :truth.shape[0], truth.shape[0]:]
    best = np.sort(corr.max(axis=1))[::-1]
    print("planted-program best correlations:", np.round(best, 3))
    n_req = min(k_final, truth.shape[0]) - 1
    assert (best[:n_req] > 0.8).all(), "programs were not recovered"
    print(f"OK. Artifacts in {output_dir}/pbmc/")
    return best


if __name__ == "__main__":
    run_cli(main, __doc__)
