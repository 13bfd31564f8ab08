"""Tutorial: full cNMF analysis on simulated data with known ground truth.

The port's counterpart of the JAX package's ``examples/simulated_tutorial.py``
(the reference's simulated-data walkthrough,
``Tutorials/analyze_simulated_example_data.ipynb``; the data is generated
in-process, so the tutorial is self-contained). Simulates cells as mixtures
of K_TRUE gene expression programs, runs prepare -> factorize -> combine ->
k_selection -> consensus, and checks that the consensus spectra recover the
planted programs.

Run:  python -m cnmf_torch_tpu_torch.examples.simulated_tutorial [DIR]
      [--device cpu]
"""

import numpy as np

from ..models.cnmf import _positions, cNMF
from ._common import ensure_dir, head_text, run_cli


def simulate_counts(n_cells=1000, n_genes=1500, k_true=6, seed=0):
    """Cells = Dirichlet mixtures of k_true gamma-shaped programs, counts
    Poisson-sampled — the same generative idea as the scsim simulator the
    reference tutorial uses, minus its doublet machinery."""
    rng = np.random.default_rng(seed)
    programs = rng.gamma(0.3, 1.0, size=(k_true, n_genes))
    # each program strongly marks its own gene block
    block = n_genes // k_true
    for k in range(k_true):
        programs[k, k * block:(k + 1) * block] *= 8.0
    programs /= programs.sum(axis=1, keepdims=True)
    usage = rng.dirichlet(np.full(k_true, 0.15), size=n_cells)
    rate = usage @ programs
    depth = rng.integers(2000, 6000, size=(n_cells, 1)).astype(float)
    counts = rng.poisson(rate * depth).astype(float)
    return counts, usage, programs


def main(output_dir=None, device="cuda"):
    from ..device import resolve_device
    from ..utils.io import Frame, save_df_to_npz

    resolve_device(device)
    output_dir = ensure_dir(output_dir, "cnmf_tutorial_")
    k_true = 6
    counts, usage_true, programs_true = simulate_counts(k_true=k_true)
    genes = np.asarray([f"gene_{j}" for j in range(counts.shape[1])])
    counts_df = Frame(counts,
                      np.asarray([f"cell_{i}" for i in range(counts.shape[0])]),
                      genes)
    counts_fn = f"{output_dir}/sim_counts.df.npz"
    save_df_to_npz(counts_df, counts_fn)
    print(f"simulated {counts.shape[0]} cells x {counts.shape[1]} genes "
          f"with {k_true} planted programs -> {counts_fn}")

    # ------------------------------------------------------------------
    # the five pipeline stages (identical to the CLI workflow)
    # ------------------------------------------------------------------
    obj = cNMF(output_dir=output_dir, name="sim_run", device=device)
    ks = list(range(4, 9))
    obj.prepare(counts_fn, components=ks, n_iter=20, seed=14,
                num_highvar_genes=800)
    obj.factorize()                       # all 5 Ks x 20 replicates
    obj.combine()
    obj.k_selection_plot(close_fig=True)
    print(f"K-selection plot: {obj.paths['k_selection_plot']}")

    # the documented two-pass consensus workflow: first pass unfiltered
    # (threshold 2.0) to see the replicate-distance histogram in the
    # clustergram figure, then re-run with the threshold set at the
    # outlier notch (cheap: the distance matrix is cached per K)
    obj.consensus(k_true, density_threshold=2.0, show_clustering=True,
                  close_clustergram_fig=True)
    print(f"inspect {obj.paths['clustering_plot'] % (k_true, '2_0')} "
          "for the density histogram, then filter:")
    obj.consensus(k_true, density_threshold=0.2, show_clustering=True,
                  close_clustergram_fig=True)
    usage, scores, tpm, top_genes = obj.load_results(
        K=k_true, density_threshold=0.2)
    print(f"consensus usages: {usage.shape}, spectra scores: {scores.shape}")
    print("top genes per program:\n", head_text(top_genes))

    # ------------------------------------------------------------------
    # ground-truth check: each planted program should correlate strongly
    # with exactly one recovered TPM-unit spectrum
    # ------------------------------------------------------------------
    # load_results returns spectra as genes x K (reference orientation)
    gene_idx = _positions(genes, tpm.index)
    truth = programs_true[:, gene_idx]
    corr = np.corrcoef(np.vstack([truth, tpm.values.T]))[
        :k_true, k_true:]                      # (true x recovered)
    best = corr.max(axis=1)
    print("per-planted-program best correlation:", np.round(best, 3))
    assert (best > 0.95).all(), "a planted program was not recovered"
    print("OK: all planted programs recovered (r > 0.95). "
          f"Artifacts in {output_dir}/sim_run/")


if __name__ == "__main__":
    run_cli(main, __doc__)
