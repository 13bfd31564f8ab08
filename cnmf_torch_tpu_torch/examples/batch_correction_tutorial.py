"""Tutorial: Harmony batch correction + CITE-seq preprocessing -> cNMF.

The port's counterpart of the JAX package's
``examples/batch_correction_tutorial.py`` (the reference's batch-correction
vignette, ``Tutorials/Batch_correction_vignette.ipynb``; an islets-shaped
dataset with planted programs AND planted per-batch gene effects is
simulated in-process, so the tutorial asserts its own success).

What it shows, end to end:

1. build a multi-batch CITE-seq-style dataset (RNA counts + a small ADT
   panel) with per-batch multiplicative gene effects — the nuisance signal
   Harmony removes;
2. ``Preprocess.preprocess_for_cnmf``: QC -> TP10K -> seurat_v3 HVGs ->
   PCA -> Harmony -> gene-space MOE ridge correction -> ADT hstack, saving
   the three files ``cNMF.prepare`` consumes (counts, tpm, HVG list; the
   two matrices as ``.h5ad``, or without h5py as ``.df.npz``, said on
   stderr);
3. verify the correction actually mixed the batches (batch silhouette in
   PCA space drops);
4. the standard cNMF stages on the corrected matrix, and a check that the
   planted biological programs — not the batch effects — are recovered.

Run:  python -m cnmf_torch_tpu_torch.examples.batch_correction_tutorial
      [DIR] [--device cpu]
"""

import os

import numpy as np

from ..models.cnmf import DensityFilterError, _positions, cNMF
from ._common import (ensure_dir, have_h5py, head_text, npz_in_place_of_h5ad,
                      run_cli)


def simulate_citeseq_batches(n_cells=4000, n_genes=2500, n_adt=12,
                             k_true=6, n_batches=3, seed=7):
    """Islets-shaped synthetic: cells are Dirichlet mixtures of k_true
    programs (shared biology), each batch applies its own multiplicative
    per-gene effect (technical nuisance), plus a small ADT antibody panel
    correlated with the programs (the CITE-seq surface)."""
    rng = np.random.default_rng(seed)
    programs = rng.gamma(0.3, 1.0, size=(k_true, n_genes))
    block = n_genes // k_true
    for k in range(k_true):
        programs[k, k * block:(k + 1) * block] *= 6.0
    programs /= programs.sum(axis=1, keepdims=True)
    usage = rng.dirichlet(np.full(k_true, 0.2), size=n_cells)
    batch = rng.integers(0, n_batches, size=n_cells)
    batch_fx = rng.gamma(25.0, 0.04, size=(n_batches, n_genes))
    depth = rng.integers(1500, 5000, size=(n_cells, 1)).astype(float)
    rate = (usage @ programs) * batch_fx[batch]
    counts = rng.poisson(rate * depth).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    # ADT panel: two antibodies per program, Poisson around usage signal
    adt_loadings = np.zeros((k_true, n_adt))
    for k in range(k_true):
        adt_loadings[k, (2 * k) % n_adt] = 1.0
        adt_loadings[k, (2 * k + 1) % n_adt] = 0.5
    adt = rng.poisson(usage @ adt_loadings * 50.0 + 5.0).astype(np.float32)
    return counts, adt, usage, programs, batch


def batch_silhouette(pcs, batch, device="cuda"):
    """Mean silhouette of the batch labels in PC space — HIGH means batches
    separate (bad), near-zero/negative means they mix (good)."""
    from ..ops.metrics import silhouette_score

    return float(silhouette_score(pcs.astype(np.float32),
                                  np.asarray(batch, dtype=np.int32),
                                  device=device))


def main(output_dir=None, n_cells=4000, n_genes=2500, n_iter=20, k_sel=None,
         device="cuda"):
    """Returns the batch silhouettes before and after Harmony, each planted
    program's best correlation with a recovered spectrum, and the density
    threshold the consensus kept (0.5, or 2.0 when 0.5 filtered out every
    replicate spectrum)."""
    import scipy.sparse as sp

    from ..device import resolve_device
    from ..models.preprocess import Preprocess
    from ..ops.pca import pca
    from ..utils.io import Counts, atomic_artifact, load_counts

    resolve_device(device)
    output_dir = ensure_dir(output_dir, "cnmf_batchcorr_")
    k_true = 6
    counts, adt, usage_true, programs_true, batch = simulate_citeseq_batches(
        n_cells=n_cells, n_genes=n_genes, k_true=k_true)

    # one counts object holding RNA + ADT columns, tagged by a
    # feature-type column — the 10x CITE-seq convention preprocess splits on
    X = sp.csr_matrix(np.hstack([counts, adt]))
    var_names = np.asarray(
        [f"gene_{j}" for j in range(counts.shape[1])]
        + [f"adt_{j}" for j in range(adt.shape[1])])
    var = {"feature_types": np.asarray(
        ["Gene Expression"] * counts.shape[1]
        + ["Antibody Capture"] * adt.shape[1], dtype=object)}
    obs = {"batch": np.asarray([f"donor{b}" for b in batch], dtype=object)}
    adata = Counts(X, np.asarray([f"cell_{i}" for i in range(n_cells)]),
                   var_names, obs=obs, var=var)
    print(f"simulated CITE-seq: {n_cells} cells x {counts.shape[1]} genes "
          f"+ {adt.shape[1]} ADTs, {len(set(batch))} batches, "
          f"{k_true} planted programs")

    # ------------------------------------------------------------------
    # Preprocess: QC -> TP10K -> HVG -> PCA -> Harmony -> MOE ridge -> ADT
    # ------------------------------------------------------------------
    base = os.path.join(output_dir, "islets_pre")
    h5py_here = have_h5py()
    pre = Preprocess(random_seed=14, device=device)
    rna, tp10k, hvgs = pre.preprocess_for_cnmf(
        adata, feature_type_col="feature_types", harmony_vars="batch",
        n_top_rna_genes=1500, librarysize_targetsum=1e6,
        save_output_base=base if h5py_here else None)
    counts_fn = base + ".Corrected.HVG.Varnorm.h5ad"
    tpm_fn = base + ".TP10K.h5ad"
    genes_fn = base + ".Corrected.HVGs.txt"
    if not h5py_here:
        counts_fn = npz_in_place_of_h5ad(counts_fn, rna)
        tpm_fn = npz_in_place_of_h5ad(tpm_fn, tp10k)
        with atomic_artifact(genes_fn) as tmp:
            with open(tmp, "w") as f:
                f.write("\n".join(hvgs))
    print("preprocess artifacts:", counts_fn)

    # did Harmony actually mix the batches? Compare batch silhouette in PC
    # space before vs after correction: it must drop substantially.
    corrected = load_counts(counts_fn)
    corr_X = (corrected.X.toarray()
              if sp.issparse(corrected.X) else np.asarray(corrected.X))
    raw_tp10k = np.asarray(counts / counts.sum(1, keepdims=True) * 1e4,
                           np.float32)
    hvg_names = [g for g in corrected.var_names if g.startswith("gene_")]
    hvg_idx = [int(g.split("_")[1]) for g in hvg_names]
    raw_hvg = raw_tp10k[:, hvg_idx]
    n_pcs = 20
    pcs_raw = np.asarray(pca(raw_hvg, n_pcs, device=device)[0])
    pcs_corr = np.asarray(pca(corr_X[:, :len(hvg_idx)], n_pcs,
                              device=device)[0])
    sil_raw = batch_silhouette(pcs_raw, batch, device=device)
    sil_corr = batch_silhouette(pcs_corr, batch, device=device)
    print(f"batch silhouette: raw={sil_raw:.3f} -> corrected={sil_corr:.3f}")
    assert sil_corr < sil_raw - 0.05 or sil_corr < 0.02, (
        "Harmony correction did not improve batch mixing")

    # ------------------------------------------------------------------
    # cNMF on the corrected matrix (three-file contract, README.md:88-92)
    # ------------------------------------------------------------------
    obj = cNMF(output_dir=output_dir, name="islets", device=device)
    k_sel = k_sel or k_true
    obj.prepare(counts_fn, components=[k_sel], n_iter=n_iter, seed=14,
                tpm_fn=tpm_fn, genes_file=genes_fn)
    obj.factorize()
    obj.combine()
    # only the density filter's own failure falls back to the looser
    # threshold; any other error raises
    try:
        obj.consensus(k_sel, density_threshold=0.5, show_clustering=False)
        dt = 0.5
    except DensityFilterError as e:
        print(f"density_threshold=0.5: {e}; rerunning at 2.0")
        obj.consensus(k_sel, density_threshold=2.0, show_clustering=False)
        dt = 2.0
    usage, scores, tpm_spectra, top_genes = obj.load_results(
        K=k_sel, density_threshold=dt)
    print(f"consensus usages {usage.shape}; top genes:\n"
          f"{head_text(top_genes)}")

    # planted-program recovery on the BIOLOGY, not the batch effects: each
    # planted program must correlate with a recovered RNA spectrum
    rna_cols = [g for g in tpm_spectra.index if g.startswith("gene_")]
    rec = tpm_spectra.values[_positions(tpm_spectra.index, rna_cols)].T
    truth = programs_true[:, [int(g.split("_")[1]) for g in rna_cols]]
    corr = np.corrcoef(np.vstack([truth, rec]))[:k_true, k_true:]
    best = corr.max(axis=1)
    print("per-planted-program best correlation:", np.round(best, 3))
    assert (best > 0.8).sum() >= k_true - 1, (
        "planted programs were not recovered from the corrected data")
    print(f"OK: batch effects removed, programs recovered. "
          f"Artifacts in {output_dir}/islets/")
    return sil_raw, sil_corr, best, dt


if __name__ == "__main__":
    run_cli(main, __doc__)
