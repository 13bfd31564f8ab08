"""Tutorial: exporting a cNMF run to R / Seurat — the port's counterpart of
the JAX package's ``examples/seurat_vignette.py`` (the reference's
``Tutorials/R_vignette.Rmd``).

The reference vignette runs cNMF on PBMC3k from R, then reads three
tab-delimited artifacts back into a Seurat object
(``R_vignette.Rmd:177-197``):

  * ``<name>.usages.k_<K>.dt_<dt>.consensus.txt``  (cells x K usages)
  * ``<name>.gene_spectra_score.k_<K>.dt_<dt>.txt`` (K x genes z-scores)
  * ``<name>.gene_spectra_tpm.k_<K>.dt_<dt>.txt``   (K x genes TPM units)

The port writes the same txt artifacts, so the vignette applies unchanged.
This script makes that concrete end-to-end WITHOUT requiring an R
installation at run time:

1. run a small cNMF pipeline;
2. export the raw counts as the 10x-style matrix.mtx / barcodes.tsv /
   features.tsv trio ``Seurat::ReadMtx`` consumes;
3. generate ``<name>.seurat_import.R`` — the vignette's import/AddMetaData/
   top-genes code with THIS run's real paths baked in (the same text as the
   JAX package's for the same run directory);
4. self-check: every path the generated R code reads exists, the txt
   tables parse, and their dimensions/indices are mutually consistent.

Run:  python -m cnmf_torch_tpu_torch.examples.seurat_vignette [DIR]
      [--device cpu]
"""

import os

import numpy as np

from ._common import ensure_dir, run_cli, write_10x_trio

R_TEMPLATE = """\
# Generated by examples/seurat_vignette.py — the reference R vignette's
# import flow (R_vignette.Rmd:177-197, 214-240) with this run's paths.
library(Seurat)

# 10x-style export of the raw counts this run factorized
counts <- ReadMtx(mtx = "{mtx}", cells = "{barcodes}", features = "{features}",
                  feature.column = 1)
seu <- CreateSeuratObject(counts = counts, project = "{name}")

usage         <- read.table("{usages_txt}", sep = "\\t",
                            row.names = 1, header = TRUE)
spectra_score <- read.table("{score_txt}", sep = "\\t",
                            row.names = 1, header = TRUE)
spectra_tpm   <- read.table("{tpm_txt}", sep = "\\t",
                            row.names = 1, header = TRUE)

# normalize each cell's usages to sum to 1, as the vignette does
usage_norm <- as.data.frame(t(apply(usage, 1, function(x) x / sum(x))))
colnames(usage_norm) <- paste0("GEP", colnames(usage))
seu <- AddMetaData(seu, usage_norm)

# top genes per program from the z-score spectra
get_top_genes <- function(row, n = 20) {{
  colnames(spectra_score)[order(row, decreasing = TRUE)[1:n]]
}}
top_genes <- apply(spectra_score, 1, get_top_genes)
print(top_genes[, 1])

# standard Seurat UMAP over the same cells, usages as FeaturePlot layers
seu <- NormalizeData(seu)
seu <- FindVariableFeatures(seu)
seu <- ScaleData(seu)
seu <- RunPCA(seu, verbose = FALSE)
seu <- RunUMAP(seu, dims = 1:10)
FeaturePlot(seu, features = colnames(usage_norm))
"""


def export_counts_10x(counts_df, out_dir):
    """matrix.mtx / barcodes.tsv / features.tsv, as Seurat::ReadMtx reads
    them (genes x cells orientation, 1-column feature file);
    ``counts_df`` is a :class:`~..utils.io.Frame` of cells x genes."""
    return write_10x_trio(out_dir, counts_df.values, counts_df.index,
                          counts_df.columns)


def export_for_seurat(obj, counts_df, k, density_threshold):
    """Write the 10x trio + the baked-paths R script for an existing
    consensus run; returns the generated .R path after self-checking every
    file it references."""
    from ..utils.io import atomic_artifact, load_df_from_text

    dt_repl = str(density_threshold).replace(".", "_")
    paths = {
        "usages_txt": obj.paths["consensus_usages__txt"] % (k, dt_repl),
        "score_txt": obj.paths["gene_spectra_score__txt"] % (k, dt_repl),
        "tpm_txt": obj.paths["gene_spectra_tpm__txt"] % (k, dt_repl),
    }
    tenx_dir = os.path.join(os.path.dirname(paths["usages_txt"]),
                            "for_seurat_10x")
    mtx, barcodes, features = export_counts_10x(counts_df, tenx_dir)
    r_path = os.path.join(os.path.dirname(paths["usages_txt"]),
                          f"{obj.name}.seurat_import.R")
    with atomic_artifact(r_path) as tmp:
        with open(tmp, "w") as f:
            f.write(R_TEMPLATE.format(name=obj.name, mtx=mtx,
                                      barcodes=barcodes, features=features,
                                      **paths))

    # --- self-check: everything the R code reads exists and is coherent --
    for p in [mtx, barcodes, features, *paths.values()]:
        assert os.path.exists(p), f"missing Seurat input: {p}"
    usage = load_df_from_text(paths["usages_txt"])
    score = load_df_from_text(paths["score_txt"])
    tpm = load_df_from_text(paths["tpm_txt"])
    assert usage.shape == (counts_df.shape[0], k)
    assert score.shape[0] == k and tpm.shape[0] == k
    assert list(score.columns) == list(tpm.columns)
    assert list(usage.index) == list(map(str, counts_df.index))
    with open(barcodes) as f:
        assert sum(1 for _ in f) == counts_df.shape[0]
    return r_path


def main(output_dir=None, n_cells=500, n_genes=800, n_iter=8, k=5,
         device="cuda"):
    from ..device import resolve_device
    from ..models.cnmf import cNMF
    from ..utils.io import Frame, save_df_to_npz

    resolve_device(device)
    output_dir = ensure_dir(output_dir, "seurat_vignette_")
    rng = np.random.default_rng(11)
    usage_true = rng.dirichlet(np.full(k, 0.1), size=n_cells)
    programs = rng.gamma(0.3, 1.0, size=(k, n_genes)) * 40.0 / n_genes
    counts = rng.poisson(usage_true @ programs * 400.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    counts_df = Frame(counts,
                      np.asarray([f"cell{i}" for i in range(n_cells)]),
                      np.asarray([f"gene{j}" for j in range(n_genes)]))
    counts_fn = os.path.join(output_dir, "counts.df.npz")
    save_df_to_npz(counts_df, counts_fn)

    obj = cNMF(output_dir=output_dir, name="vignette", device=device)
    obj.prepare(counts_fn, components=[k], n_iter=n_iter, seed=14,
                num_highvar_genes=min(400, n_genes))
    obj.factorize()
    obj.combine()
    obj.consensus(k=k, density_threshold=2.0, show_clustering=False)

    r_path = export_for_seurat(obj, counts_df, k, 2.0)
    print(f"Seurat import script: {r_path}")
    print("Run it with:  Rscript", r_path)
    return r_path


if __name__ == "__main__":
    run_cli(main, __doc__)
