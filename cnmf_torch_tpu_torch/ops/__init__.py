"""Compute ops of the port: sparse ELL encoding and statistics, the MU
solvers, column statistics, HVG selection, consensus metrics, k-means and
OLS; the preprocess sidecar's seurat_v3 HVGs, PCA, Harmony with its MOE
ridge and the mutual-information estimator. ``kernels`` holds the CUDA
kernels and their dispatch."""

from .harmony import moe_correct_ridge, run_harmony
from .pca import pca
from .seurat_v3 import seurat_v3_hvg

__all__ = ["moe_correct_ridge", "run_harmony", "pca", "seurat_v3_hvg"]
