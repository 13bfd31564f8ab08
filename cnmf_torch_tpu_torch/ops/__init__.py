"""Compute ops of the port: sparse ELL encoding and statistics, the MU
solvers, column statistics, HVG selection, consensus metrics, k-means and
OLS. ``kernels`` holds the CUDA kernels and their dispatch."""
