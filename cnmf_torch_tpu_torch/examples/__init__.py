"""The four tutorials of the JAX package's ``examples/``, on the port.

Each is a module with the JAX tutorial's ``main()`` (its parameters and
defaults, plus ``device``, default ``"cuda"``: it raises without a card
unless ``"cpu"`` is asked for), the same numpy simulation with the same
seeds, the same workflow and the same ground-truth assertions:

* ``simulated_tutorial``: planted-program recovery on simulated mixtures;
* ``pbmc_tutorial``: a PBMC3k-shaped run from an ``.h5ad`` file, K chosen
  at the stability peak;
* ``batch_correction_tutorial``: the preprocess sidecar with Harmony, then
  cNMF on the corrected matrix;
* ``seurat_vignette``: a run exported for R/Seurat (10x trio, three TSVs,
  an import script).

Run one from the root of a checkout::

    python -m cnmf_torch_tpu_torch.examples.simulated_tutorial [DIR]
    python -m cnmf_torch_tpu_torch.examples.pbmc_tutorial DIR --device cpu

Without h5py an ``.h5ad`` input or hand-off is written in a format the port
reads natively, and a stderr line says so (``_common.py``); without
matplotlib the figures are skipped with a warning, as everywhere in the
port.
"""
