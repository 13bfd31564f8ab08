"""PyTorch/CUDA port of the consensus-NMF pipeline.

The same prepare -> factorize -> combine -> consensus -> k-selection
pipeline as ``cnmf_torch_tpu`` (the JAX package, which stays the
reference), rewritten on PyTorch for an NVIDIA H100. The sparse
Kullback-Leibler statistics run in hand-written CUDA kernels
(``csrc/kl_ell.cu``); everything else is plain torch on the device.

Every entry point takes ``device`` (default ``"cuda"``) and raises when no
card is present unless the caller asked for ``"cpu"``.
"""

from .utils.io import Frame, load_df_from_npz, save_df_to_npz
from .version import __version__

__all__ = ["cNMF", "Preprocess", "Frame", "main", "save_df_to_npz",
           "load_df_from_npz", "__version__"]


def __getattr__(name):
    _lazy = {
        "cNMF": ("cnmf_torch_tpu_torch.models.cnmf", "cNMF"),
        "Preprocess": ("cnmf_torch_tpu_torch.models.preprocess",
                       "Preprocess"),
        "main": ("cnmf_torch_tpu_torch.cli", "main"),
    }
    if name in _lazy:
        import importlib

        module_name, attr = _lazy[name]
        return getattr(importlib.import_module(module_name), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
