"""The consensus-NMF pipeline class, TPM scaling, the preprocess sidecar
and the figures."""

__all__ = ["cNMF", "compute_tpm", "Preprocess"]


def __getattr__(name):
    if name in __all__:
        import importlib

        module = {"cNMF": "cnmf", "compute_tpm": "cnmf",
                  "Preprocess": "preprocess"}[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
