"""The consensus-NMF pipeline class, the preprocess sidecar and the
figures."""

__all__ = ["cNMF", "Preprocess"]


def __getattr__(name):
    if name in __all__:
        import importlib

        module = {"cNMF": "cnmf", "Preprocess": "preprocess"}[name]
        return getattr(importlib.import_module(f"{__name__}.{module}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
