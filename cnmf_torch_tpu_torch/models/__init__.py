"""The consensus-NMF pipeline class."""
