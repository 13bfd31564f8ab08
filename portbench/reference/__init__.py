"""The plain reference: NumPy and plain PyTorch that import nothing of the
program (``cnmf_torch_tpu_torch``) or of the JAX package."""
