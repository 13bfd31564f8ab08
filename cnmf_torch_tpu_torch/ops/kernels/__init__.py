"""Kernel dispatch for the ELL KL statistics.

A CUDA tensor launches the hand-written CUDA kernels
(:mod:`.kl_ell`); a CPU tensor takes their plain torch versions. There is
no knob and no degrade path: a CUDA launch that fails raises.

:func:`kernel_label` is the one spelling of the engaged inner-loop lane:
``ell-cuda`` (the kernels), ``ell-torch`` (the plain ELL versions: on
the CPU, and the Itakura-Saito hybrid on every device),
``dense-bf16`` / ``dense`` (the dense chains, plain torch matmuls).
"""

from __future__ import annotations

from . import kl_ell
from .kl_ell import KERNELS, launches, reset_launches

__all__ = ["KERNELS", "kernel_label", "kl_ell", "launches",
           "reset_launches"]


def kernel_label(use_ell: bool, device, bf16_ratio: bool = False,
                 beta: float = 1.0) -> str:
    """The lane's label for ``factorize_info`` and the provenance. Only the
    KL (beta=1) ELL lane launches the kernels; the IS (beta=0) ELL hybrid
    is plain torch on every device (the JAX package's ``ell-jnp``)."""
    if use_ell:
        return ("ell-cuda" if float(beta) == 1.0
                and str(device).startswith("cuda") else "ell-torch")
    return "dense-bf16" if bf16_ratio else "dense"
