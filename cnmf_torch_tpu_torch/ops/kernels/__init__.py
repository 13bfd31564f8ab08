"""Kernel dispatch for the ELL KL statistics.

A CUDA tensor launches the hand-written CUDA kernels
(:mod:`.kl_ell`); a CPU tensor takes their plain torch versions. There is
no knob and no degrade path: a CUDA launch that fails raises.

:func:`kernel_label` is the one spelling of the engaged inner-loop lane:
``ell-cuda`` (the kernels), ``ell-torch`` (the plain ELL versions: on
the CPU, and the Itakura-Saito hybrid on every device),
``dense-bf16`` / ``dense`` (the dense chains, plain torch matmuls).
:func:`cuda_stats_cost` prices one iteration of the kernels' lane for the
cost model (``obs/costmodel.py``).
"""

from __future__ import annotations

from . import kl_ell
from .kl_ell import KERNELS, launches, reset_launches

__all__ = ["KERNELS", "kernel_label", "cuda_stats_cost", "kl_ell",
           "launches", "reset_launches"]


def kernel_label(use_ell: bool, device, bf16_ratio: bool = False,
                 beta: float = 1.0) -> str:
    """The lane's label for ``factorize_info`` and the provenance. Only the
    KL (beta=1) ELL lane launches the kernels; the IS (beta=0) ELL hybrid
    is plain torch on every device (the JAX package's ``ell-jnp``)."""
    if use_ell:
        return ("ell-cuda" if float(beta) == 1.0
                and str(device).startswith("cuda") else "ell-torch")
    return "dense-bf16" if bf16_ratio else "dense"


def cuda_stats_cost(n: int, g: int, k: int, width: int, t_width=None,
                    beta: float = 1.0, device=None) -> dict:
    """Flops and bytes of one ELL KL iteration on the kernels' lane
    (``ell-cuda``), the JAX package's ``pallas_stats_cost``
    (``cnmf_torch_tpu/ops/pallas/__init__.py``) term for term. The kernels
    do the plain lane's useful arithmetic, so the flops are
    :func:`~..sparse.ell_stats_cost`'s; they fuse away its slab
    temporaries, so the bytes are the operand and output floor, once a
    side. ``perf_exempt`` is set when ``device`` is not a card (the plain
    versions ran, and no roofline compares them)."""
    from ..sparse import ell_stats_cost, ell_transpose_width

    c = ell_stats_cost(n, g, k, width, t_width=t_width, beta=beta)
    f = 4.0
    n, g, k, w = int(n), int(g), int(k), int(width)
    wt = ell_transpose_width(n, g, w, t_width)
    nw, gwt = n * w, g * wt
    # the fused floor: vals + cols + W + H in, the statistics out, a side
    c["bytes"] = float(
        (nw * f + nw * 4 + k * g * f + n * k * f + 2 * n * k * f)
        + (gwt * f + gwt * 4 + n * k * f + k * g * f + 2 * k * g * f))
    c["lane"] = "ell-cuda"
    c["perf_exempt"] = not str(device).startswith("cuda")
    return c
