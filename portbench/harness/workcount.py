"""The frozen work counts of the port's kernels on the KL main path.

Counted from the algorithm at the cell's shapes, never from an
implementation: the stored slots ``s`` of the row chunk (not a padded ELL
width), ``R`` replicates, ``k`` components, ``rows`` cells of the chunk and
``g`` genes. Each input byte is read once and each output byte written
once, in the narrowest type the stated arithmetic allows, so no
implementation can move fewer bytes: under the bf16 ratio chain the stored
values and the factors ``H`` and ``W`` enter as bfloat16 (2 bytes), a
column or row index as 2 bytes (``g`` and ``rows`` are below 65,536), the
statistics leave as float32. The least time is the larger of bytes at the
HBM rate and operations at the data sheet's dense rate for the operands'
precision (``peaks.py``).
"""

from __future__ import annotations

from . import peaks

IDX_BYTES = 2


def _factor_bytes(chain: str) -> int:
    return 2 if chain in ("bf16", "fp8") else 4


def h_stats(R: int, s: int, rows: int, k: int, g: int, chain: str = "bf16"):
    """``(operations, bytes)`` of the KL H statistics of one chunk: at each
    stored slot ``WH`` (k multiply-adds), the ratio (one division) and the
    k numerators (k multiply-adds), for every replicate; the denominator
    ``W`` summed over genes (``k g`` additions a replicate)."""
    fb = _factor_bytes(chain)
    ops = R * s * (4 * k + 1) + R * k * g
    nbytes = (s * (fb + IDX_BYTES) + R * rows * k * fb + R * k * g * fb
              + R * rows * k * 4 + R * k * 4)
    return ops, nbytes


def w_numer(R: int, s: int, rows: int, k: int, g: int, chain: str = "bf16"):
    """``(operations, bytes)`` of the KL W numerator of one chunk: at each
    stored slot ``WH`` (k multiply-adds), the ratio (one division) and the
    k products with the row's usages (k multiply-adds), for every
    replicate."""
    fb = _factor_bytes(chain)
    ops = R * s * (4 * k + 1)
    nbytes = (s * (fb + IDX_BYTES) + R * rows * k * fb + R * k * g * fb
              + R * k * g * 4)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, chain: str = "bf16"):
    """``(seconds, "ops" | "bytes")``: the least time and what bounds it."""
    rate = peaks.FLOPS["bf16" if chain in ("bf16", "fp8") else "f32"]
    t_ops, t_bytes = ops / rate, nbytes / peaks.HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


KERNELS = {"h_stats": h_stats, "w_numer": w_numer}
