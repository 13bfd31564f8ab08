"""The roofline cost model: analytic flops and bytes of each kernel lane,
read against the card's peaks.

Own copy of ``cnmf_torch_tpu/obs/costmodel.py`` for the port's lanes. Each
lane's formula lives beside its kernels (``ops/nmf.py:dense_update_cost``,
``ops/sparse.py:ell_stats_cost``, ``ops/kernels:cuda_stats_cost``) and is
the JAX package's term for term, whatever implements the lane:

==============  ==========================  ============================
port label      JAX label                   formula
==============  ==========================  ============================
``ell-cuda``    ``ell-pallas``              fused operand/output floor
``ell-torch``   ``ell-jnp``                 the plain ELL statistics
``dense``       ``vmapped`` / ``dense-jnp``  dense MU chains
``dense-bf16``  ``vmapped-bf16``            bf16 ratio traffic
``bundled``     ``bundled``                 useful per-replicate work
==============  ==========================  ============================

:func:`roofline` joins predicted work with a measured wall: the achieved
fraction of the peak operation rate (``mfu``) and of the peak memory rate
(``bw_frac``), the arithmetic intensity against the machine balance and
the bound verdict. Peaks come from :data:`CHIP_PEAKS`, keyed by
``torch.cuda.get_device_name()``; any other device gets a nominal CPU
envelope and ``perf_exempt``, so its verdict renders but never gates.

Not here yet: the 2-D grid lane (``lane_cost("grid2d")``) comes with the
multi-device slice, ``plan_cost`` with the planner and
``serve_project_cost`` with serving; the JAX package's ``xla_cost`` has
no counterpart (torch has no compiled cost analysis that reports bytes).

Host arithmetic only: with ``CNMF_TPU_PERF_MODEL`` unset nothing here
runs, and with it set no launch or artifact changes.
"""

from __future__ import annotations

import math

__all__ = ["CHIP_PEAKS", "PERF_MODEL_ENV", "chip_peaks", "lane_cost",
           "roofline", "perf_model_enabled", "device_peaks"]

PERF_MODEL_ENV = "CNMF_TPU_PERF_MODEL"

# (peak operations/s, peak HBM bytes/s) by torch.cuda.get_device_name().
# The H100 SXM's f32 rate outside the tensor cores (no lane of the port
# uses TF32) and its HBM3 rate, from NVIDIA's data sheet
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}

# the nominal single-core CPU envelope of a device with no data-sheet
# entry (the JAX package's): rows on it are perf_exempt and never gated
_NOMINAL_CPU = (50e9, 20e9)


def perf_model_enabled() -> bool:
    """Whether factorize emits ``perf_model`` events (they land only when
    the telemetry is on too)."""
    from ..utils.envknobs import env_flag

    return env_flag(PERF_MODEL_ENV, False)


def chip_peaks(device_name: str | None) -> dict:
    """``{flops, bw, source}`` for a device name: ``datasheet`` for a card
    of :data:`CHIP_PEAKS` (the name or a prefix of it), else the nominal
    CPU envelope with source ``nominal-cpu``."""
    if device_name:
        for name, (pf, pb) in CHIP_PEAKS.items():
            if device_name == name or device_name.startswith(name):
                return {"flops": pf, "bw": pb, "source": "datasheet"}
    return {"flops": _NOMINAL_CPU[0], "bw": _NOMINAL_CPU[1],
            "source": "nominal-cpu"}


def device_peaks(device) -> dict:
    """:func:`chip_peaks` of the card a tensor lives on; a CPU device gets
    the nominal envelope (never a guess at a card)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return chip_peaks(None)
    return chip_peaks(torch.cuda.get_device_name(device))


def lane_cost(lane: str, n: int, g: int, k: int, *, beta: float = 1.0,
              ell_width: int | None = None, t_width: int | None = None,
              bf16_ratio: bool = False, device=None, grid_shape=None,
              grid_blocks: int | None = None) -> dict:
    """Flops and bytes of ONE update iteration (H and W) on a kernel lane
    (a label of ``ops/kernels:kernel_label``, ``bundled``, or ``grid2d``).
    Returns ``{flops, bytes, lane, ...}``; the ``ell-cuda`` lane adds
    ``perf_exempt`` (``device`` not a card), the ``grid2d`` lane the
    per-device cost of one grid pass on a ``grid_shape`` grid with
    ``grid_blocks`` statistics blocks and its ``collective_bytes``
    (``parallel/grid2d.py:grid_pass_cost``, as the JAX package prices it).
    A degenerate window (n, g or k zero, or an ELL lane without a width)
    costs exactly zero."""
    n, g, k = int(n), int(g), int(k)
    if n <= 0 or g <= 0 or k <= 0 or (
            lane in ("ell-torch", "ell-cuda") and not ell_width):
        return {"flops": 0.0, "bytes": 0.0, "lane": lane,
                "degenerate": True}
    if lane == "grid2d":
        from ..parallel.grid2d import grid_pass_cost

        gs = grid_shape or [1, 1]
        n_dev = max(1, int(gs[0]) * int(gs[1]))
        rows_loc = -(-n // max(int(gs[0]), 1))
        g_loc = -(-g // max(int(gs[1]), 1))
        nblk = max(1, int(grid_blocks or 1))
        return grid_pass_cost(rows_loc, g_loc, k, beta,
                              nblk_h=nblk, nblk_w=nblk, n_dev=n_dev)
    if lane == "ell-cuda":
        from ..ops.kernels import cuda_stats_cost

        return cuda_stats_cost(n, g, k, int(ell_width), t_width=t_width,
                               beta=beta, device=device)
    if lane == "ell-torch":
        from ..ops.sparse import ell_stats_cost

        return ell_stats_cost(n, g, k, int(ell_width), t_width=t_width,
                              beta=beta)
    if lane not in ("dense", "dense-bf16", "bundled"):
        raise ValueError(f"lane_cost: unknown lane {lane!r}")
    from ..ops.nmf import dense_update_cost

    c = dense_update_cost(n, g, k, beta, bf16_ratio=bf16_ratio,
                          bundled=(lane == "bundled"))
    c["lane"] = lane
    return c


def roofline(flops: float, nbytes: float, wall_s: float,
             peaks: dict | None = None, *,
             perf_exempt: bool = False) -> dict:
    """Predicted work against a measured wall: ``mfu`` (achieved over peak
    operations/s), ``bw_frac`` (achieved over peak bytes/s), the
    arithmetic intensity against the balance point and the bound verdict.
    ``peaks`` is :func:`chip_peaks` output (the nominal CPU envelope when
    absent). No work or a non-positive wall gives the ``idle`` verdict."""
    peaks = peaks or chip_peaks(None)
    pf, pb = float(peaks["flops"]), float(peaks["bw"])
    src = str(peaks.get("source", "nominal-cpu"))
    exempt = bool(perf_exempt or src != "datasheet")
    flops, nbytes = float(flops), float(nbytes)
    out = {"peak_source": src, "perf_exempt": exempt}
    if wall_s is None or wall_s <= 0 or (flops <= 0 and nbytes <= 0):
        out.update(mfu=None, bw_frac=None, intensity=None, bound="idle")
        return out
    mfu = flops / wall_s / pf
    bw = nbytes / wall_s / pb
    balance = pf / pb                       # flops a byte at the ridge
    intensity = flops / nbytes if nbytes > 0 else math.inf
    bound = "compute-bound" if intensity >= balance else "memory-bound"
    out.update(mfu=round(mfu, 6), bw_frac=round(bw, 6),
               intensity=round(intensity, 4) if math.isfinite(intensity)
               else None,
               balance=round(balance, 4), bound=bound)
    return out
