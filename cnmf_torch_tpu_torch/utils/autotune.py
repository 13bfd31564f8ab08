"""The autotuner behind the execution planner: microbenches on the live
device, cached per device fingerprint.

Own copy of the JAX package's ``cnmf_torch_tpu/utils/autotune.py`` for the
port. Two measurements share one JSON cache file a device:

* the amu cost-ratio scales (:func:`measure_rho_scales`): per lane (``b2``
  dense beta=2, ``dense`` beta=1, ``ell`` beta=1 on the ELL encoding) the
  measured W-update / H-repeat wall ratio over the static flop ratio that
  ``ops/recipe.py:auto_inner_repeats`` would use, which it then multiplies
  by (:func:`cached_rho_scale`);
* the plan points (:func:`measure_plan_points`): the ELL density
  crossover, the grid's statistics block count, the staging thread count
  and the sketch row count, which their resolvers read with the planner's
  precedence, pin > autotuned > heuristic (:func:`cached_plan_point`).

On a card the ``ell`` lane and the crossover run the port's ELL updates,
which launch the ``h_stats`` and ``w_numer`` kernels. Every timed call is
bracketed by ``torch.cuda.synchronize``, so a wall is the card's work and
not the launch. There is no ``pallas_wins`` point: the port has no degrade
path from a kernel to its plain version, and nothing chooses one.

``CNMF_TPU_AUTOTUNE``: ``off`` (``0``) neither measures nor consumes;
``auto`` (the default) consumes an existing cache and measures the scales
only when the accel knobs explicitly engage an amu schedule (a stock run
never measures); ``force`` (``1``) measures every point. The fingerprint
holds the package version and the device's name and count, so a cache
from another card or another version is never read. A failure inside a
microbench (a CUDA error, a failed kernel launch) raises: it is not turned
into the static schedule. Across several processes nothing is measured or
consumed, since each process's timings could resolve a different dispatch.

The probe is the JAX package's (2,048 cells x 512 genes, k=10, one
replicate) on the CPU. On a card it is the main path's scale (8,192 cells
x 2,048 genes, k=10, 20 replicates): at the JAX size every step on an H100
is a few launches long, and the ratios would time launch overhead (the
crossover would read about the probe density itself and send the main
path's 6.5%-dense matrix to the dense lane).

The cache lives under the system temp dir unless :func:`set_cache_dir`
points this process elsewhere (the tests and ``chip_smoke.py`` use a
private directory); the readers of the process then read that directory.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

__all__ = ["AUTOTUNE_ENV", "autotune_mode", "device_fingerprint",
           "set_cache_dir", "cache_path", "measure_rho_scales",
           "maybe_autotune_rho", "cached_rho_scale", "measure_plan_points",
           "maybe_autotune_plan", "cached_plan_points", "cached_plan_point"]

AUTOTUNE_ENV = "CNMF_TPU_AUTOTUNE"

_OFF_WORDS = ("", "0", "off", "false", "no")
_ON_WORDS = ("1", "on", "true", "yes", "force")

# (cells, genes, k, replicates) of the probe problem, by device type
_PROBES = {"cpu": (2048, 512, 10, 1), "cuda": (8192, 2048, 10, 20)}
_PROBE_DENSITY = 0.05

_memo: dict = {}
_memo_lock = threading.Lock()
_cache_dir: str | None = None
# the device the last maybe_autotune_* call tuned for: the readers that
# know no device (the resolvers) read its cache
_active_device = None


def _device(device=None):
    import torch

    if device is not None:
        return torch.device(device)
    if _active_device is not None:
        return _active_device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _measure_device(device=None):
    """The device a measurement runs on: the one named, else the one the
    last ``maybe_autotune_*`` call named, else the port's default device
    through ``resolve_device``, which raises without a card: a measurement
    never quietly times the CPU."""
    from ..device import resolve_device

    return resolve_device(device if device is not None else _active_device)


def device_fingerprint(device=None) -> str:
    """``v<package version>-<cuda|cpu>-<device name>-x<device count>``, the
    identity a measured point is valid for (spaces in the name become
    ``_``). A version bump or another card changes the cache's file name,
    so stale points are never read."""
    import torch

    from ..version import __version__

    dev = _device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        backend, count = "cuda", torch.cuda.device_count()
    else:
        name, backend, count = "cpu", "cpu", 1
    return f"v{__version__}-{backend}-{name.replace(' ', '_')}-x{count}"


def autotune_mode() -> str:
    """``CNMF_TPU_AUTOTUNE`` normalized to ``off`` | ``auto`` | ``force``;
    any other word raises."""
    from .envknobs import env_str

    raw = env_str(AUTOTUNE_ENV, "auto").strip().lower()
    if raw in _OFF_WORDS:
        return "off"
    if raw in _ON_WORDS:
        return "force"
    if raw == "auto":
        return "auto"
    raise ValueError(f"{AUTOTUNE_ENV}={raw!r}: expected 0, 1, or auto")


def set_cache_dir(path: str | None) -> str | None:
    """Point this process's cache readers and writers at ``path`` (None:
    back to the system temp dir); returns the previous setting."""
    global _cache_dir
    prev, _cache_dir = _cache_dir, (None if path is None else str(path))
    return prev


def cache_path(cache_dir: str | None = None, device=None) -> str:
    base = (cache_dir or _cache_dir
            or os.path.join(tempfile.gettempdir(), "cnmf_tpu_torch_autotune"))
    return os.path.join(base, f"rho_{device_fingerprint(device)}.json")


def _multi_process() -> bool:
    from ..parallel.mesh import process_count

    return process_count() > 1


def _time_call(fn, device, repeats: int = 5) -> float:
    """Median wall of ``fn()`` in seconds after one warm-up call, each call
    bracketed by ``torch.cuda.synchronize`` on a card so the wall is the
    device's work, not the launch."""
    import torch

    dev = _device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    walls = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2]


def _probe_shape(dev) -> tuple:
    return _PROBES["cuda" if dev.type == "cuda" else "cpu"]


def _probe(dev):
    """The probe problem on ``dev``: ``H (R, n, k)``, ``W (R, k, g)``, a
    dense gamma matrix and its 5%-dense ELL encoding (with the transpose
    index set the W update walks)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from ..ops.sparse import csr_to_ell

    n, g, k, R = _probe_shape(dev)
    rng = np.random.default_rng(0)
    H = torch.as_tensor(rng.uniform(0.1, 1.0, (R, n, k)),
                        dtype=torch.float32, device=dev)
    W = torch.as_tensor(rng.uniform(0.1, 1.0, (R, k, g)),
                        dtype=torch.float32, device=dev)
    Xh = rng.gamma(1.0, 1.0, (n, g)).astype(np.float32)
    Xd = torch.as_tensor(Xh, device=dev)
    mask = rng.uniform(size=(n, g)) < _PROBE_DENSITY
    E = csr_to_ell(sp.csr_matrix(np.where(mask, Xh, 0.0))).to(dev)
    return rng, H, W, Xd, E


def measure_rho_scales(device=None) -> dict:
    """Per lane, the measured W-update / H-repeat wall ratio over the
    static flop ratio at the probe shape; returns the cache payload."""
    from ..ops.nmf import _apply_rate, _update_H, _update_W

    dev = _measure_device(device)
    n, g, k, R = _probe_shape(dev)
    _, H, W, Xd, E = _probe(dev)
    scales: dict = {}

    # beta=2: an H repeat is the rate against the hoisted X W^T and W W^T
    # (k-sized); a W update the whole statistics step
    numer0 = Xd @ W.mT
    WWT = W @ W.mT
    static_b2 = (2.0 * n * g * k) / max(n * k * k, 1)
    meas_b2 = (_time_call(lambda: _update_W(Xd, H, W, 2.0, 0.0, 0.0), dev)
               / max(_time_call(lambda: _apply_rate(H, numer0, H @ WWT,
                                                    0.0, 0.0), dev), 1e-9))
    scales["b2"] = meas_b2 / static_b2

    # dense beta=1: a repeat and a W update are the same full-pass class
    scales["dense"] = (
        _time_call(lambda: _update_W(Xd, H, W, 1.0, 0.0, 0.0), dev)
        / max(_time_call(lambda: _update_H(Xd, H, W, 1.0, 0.0, 0.0), dev),
              1e-9))

    # ELL beta=1 (the h_stats and w_numer kernels on a card)
    w_ell = E.width
    static_ell = (n * w_ell * (4 * k + 2)) / max(n * w_ell * (2 * k + 2), 1)
    scales["ell"] = (
        _time_call(lambda: _update_W(E, H, W, 1.0, 0.0, 0.0), dev)
        / max(_time_call(lambda: _update_H(E, H, W, 1.0, 0.0, 0.0), dev),
              1e-9)) / static_ell

    return {"fingerprint": device_fingerprint(dev),
            "probe": {"n": n, "g": g, "k": k, "replicates": R,
                      "density": _PROBE_DENSITY, "ell_width": int(w_ell)},
            "scales": {lane: round(float(v), 4)
                       for lane, v in scales.items()},
            "measured_at": time.time()}


def measure_plan_points(device=None) -> dict:
    """One measured value per dispatch decision the static heuristics
    would otherwise guess:

    * ``ell_density_crossover``: the density below which the ELL H step
      beats the dense one, extrapolated from the probe density's wall
      ratio (the ELL step scales with the width, the dense one not),
      clamped to [0.01, 0.5];
    * ``grid_blocks``: the fastest row-chunk count of the dense statistics
      pass among {1, 2, 4, 8};
    * ``stream_threads``: the fastest thread count among {1, 2, 4} for
      staging 16 host slabs to the device;
    * ``sketch_dim``: the largest probe row subsample (n/16, n/8 or n/4)
      whose W update costs at most half the exact one; absent when none
      does.
    """
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from ..ops.nmf import _update_H, _update_W

    dev = _measure_device(device)
    n, g, _, _ = _probe_shape(dev)
    rng, H, W, Xd, E = _probe(dev)
    points: dict = {}

    dense_w = _time_call(lambda: _update_H(Xd, H, W, 1.0, 0.0, 0.0), dev)
    ell_w = max(_time_call(lambda: _update_H(E, H, W, 1.0, 0.0, 0.0), dev),
                1e-9)
    points["ell_density_crossover"] = round(
        min(0.5, max(0.01, _PROBE_DENSITY * dense_w / ell_w)), 4)

    walls = {}
    for nb in (1, 2, 4, 8):
        rows = n // nb

        def run_blocks(nb=nb, rows=rows):
            return [_update_H(Xd[i * rows:(i + 1) * rows],
                              H[:, i * rows:(i + 1) * rows], W, 1.0, 0.0,
                              0.0) for i in range(nb)]

        walls[nb] = _time_call(run_blocks, dev)
    points["grid_blocks"] = int(min(walls, key=walls.get))

    slabs = [rng.gamma(1.0, 1.0, (128, g)).astype(np.float32)
             for _ in range(16)]

    def stage_all(n_threads):
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            list(pool.map(lambda s: torch.tensor(s, device=dev), slabs))

    t_walls = {nt: _time_call(lambda nt=nt: stage_all(nt), dev, repeats=3)
               for nt in (1, 2, 4)}
    points["stream_threads"] = int(min(t_walls, key=t_walls.get))

    exact_wall = _time_call(lambda: _update_W(Xd, H, W, 1.0, 0.0, 0.0), dev)
    best = None
    for m in (n // 16, n // 8, n // 4):
        if _time_call(lambda m=m: _update_W(Xd[:m], H[:, :m], W, 1.0, 0.0,
                                            0.0), dev) <= 0.5 * exact_wall:
            best = int(m)
    if best is not None:
        points["sketch_dim"] = best
    return points


def _load(path: str, device=None) -> dict | None:
    """The cache payload at ``path`` when it exists, parses and carries
    this device's fingerprint; else None."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if (not isinstance(payload, dict)
            or payload.get("fingerprint") != device_fingerprint(device)):
        return None
    return payload


def _merge_write(path: str, updates: dict, device=None) -> dict:
    """Merge ``updates`` into the device's cache and rewrite it atomically
    (the scales and the plan points share the file)."""
    from .io import atomic_artifact

    payload = _load(path, device) or {}
    payload.update(updates)
    payload["fingerprint"] = device_fingerprint(device)
    payload["measured_at"] = time.time()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with atomic_artifact(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(payload, f)
    with _memo_lock:
        _memo[path] = payload
    return payload


def _activate(device):
    global _active_device
    if device is not None:
        dev = _device(device)
        with _memo_lock:
            _active_device = dev


def maybe_autotune_rho(cache_dir: str | None = None, force: bool = False,
                       beta: float | None = None, device=None) -> dict | None:
    """Make sure the measured ρ scales of ``device`` are cached and
    loaded. Measures only when no valid cache exists and either ``force``,
    ``CNMF_TPU_AUTOTUNE=1``, or (under ``auto``) the accel knobs
    explicitly engage an amu schedule that can be reached at ``beta``
    (``CNMF_TPU_ACCEL`` on, no ``CNMF_TPU_INNER_REPEATS`` pin, and for KL
    neither the sketch nor Newton). Returns the payload, or None when
    nothing is measured or consumed. ``device`` becomes the device the
    process's resolvers read the cache of."""
    from .envknobs import env_flag, env_str

    _activate(device)
    mode = autotune_mode()
    if mode == "off" and not force:
        return None
    if not force and mode != "force":
        accel = env_str("CNMF_TPU_ACCEL", "auto").strip().lower()
        rho_pin = env_str("CNMF_TPU_INNER_REPEATS", "").strip().lower()
        if accel not in _ON_WORDS or rho_pin not in ("", "auto"):
            return None
        if beta is not None and float(beta) == 1.0:
            sk = env_str("CNMF_TPU_SKETCH", "0").strip().lower()
            if sk in _ON_WORDS or env_flag("CNMF_TPU_KL_NEWTON", True):
                return None
    if _multi_process():
        return None
    path = cache_path(cache_dir, device)
    payload = None if force else _load(path, device)
    if payload is None or "scales" not in payload:
        payload = _merge_write(path, measure_rho_scales(device), device)
    with _memo_lock:
        _memo[path] = payload
    return payload


def maybe_autotune_plan(cache_dir: str | None = None, force: bool = False,
                        device=None) -> dict | None:
    """Make sure the plan points of ``device`` are cached: measured under
    ``CNMF_TPU_AUTOTUNE=1`` or ``force`` only (``auto`` consumes an
    existing cache and never measures). Returns the whole payload or
    None. ``device`` becomes the device the process's resolvers read the
    cache of."""
    _activate(device)
    mode = autotune_mode()
    if mode == "off" and not force:
        return None
    if _multi_process():
        return None
    path = cache_path(cache_dir, device)
    payload = _load(path, device)
    if force or mode == "force":
        if force or payload is None or "plan_points" not in payload:
            payload = _merge_write(
                path, {"plan_points": measure_plan_points(device)}, device)
    if payload is not None:
        with _memo_lock:
            _memo[path] = payload
    return payload


def _cached(cache_dir, device) -> dict | None:
    if autotune_mode() == "off" or _multi_process():
        return None
    path = cache_path(cache_dir, device)
    with _memo_lock:
        payload = _memo.get(path)
    if payload is None:
        payload = _load(path, device)
        if payload is not None:
            with _memo_lock:
                _memo[path] = payload
    return payload


def cached_plan_points(cache_dir: str | None = None, device=None) -> dict:
    """The measured plan points of the device, or ``{}`` (no cache,
    ``CNMF_TPU_AUTOTUNE=0``, or several processes). Never measures."""
    payload = _cached(cache_dir, device) or {}
    pts = payload.get("plan_points")
    return dict(pts) if isinstance(pts, dict) else {}


def cached_plan_point(name: str, cache_dir: str | None = None, device=None):
    """One measured plan point, or None (the caller keeps its static
    heuristic). Read by ``runtime/planner.py`` (the crossover),
    ``parallel/grid2d.py:grid_blocks``, ``parallel/streaming.py:
    stream_threads`` and ``ops/recipe.py`` (the sketch rows)."""
    return cached_plan_points(cache_dir, device).get(name)


def cached_rho_scale(beta: float, ell: bool = False,
                     cache_dir: str | None = None,
                     device=None) -> float | None:
    """The measured scale of the (beta, encoding) lane for
    ``auto_inner_repeats``, or None (the static ratio stands). Never
    measures; same gates as :func:`cached_plan_points`."""
    payload = _cached(cache_dir, device) or {}
    lane = "b2" if float(beta) == 2.0 else ("ell" if ell else "dense")
    val = payload.get("scales", {}).get(lane)
    return float(val) if val is not None else None
