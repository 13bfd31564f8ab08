"""The continuous perf gate: the regression machinery's self-test on a
pinned lane, then a baseline keyed by the device's fingerprint.

    python -m cnmf_torch_tpu_torch.obs.perf_gate [--device DEV]
        [--write-baseline]

Port of the JAX package's ``scripts/perf_gate.py``, with its structure and
names.

* The self-test measures one pinned dense beta=2 MU lane twice
  (``GATE_ITERS`` iterations at ``GATE_SHAPE`` through
  :func:`~..ops.nmf.nmf_fit_batch` in the JAX package's one-replicate call
  form; the min-of-N wall, N = ``CNMF_TPU_PERF_GATE_N``), the two
  measurements' samples taken in turns, builds two
  ``cnmf-bench`` snapshots (``obs/regress.py``), and holds the
  noise-aware diff GREEN on the honest re-measurement and RED once the
  candidate's wall samples are doubled, both through the port's own
  ``benchdiff`` command run as a child (exit 0 and 1).
* The baseline gate: where ``<BASELINE_DIR>/<fingerprint>.json`` exists for
  this device's fingerprint (``utils/autotune.py:device_fingerprint``),
  today's measurement must stay within the relative band of it
  (``CNMF_TPU_PERF_GATE_BAND``, default 0.6). A baseline recorded on other
  hardware has another file name, so it never gates this run.
  ``--write-baseline`` records today's measurement as this fingerprint's
  baseline. No baseline is shipped.

``--device`` defaults to ``cuda`` and raises without a card; the CPU runs
only when asked (``--device cpu``). Exit 0: green; 1: a leg failed (the
reason on standard error). The last line is the summary.
"""

from __future__ import annotations

import argparse
import copy
import os
import shutil
import subprocess
import sys
import tempfile
import time

# the pinned lane (the JAX gate's): small enough that min-of-N stays
# honest on a loaded host, large enough that a wall is milliseconds
GATE_SHAPE = (96, 64, 7)  # (n, g, k)
GATE_ITERS = 150
# warm calls run outside the clock for at least this long (one at least):
# the first calls of a process set up the card's libraries
GATE_WARM_S = 1.0

# <BASELINE_DIR>/<safe fingerprint>.json, beside this module as JAX's sits
# beside its script; read at each call, so a caller may point it elsewhere
BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "perf_baselines")


def _fail(msg: str) -> int:
    print("perf gate: " + msg, file=sys.stderr)
    return 1


def _gate_inputs(device):
    """The pinned lane's ``X (n, g)``, ``H0 (n, k)`` and ``W0 (k, g)``, f32
    draws of ``numpy.random.default_rng(0)`` in the JAX gate's order."""
    import numpy as np
    import torch

    n, g, k = GATE_SHAPE
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.random(shape).astype(np.float32))
                 .to(device) for shape in ((n, g), (n, k), (k, g)))


def _fit(X, H0, W0):
    """``GATE_ITERS`` dense beta=2 MU iterations (``tol=0`` pins the trip
    count), one replicate: ``(H (n, k), W (k, g), err ())``."""
    from ..ops.nmf import nmf_fit_batch

    return nmf_fit_batch(X, H0, W0, beta=2.0, tol=0.0, max_iter=GATE_ITERS)


def _measure_turns(n_samples: int, device, ways: int) -> list:
    """``ways`` measurements of the pinned lane on ``device``, their
    samples taken in turns (``n_samples`` each; warm calls outside the
    clock for ``GATE_WARM_S``, the counterpart of JAX's compile; each
    sample between two synchronizes of the card). Each is a min-of-N wall
    with its ``gflops`` from :func:`~..ops.nmf.dense_update_cost`.

    The lane is host-bound on a card (its wall is the host's dispatch),
    and a shared host slows it for seconds at a time: two measurements
    taken one after the other can then differ by more than the 20% that
    the self-test's red leg leaves (its doubled candidate must clear the
    60% band). In turns, both see the same host."""
    import torch

    from ..ops.nmf import dense_update_cost

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    X, H0, W0 = _gate_inputs(dev)
    warm_until = time.perf_counter() + GATE_WARM_S
    while True:
        _fit(X, H0, W0)
        sync()
        if time.perf_counter() >= warm_until:
            break
    samples = [[] for _ in range(ways)]
    for _ in range(max(1, n_samples)):
        for way in samples:
            sync()
            t0 = time.perf_counter()
            _fit(X, H0, W0)
            sync()
            way.append(time.perf_counter() - t0)
    n, g, k = GATE_SHAPE
    flops = dense_update_cost(n, g, k, 2.0)["flops"] * GATE_ITERS
    return [{"samples": way, "wall_s": min(way),
             "gflops": flops / min(way) / 1e9} for way in samples]


def _measure(n_samples: int, device) -> dict:
    """Min-of-N wall of the pinned lane on ``device`` and its ``gflops``
    (one measurement of :func:`_measure_turns`)."""
    return _measure_turns(n_samples, device, 1)[0]


def _snapshot(meas: dict, fingerprint: str, created: float,
              label: str) -> dict:
    """The ``gate`` tier's snapshot of one measurement, validated."""
    from .regress import build_snapshot, validate_bench

    raw = {"update_wall_s": meas["wall_s"],
           "achieved_gflops": meas["gflops"],
           "n": GATE_SHAPE[0], "g": GATE_SHAPE[1], "k": GATE_SHAPE[2],
           "iters": GATE_ITERS}
    snap = build_snapshot({"gate": raw}, fingerprint=fingerprint,
                          created=created, label=label)
    # the whole sample list rides along, so the diff's min-of-N estimator
    # has the noise floor, not one draw
    snap["tiers"]["gate"]["metrics"]["update_wall_s"]["samples"] = \
        [float(s) for s in meas["samples"]]
    validate_bench(snap)
    return snap


def _scaled_walls(snap: dict, factor: float) -> dict:
    """A copy of ``snap`` whose gate wall and its samples are ``factor``
    times the measured ones (the self-test's injected slowdown)."""
    snap = copy.deepcopy(snap)
    m = snap["tiers"]["gate"]["metrics"]["update_wall_s"]
    m["value"] = factor * float(m["value"])
    m["samples"] = [factor * float(s) for s in m["samples"]]
    return snap


def _benchdiff_cli(a: str, b: str) -> tuple[int, str]:
    """``benchdiff a b`` through the port's CLI in a child that imports
    this copy of the port."""
    from ..launcher import port_command, port_env

    p = subprocess.run(port_command("benchdiff", a, b),
                       env=port_env(dict(os.environ)), capture_output=True,
                       text=True, timeout=120)
    return p.returncode, (p.stdout or "") + (p.stderr or "")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cnmf_torch_tpu_torch.obs.perf_gate",
        description="the perf gate: the benchdiff self-test on a pinned "
                    "lane, then this device's recorded baseline")
    parser.add_argument("--device", default="cuda",
                        help="the device the lane runs on (default cuda; "
                             "raises without a card)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record the current measurement as the "
                             "baseline for this device fingerprint")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..utils.autotune import device_fingerprint
    from .regress import (diff_snapshots, gate_n, load_snapshot,
                          render_diff, save_snapshot)

    dev = resolve_device(args.device)
    fp = device_fingerprint(dev)
    n = gate_n()
    workdir = tempfile.mkdtemp(prefix="perf_gate_")
    try:
        # -- self-test: green on an honest re-measurement ------------------
        meas_a, meas_b = _measure_turns(n, dev, 2)
        snap_a = _snapshot(meas_a, fp, time.time(), "gate-base")
        snap_b = _snapshot(meas_b, fp, time.time(), "gate-new")
        path_a = save_snapshot(snap_a, os.path.join(workdir, "a.json"))
        path_b = save_snapshot(snap_b, os.path.join(workdir, "b.json"))
        rc, out = _benchdiff_cli(path_a, path_b)
        if rc != 0 or "=> OK" not in out:
            return _fail(f"self-test GREEN leg failed (exit {rc}):\n{out}")

        # -- self-test: red on an injected 2x lane slowdown ----------------
        path_red = save_snapshot(_scaled_walls(snap_b, 2.0),
                                 os.path.join(workdir, "red.json"))
        rc_red, out_red = _benchdiff_cli(path_a, path_red)
        if rc_red != 1 or "regressed" not in out_red \
                or "=> RED" not in out_red:
            return _fail(f"self-test RED leg failed to regress "
                         f"(exit {rc_red}):\n{out_red}")

        # -- baseline gate (fingerprint-keyed, optional) -------------------
        safe_fp = "".join(c if c.isalnum() or c in "._-" else "_"
                          for c in fp)
        base_path = os.path.join(BASELINE_DIR, safe_fp + ".json")
        baseline_note = "no baseline recorded for this fingerprint"
        if args.write_baseline:
            save_snapshot(snap_b, base_path)
            baseline_note = f"baseline written to {base_path}"
        elif os.path.isfile(base_path):
            diff = diff_snapshots(load_snapshot(base_path), snap_b)
            print(render_diff(diff))
            if not diff["ok"]:
                return _fail(f"regression vs recorded baseline "
                             f"{base_path}")
            baseline_note = (f"within band of baseline {base_path} "
                             f"({diff['improvements']} improvement(s))")

        wall_ms = 1e3 * min(snap_b["tiers"]["gate"]["raw"]["update_wall_s"],
                            snap_a["tiers"]["gate"]["raw"]["update_wall_s"])
        print(f"perf gate: self-test green on re-measurement and red on "
              f"injected 2x slowdown (benchdiff exits 0/1), min-of-{n} "
              f"gate wall {wall_ms:.1f} ms at {GATE_SHAPE}, fingerprint "
              f"{fp}; {baseline_note}")
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
