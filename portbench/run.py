"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with an NVIDIA card. The
cell's configuration (``configs/``), traffic mix (``traffic/<mix>.json``),
the mix's traffic kind (``kinds/<kind>.py``, named by the mix's ``kind``)
and per-layer metrics (``metrics/<metric>.py``) are found by the names in
``BENCHMARK.json``; this file knows none of them. With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (read from a profiled job). The last line of standard
output is one JSON object; the numbers that decide ``correct`` are the
last lines of standard error and the last key of that object. Without a
card, or with fewer cards than the cell asks for, the run prints no result
and exits 2; a run that finds JAX or the JAX package among the loaded
modules exits 3.
"""

from __future__ import annotations

import time

T_SCRIPT = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cnmf_torch_tpu")


def process_start() -> float:
    """The process's start on the epoch clock (``/proc``), else the time
    this script began."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_SCRIPT


def forbidden_modules(names=None) -> list[str]:
    """The top-level names, whole, of JAX and the JAX package among
    ``names`` (the loaded modules by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix and metric lists: an
    end-to-end or per-layer metric with a ``workloads`` key in the cells it
    lists; a per-layer metric without one in every cell that reports the
    metric it moves."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         + ", ".join(sorted(cells)))
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"cell": cell, "config": _load_json(conf["file"]),
            "traffic": _load_json(os.path.join(
                "portbench", "traffic", cell["traffic"] + ".json")),
            "end_to_end": e2e, "per_layer": layer}


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    return _load_file(os.path.join(HERE, "metrics", metric + ".py"),
                      "portbench_metric_" + metric.replace(".", "_")
                      .replace("-", "_")).read


def kind_module(kind: str):
    """The module ``kinds/<kind>.py`` of a traffic kind: its ``run(cfg,
    traffic, seed, seconds, traced, device, workdir)`` gives the record of
    set-up and window, its ``compare(cfg, traffic, record, device)`` the
    numbers that decide ``correct``."""
    name = "portbench_kind_" + kind.replace(".", "_").replace("-", "_")
    if name not in sys.modules:
        sys.modules[name] = _load_file(
            os.path.join(HERE, "kinds", kind + ".py"), name)
    return sys.modules[name]


def card_info() -> dict:
    """The card's name and power limit (``nvidia-smi``; None where it
    cannot be read)."""
    import torch

    info = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set-up, window and comparison of one run: the result object without
    the device key."""
    from portbench.harness import check

    cfg, traffic = spec["config"], spec["traffic"]
    kind = kind_module(traffic["kind"])
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        rec = kind.run(cfg, traffic, seed, seconds, trace, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    setup_s = rec["window_start"] - t_start
    t_ref = time.perf_counter()
    nums = kind.compare(cfg, traffic, rec, device)
    rec["report"]["reference_s"] = time.perf_counter() - t_ref
    correct, shown = check.verdict(nums, cfg["limits"])
    rec.update(config=cfg, numbers=nums)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(rec["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    return {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics,
            "record": rec, "checks": shown}


def breakdown(profile: dict) -> dict:
    ops = sorted(profile["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(profile["idle_by_host"].items(), key=lambda kv: -kv[1][0])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{lbl} ({cnt} gaps, longest {lng} s)", tot]
                          for lbl, (tot, cnt, lng) in gaps[:10]]}


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(load_benchmark(), args.workload)

    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = card_info()
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print("portbench: JAX or the JAX package was loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    line = result_line(out, card, chips, bool(args.trace))
    sys.stdout.flush()
    for name, (v, limit) in line["checks"].items():
        print(f"check {name} {v} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(out: dict, card: dict, chips: int, trace: bool) -> dict:
    """The printed object: the contract's keys, then the kind's report (the
    run's timings and what the program did) and every compared number, and
    last the numbers that decide ``correct`` beside their limits."""
    rec = out["record"]
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    device = {"platform": "gpu", "kind": card["kind"], "count": chips,
              "memory_peak_bytes": rec["memory_peak_bytes"],
              "power_limit_w": card["power_limit_w"]}
    prof = rec.get("profile")
    if trace and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = breakdown(prof)
    line["device"] = device
    line["report"] = rec["report"]
    line["numbers"] = rec["numbers"]
    line["checks"] = out["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
