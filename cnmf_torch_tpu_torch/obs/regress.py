"""The perf-regression observatory: bench snapshots and their noise-aware
diff.

Own copy of ``cnmf_torch_tpu/obs/regress.py`` with the same schema
(``cnmf-bench``, version 1), so either package's ``benchdiff`` reads the
other's snapshots. A snapshot wraps each tier's raw result dict; every
number the diff compares is lifted by :func:`extract_metrics` into a typed
``{value, unit, direction}`` entry. Snapshots carry a device fingerprint:
a baseline from other hardware is incomparable (every row exempt), never
diffed as a regression.

:func:`diff_snapshots` compares min-of-N for lower-is-better metrics with
samples (max-of-N for higher-is-better), holds each metric to a relative
band before it can regress, never gates a perf-exempt tier, and reports
improvements apart from regressions. ``python -m cnmf_torch_tpu_torch
benchdiff BASE NEW`` renders it and exits 1 on a regression; the perf gate
(``obs/perf_gate.py``) runs that command on two measurements of a pinned
lane.
"""

from __future__ import annotations

import json
import math
import os

__all__ = ["BENCH_SCHEMA", "BENCH_SCHEMA_VERSION", "build_snapshot",
           "validate_bench", "extract_metrics", "save_snapshot",
           "load_snapshot", "diff_snapshots", "render_diff",
           "GATE_BAND_ENV", "GATE_N_ENV", "DEFAULT_BAND", "DEFAULT_N",
           "gate_band", "gate_n"]

BENCH_SCHEMA = "cnmf-bench"
BENCH_SCHEMA_VERSION = 1

GATE_BAND_ENV = "CNMF_TPU_PERF_GATE_BAND"
GATE_N_ENV = "CNMF_TPU_PERF_GATE_N"

# relative band a comparable metric must move past before the diff
# calls it (the JAX package's default, set for walls on an
# oversubscribed host); calm dedicated hardware can tighten it through
# CNMF_TPU_PERF_GATE_BAND
DEFAULT_BAND = 0.6
DEFAULT_N = 3


def gate_band() -> float:
    """Relative regression band (CNMF_TPU_PERF_GATE_BAND, default 0.6)."""
    from ..utils.envknobs import env_float

    return float(env_float(GATE_BAND_ENV, DEFAULT_BAND))


def gate_n() -> int:
    """Min-of-N sample count of the perf gate's walls
    (CNMF_TPU_PERF_GATE_N, default 3; at least 1)."""
    from ..utils.envknobs import env_int

    return max(1, int(env_int(GATE_N_ENV, DEFAULT_N)))


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

_LOWER_HINTS = ("seconds", "wall", "_ms", "_s", "latency", "overhead",
                "p50", "p95", "p99", "compile")
_HIGHER_HINTS = ("mfu", "flops", "gb_per_s", "qps", "throughput",
                 "overlap_fraction", "speedup", "per_second")
_SKIP_HINTS = ("vs_baseline",
               # counts are occupancy, not cost: histogram buckets shift
               # with scheduler noise and `.count`/samples_* track request
               # volume — gating on them red-flags honest jitter
               "histogram", ".count", "_count", "samples_kept",
               "samples_dropped")


def _direction(name: str) -> str | None:
    low = name.lower()
    for h in _SKIP_HINTS:
        if h in low:
            return None
    for h in _HIGHER_HINTS:
        if h in low:
            return "higher"
    for h in _LOWER_HINTS:
        if h in low:
            return "lower"
    return None


def extract_metrics(raw, prefix: str = "") -> dict:
    """Walk one tier's ad-hoc result dict and lift every comparable
    numeric leaf into a typed metric: ``{value, unit, direction}`` with
    dotted-path names. Only leaves whose name declares a direction
    (wall/latency-like => lower is better, MFU/throughput-like =>
    higher) are lifted — shape/config integers never become gate
    metrics. Deterministic: same raw dict, same metric set."""
    out: dict = {}
    if not isinstance(raw, dict):
        return out
    for key in sorted(raw):
        val = raw[key]
        name = f"{prefix}{key}"
        if isinstance(val, bool):
            continue
        if isinstance(val, dict):
            out.update(extract_metrics(val, prefix=f"{name}."))
            continue
        if not isinstance(val, (int, float)) or not math.isfinite(val):
            continue
        direction = _direction(name)
        if direction is None:
            continue
        low = name.lower()
        unit = ("s" if ("seconds" in low or low.endswith("_s")
                        or "wall" in low) else
                "ms" if "_ms" in low or low.endswith("ms") else
                "frac" if "mfu" in low or "fraction" in low else "")
        out[name] = {"value": float(val), "unit": unit,
                     "direction": direction}
    return out


def build_snapshot(tiers: dict, *, fingerprint: str, created: float,
                   label: str | None = None) -> dict:
    """Wrap raw per-tier bench results into a schema-versioned
    snapshot. Each tier entry keeps the full ad-hoc payload under
    ``raw`` and gains the typed ``metrics`` the diff machinery
    compares; a tier whose raw result carries ``perf_exempt`` (or an
    ``error``) is marked so and never gates."""
    tdocs = {}
    for tier, raw in (tiers or {}).items():
        raw = raw if isinstance(raw, dict) else {"value": raw}
        tdocs[str(tier)] = {
            "metrics": extract_metrics(raw),
            "perf_exempt": bool(raw.get("perf_exempt")
                                or raw.get("error")),
            "raw": raw,
        }
    doc = {"schema": BENCH_SCHEMA, "schema_version": BENCH_SCHEMA_VERSION,
           "fingerprint": str(fingerprint), "created": float(created),
           "tiers": tdocs}
    if label:
        doc["label"] = str(label)
    validate_bench(doc)
    return doc


def validate_bench(doc) -> None:
    """Raise ``ValueError`` unless ``doc`` is a schema-valid bench
    snapshot — same contract validate_event gives telemetry lines."""
    if not isinstance(doc, dict):
        raise ValueError(f"bench doc is not an object: {type(doc).__name__}")
    if doc.get("schema") != BENCH_SCHEMA:
        raise ValueError(f"not a {BENCH_SCHEMA} document: "
                         f"schema={doc.get('schema')!r}")
    if doc.get("schema_version") != BENCH_SCHEMA_VERSION:
        raise ValueError(
            f"bench schema_version={doc.get('schema_version')!r} (this "
            f"build understands {BENCH_SCHEMA_VERSION})")
    for field, typ in (("fingerprint", str), ("created", (int, float)),
                       ("tiers", dict)):
        if not isinstance(doc.get(field), typ):
            raise ValueError(f"bench doc field {field!r} must be "
                             f"{typ}: {doc.get(field)!r}")
    for tier, tdoc in doc["tiers"].items():
        if not isinstance(tdoc, dict) or not isinstance(
                tdoc.get("metrics"), dict):
            raise ValueError(f"tier {tier!r} must carry a metrics dict")
        for name, m in tdoc["metrics"].items():
            if not isinstance(m, dict) or not isinstance(
                    m.get("value"), (int, float)):
                raise ValueError(
                    f"tier {tier!r} metric {name!r} must be an object "
                    f"with a numeric value: {m!r}")
            if m.get("direction") not in ("lower", "higher"):
                raise ValueError(
                    f"tier {tier!r} metric {name!r} direction must be "
                    f"lower|higher: {m.get('direction')!r}")
            samples = m.get("samples")
            if samples is not None and (
                    not isinstance(samples, list)
                    or not all(isinstance(s, (int, float))
                               for s in samples)):
                raise ValueError(
                    f"tier {tier!r} metric {name!r} samples must be a "
                    f"numeric list: {samples!r}")


def save_snapshot(doc: dict, path: str) -> str:
    """Validate + atomically write a snapshot (tmp + rename, the house
    artifact rule). Returns ``path``."""
    from ..utils.io import atomic_artifact

    validate_bench(doc)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with atomic_artifact(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    return path


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    validate_bench(doc)
    return doc


# ---------------------------------------------------------------------------
# noise-aware diff
# ---------------------------------------------------------------------------

def _effective(m: dict) -> float:
    """The comparison value of one metric: min-of-N over samples for
    lower-is-better (the low-noise estimator under scheduler
    interference), max-of-N for higher-is-better, else the scalar."""
    samples = m.get("samples")
    if isinstance(samples, list) and samples:
        vals = [float(s) for s in samples]
        return min(vals) if m.get("direction") == "lower" else max(vals)
    return float(m["value"])


def diff_snapshots(base: dict, new: dict, band: float | None = None) -> dict:
    """Compare two validated snapshots. Returns ``{rows, regressions,
    improvements, ok, fingerprint_match}`` where each row is one
    (tier, metric) with the relative move and a verdict in
    {ok, regressed, improved, exempt, missing}. ``ok`` is False iff
    any comparable row regressed past the band."""
    validate_bench(base)
    validate_bench(new)
    band = gate_band() if band is None else float(band)
    fp_match = base.get("fingerprint") == new.get("fingerprint")
    rows = []
    regressions = improvements = 0
    for tier in sorted(set(base["tiers"]) | set(new["tiers"])):
        bt, nt = base["tiers"].get(tier), new["tiers"].get(tier)
        if bt is None or nt is None:
            rows.append({"tier": tier, "metric": "*",
                         "verdict": "missing",
                         "note": "tier absent from "
                                 + ("baseline" if bt is None else "new")})
            continue
        exempt = bool(bt.get("perf_exempt") or nt.get("perf_exempt")
                      or not fp_match)
        for name in sorted(set(bt["metrics"]) | set(nt["metrics"])):
            bm, nm = bt["metrics"].get(name), nt["metrics"].get(name)
            if bm is None or nm is None:
                rows.append({"tier": tier, "metric": name,
                             "verdict": "missing"})
                continue
            bv, nv = _effective(bm), _effective(nm)
            if bv == 0:
                rel = 0.0 if nv == 0 else math.inf
            else:
                rel = (nv - bv) / abs(bv)
            direction = bm.get("direction", "lower")
            # normalize so positive `moved` always means "got worse"
            moved = rel if direction == "lower" else -rel
            if exempt:
                verdict = "exempt"
            elif moved > band:
                verdict = "regressed"
                regressions += 1
            elif moved < -band:
                verdict = "improved"
                improvements += 1
            else:
                verdict = "ok"
            rows.append({"tier": tier, "metric": name, "base": bv,
                         "new": nv, "rel": (round(rel, 4)
                                            if math.isfinite(rel)
                                            else None),
                         "direction": direction,
                         "unit": bm.get("unit", ""), "verdict": verdict})
    return {"rows": rows, "regressions": regressions,
            "improvements": improvements, "band": band,
            "fingerprint_match": fp_match,
            "base_fingerprint": base.get("fingerprint"),
            "new_fingerprint": new.get("fingerprint"),
            "ok": regressions == 0}


def render_diff(diff: dict) -> str:
    """Human-readable benchdiff table."""
    lines = []
    if not diff.get("fingerprint_match"):
        lines.append(
            f"NOTE: device fingerprints differ "
            f"({diff.get('base_fingerprint')} vs "
            f"{diff.get('new_fingerprint')}) — all rows exempt, nothing "
            f"gates across hardware")
    lines.append(f"{'tier':<12s} {'metric':<44s} {'base':>12s} "
                 f"{'new':>12s} {'rel':>8s}  verdict")
    for r in diff.get("rows", []):
        if r.get("verdict") == "missing" and r.get("metric") == "*":
            lines.append(f"{r['tier']:<12s} {'*':<44s} "
                         f"{'':>12s} {'':>12s} {'':>8s}  "
                         f"missing ({r.get('note', '')})")
            continue
        base, new = r.get("base"), r.get("new")
        rel = r.get("rel")
        lines.append(
            f"{str(r.get('tier'))[:12]:<12s} "
            f"{str(r.get('metric'))[:44]:<44s} "
            + (f"{base:>12.4f}" if isinstance(base, (int, float))
               else f"{'n/a':>12s}") + " "
            + (f"{new:>12.4f}" if isinstance(new, (int, float))
               else f"{'n/a':>12s}") + " "
            + (f"{100 * rel:>+7.1f}%" if isinstance(rel, (int, float))
               else f"{'n/a':>8s}")
            + f"  {r.get('verdict')}")
    lines.append(
        f"-- {diff.get('regressions', 0)} regression(s), "
        f"{diff.get('improvements', 0)} improvement(s), band "
        f"±{100 * diff.get('band', 0.0):.0f}% => "
        + ("OK" if diff.get("ok") else "RED"))
    return "\n".join(lines)
