"""Artifact-atomicity rule: library writes go through ``atomic_artifact``.

The port's copy of ``cnmf_torch_tpu/analysis/rules_artifacts.py``.
``factorize(skip_completed_runs=True)``, the launcher's respawn and
``combine`` probe the run directory and trust what they find, so a
worker killed mid-write must never leave a half-written file under a
final name. The port writes through ``utils/io.py:atomic_artifact`` (a
temp file in the same directory, then ``os.replace``); this rule keeps new
write sites from bypassing it.

``artifact-nonatomic`` flags ``open(path, "w"/"a"/"x"/...)``,
``np.save``/``np.savez*``, ``.to_csv``/``.to_pickle``/``.to_hdf``/
``.to_parquet`` and ``.savefig`` calls that are not lexically inside a
``with atomic_artifact(...)`` block (writes to the yielded temp path are
how the pattern is used).
"""

from __future__ import annotations

import ast

from .engine import FileContext, Finding

WRITE_FUNCS = {"numpy.save", "numpy.savez", "numpy.savez_compressed"}
WRITE_METHODS = {"to_csv", "to_pickle", "to_hdf", "to_parquet", "savefig"}
WRITE_MODES = ("w", "a", "x", "+")

HINT = ("wrap the write in `with atomic_artifact(target) as tmp:` "
        "(utils/io.py) and write to tmp")


def _open_write_mode(call: ast.Call) -> str | None:
    """The mode literal of an ``open`` call when it writes; None for
    reads / non-literal modes."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
            and any(ch in mode.value for ch in WRITE_MODES):
        return mode.value
    return None


def check(ctx: FileContext):
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        resolved = ctx.resolve_call(node)
        msg = None
        if isinstance(node.func, ast.Name) and node.func.id == "open":
            mode = _open_write_mode(node)
            if mode is not None:
                msg = f"`open(..., {mode!r})` writes a final path directly"
        elif resolved in WRITE_FUNCS:
            msg = f"`{resolved}` writes a final path directly"
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in WRITE_METHODS:
            msg = f"`.{node.func.attr}(...)` writes a final path directly"
        if msg and not ctx.in_atomic_with(node):
            findings.append(ctx.finding(
                node, "artifact-nonatomic",
                msg + " — a crash mid-write leaves a torn artifact that "
                      "resume/combine may trust", HINT))
    return findings
