"""Telemetry-schema rule: emit sites are validated at lint time.

The port's copy of ``cnmf_torch_tpu/analysis/rules_telemetry.py``.
``utils/telemetry.py`` holds the one schema (``EVENT_TYPES``: the
required fields of each event type), which ``validate_event`` enforces at
run time; a misspelt event type or a dropped field would show only in a
run with ``CNMF_TPU_TELEMETRY=1``. This rule checks the common shape,
``events.emit("<literal type>", field=..., ...)``, statically:

  * an event type not in ``EVENT_TYPES`` is rejected;
  * when every field is a plain keyword (no ``**`` splat), a missing
    required field is rejected (a field passed as ``None`` is dropped at
    emit time, which only the runtime check sees).
"""

from __future__ import annotations

import ast

from .engine import FileContext, Finding

COMMON_FIELDS = {"v", "t", "ts"}


def check(ctx: FileContext):
    from ..utils.telemetry import EVENT_TYPES

    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit" and node.args):
            continue
        etype = node.args[0]
        if not (isinstance(etype, ast.Constant)
                and isinstance(etype.value, str)):
            continue  # forwarding wrappers (telemetry.EventLog internals)
        if etype.value not in EVENT_TYPES:
            findings.append(ctx.finding(
                node, "telemetry-schema",
                f"unknown telemetry event type {etype.value!r} "
                f"(schema knows: {', '.join(sorted(EVENT_TYPES))})",
                "add the type to utils/telemetry.py EVENT_TYPES or fix "
                "the call"))
            continue
        if any(kw.arg is None for kw in node.keywords):
            continue  # **fields splat: field set is dynamic
        provided = {kw.arg for kw in node.keywords} | COMMON_FIELDS
        missing = sorted(set(EVENT_TYPES[etype.value]) - provided)
        if missing:
            findings.append(ctx.finding(
                node, "telemetry-schema",
                f"emit({etype.value!r}, ...) omits required field(s) "
                f"{', '.join(missing)} — validate_event rejects the line "
                "at runtime",
                "pass every field EVENT_TYPES requires for this type"))
    return findings
