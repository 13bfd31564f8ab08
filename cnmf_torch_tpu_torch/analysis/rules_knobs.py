"""Knob-hygiene rules: every env knob flows through the one registry.

The port's copy of ``cnmf_torch_tpu/analysis/rules_knobs.py``, read
against the port's registries: ``utils/envknobs.py:REGISTRY`` (every
``CNMF_*`` variable the port reads, with its kind, default and doc, and
the typed accessors) and ``runtime/planner.py:DISPATCH_KNOBS`` /
``PLAN_ACCESSORS`` / ``PLAN_OWNER_FILES``.

  * ``knob-raw-env``: ``os.environ[...]``/``.get``/``os.getenv``/
    ``"X" in os.environ`` with a literal ``CNMF_*``/``JAX_*`` name in any
    module but ``utils/envknobs.py``. Dynamic iteration (the telemetry
    manifest's snapshot of the environment) is not a named read.
  * ``knob-unregistered``: an accessor call naming a knob the registry
    lacks (the accessors refuse it at run time too).
  * ``knob-doc-drift``: the registry against the generated table
    ``KNOBS.md`` beside the package, both ways, defaults and docs
    included. The table is generated (``python -m cnmf_torch_tpu_torch
    lint --knob-table``), so the fix is a regenerate.
  * ``knob-plan-bypass``: a dispatch knob (one that picks which program
    runs) read through the accessors outside the planner's own files and
    outside the registered resolver functions, so the logged plan stays
    the dispatch.
"""

from __future__ import annotations

import ast

from .engine import FileContext, Finding, dotted_name

KNOB_PREFIXES = ("CNMF_", "JAX_")
ACCESSORS = {"env_int", "env_float", "env_str", "env_flag", "env_is_set"}
ENV_OWNER = "utils/envknobs.py"


def _is_environ(ctx: FileContext, node: ast.AST) -> bool:
    """The expression ``os.environ`` (or a from-imported alias of it)."""
    name = ctx.imports.resolve(dotted_name(node))
    return name in ("os.environ", "environ")


def _literal_knob(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith(KNOB_PREFIXES):
        return node.value
    return None


def _module_str_constants(tree: ast.Module) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments — the ``*_ENV``
    constant idiom every knob-owning module uses. Lets the plan-bypass
    rule resolve ``env_str(PALLAS_ENV, ...)``-style reads, not just
    string literals."""
    out: dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, str):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = stmt.value.value
    return out


def _knob_arg(node: ast.Call, consts: dict[str, str]) -> str | None:
    """The knob NAME an accessor call reads: a string literal, or a
    module-level ``*_ENV`` constant. Unresolvable expressions return
    None (never a false positive)."""
    if not node.args:
        return None
    lit = _literal_knob(node.args[0])
    if lit is not None:
        return lit
    arg = node.args[0]
    if isinstance(arg, ast.Name):
        val = consts.get(arg.id)
        if val is not None and val.startswith(KNOB_PREFIXES):
            return val
    return None


def check(ctx: FileContext):
    findings: list[Finding] = []
    if ctx.relpath.replace("\\", "/").endswith(ENV_OWNER):
        return findings
    from ..runtime.planner import (DISPATCH_KNOBS, PLAN_ACCESSORS,
                                   PLAN_OWNER_FILES)
    from ..utils.envknobs import REGISTRY

    relpath = ctx.relpath.replace("\\", "/")
    plan_owner = any(relpath.endswith(sfx) for sfx in PLAN_OWNER_FILES)
    consts = _module_str_constants(ctx.tree)

    def _in_plan_accessor(node: ast.AST) -> bool:
        """Whether the call sits (possibly nested) inside one of the
        registered resolver functions."""
        return any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and a.name in PLAN_ACCESSORS
                   for a in ctx.ancestors(node))

    hint = ("read it through utils/envknobs.py (env_int/env_float/"
            "env_str/env_flag), registering the knob there")
    for node in ast.walk(ctx.tree):
        name = None
        if isinstance(node, ast.Subscript) and _is_environ(ctx, node.value):
            name = _literal_knob(node.slice)
        elif isinstance(node, ast.Call):
            resolved = ctx.resolve_call(node)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("get", "setdefault", "pop") \
                    and _is_environ(ctx, node.func.value) and node.args:
                name = _literal_knob(node.args[0])
            elif resolved == "os.getenv" and node.args:
                name = _literal_knob(node.args[0])
            elif (resolved or "").split(".")[-1] in ACCESSORS \
                    and node.args:
                knob = _literal_knob(node.args[0])
                if knob is not None and knob not in REGISTRY:
                    findings.append(ctx.finding(
                        node, "knob-unregistered",
                        f"env knob `{knob}` is not declared in the "
                        "utils/envknobs.py registry",
                        "add a Knob(name, kind, default, doc) entry"))
                    continue
                plan_knob = _knob_arg(node, consts)
                if plan_knob in DISPATCH_KNOBS and not plan_owner \
                        and not _in_plan_accessor(node):
                    findings.append(ctx.finding(
                        node, "knob-plan-bypass",
                        f"dispatch-class knob `{plan_knob}` read outside "
                        "the execution planner and its registered "
                        "resolvers (runtime/planner.py:PLAN_ACCESSORS)",
                        "resolve it inside the owning resolver function "
                        "(or register a new resolver in PLAN_ACCESSORS) "
                        "so the logged plan stays THE dispatch"))
                continue
        elif isinstance(node, ast.Compare) \
                and any(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops) \
                and node.comparators \
                and _is_environ(ctx, node.comparators[0]):
            name = _literal_knob(node.left)
        if name is not None:
            findings.append(ctx.finding(
                node, "knob-raw-env",
                f"raw os.environ access to `{name}` outside "
                f"{ENV_OWNER}", hint))
    return findings


def check_knob_docs(doc_path: str, root: str | None = None
                    ) -> list[Finding]:
    """Cross-check the registry against the knob table of ``doc_path``
    (``KNOBS.md``), both ways. Runs once a lint invocation, not once a
    file."""
    from ..utils.envknobs import REGISTRY, parse_knob_table

    with open(doc_path, encoding="utf-8") as f:
        text = f.read()
    table = parse_knob_table(text)
    table_line = 1
    for i, line in enumerate(text.splitlines(), start=1):
        if line.strip().startswith("| knob |"):
            table_line = i
            break

    from .engine import _relpath

    rel = _relpath(doc_path, root)
    regen = ("regenerate the table with `python -m cnmf_torch_tpu_torch "
             "lint --knob-table > cnmf_torch_tpu_torch/KNOBS.md`")
    findings: list[Finding] = []
    documented = {n: k for n, k in REGISTRY.items() if k.documented}
    for name, knob in documented.items():
        if name not in table:
            findings.append(Finding(
                rel, table_line, "knob-doc-drift",
                f"registered knob `{name}` is missing from the knob table",
                regen,
                f"missing row: {name}"))
        elif table[name][0] != knob.default:
            findings.append(Finding(
                rel, table_line, "knob-doc-drift",
                f"knob table default for `{name}` is {table[name][0]!r}; "
                f"the registry says {knob.default!r}",
                regen,
                f"stale default: {name}"))
        elif table[name][1] != knob.doc:
            findings.append(Finding(
                rel, table_line, "knob-doc-drift",
                f"knob table description for `{name}` differs from the "
                "registry doc (the table is generated, not hand-edited)",
                regen,
                f"stale doc: {name}"))
    for name in table:
        if name not in documented:
            findings.append(Finding(
                rel, table_line, "knob-doc-drift",
                f"the knob table documents `{name}`, which is not a "
                "registered knob",
                "register it in utils/envknobs.py or drop the row",
                f"unregistered row: {name}"))
    return findings
