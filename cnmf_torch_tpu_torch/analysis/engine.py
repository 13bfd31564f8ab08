"""``python -m cnmf_torch_tpu_torch lint``: the port's AST rule engine.

The port's own copy of ``cnmf_torch_tpu/analysis/engine.py`` (the same
findings, suppression comments, baseline fingerprints, output and CLI),
run over the port against the port's registries. It checks the
invariants no generic linter knows: artifact writes are atomic (resume and
``combine`` trust what they find), telemetry events match the one schema
of ``utils/telemetry.py``, env knobs parse through the
``utils/envknobs.py`` registry and its table ``KNOBS.md``, the solver paths
read the host only inside ``with host_read():`` and draw no global RNG
state, and module-level mutable state mutates under its module's lock.

Per-file AST visitors produce :class:`Finding`\\ s with ``file:line``, a
stable rule id and a fix hint; ``# cnmf-lint: disable=RULE`` on the line
or the line above suppresses one site; a checked-in baseline
(``baseline.json``, shipped empty: the port lints clean) grandfathers
findings; ``analysis/gate.py`` is the gate.

Rule families live in sibling modules (``rules_sync``, ``rules_knobs``,
``rules_artifacts``, ``rules_telemetry``, ``rules_concurrency``); this
module owns the shared AST utilities (import aliases, parent links,
dotted names), suppression and baseline semantics, output and the CLI.
Nothing here imports torch.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

__all__ = [
    "Finding",
    "FileContext",
    "LintResult",
    "ALL_RULE_IDS",
    "RULE_FAMILIES",
    "DEFAULT_BASELINE",
    "PACKAGE_DIR",
    "lint_paths",
    "load_baseline",
    "write_baseline",
    "format_text",
    "format_json",
    "main",
]

SUPPRESS_RE = re.compile(r"#\s*cnmf-lint:\s*disable=([A-Za-z0-9_,\- ]+)")

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")
# the package the CLI lints by default, and its generated knob table
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB_DOC = "KNOBS.md"

# rule id -> family (the gate echoes one count per family)
RULE_FAMILIES = {
    "host-sync": "sync",
    "rng-global": "sync",
    "knob-raw-env": "knobs",
    "knob-unregistered": "knobs",
    "knob-doc-drift": "knobs",
    "knob-plan-bypass": "knobs",
    "artifact-nonatomic": "artifact",
    "telemetry-schema": "telemetry",
    "lock-discipline": "concurrency",
    "lint-parse-error": "engine",
}
ALL_RULE_IDS = tuple(RULE_FAMILIES)


@dataclass
class Finding:
    """One rule violation at ``path:line``. ``text`` is the stripped
    source line — the line-number-drift-proof component of the baseline
    fingerprint."""

    path: str
    line: int
    rule: str
    message: str
    hint: str = ""
    text: str = ""

    def key(self) -> tuple:
        return (self.path.replace(os.sep, "/"), self.rule, self.text)

    def as_dict(self) -> dict:
        return {"path": self.path.replace(os.sep, "/"), "line": self.line,
                "rule": self.rule, "message": self.message,
                "hint": self.hint, "text": self.text}


# ---------------------------------------------------------------------------
# per-file context: parse once, share alias map + parent links across rules
# ---------------------------------------------------------------------------

class ImportMap:
    """Resolve local names to dotted module paths: ``import numpy as np``
    makes ``np.asarray`` resolve to ``numpy.asarray``; ``from torch import
    cuda`` makes ``cuda.synchronize`` resolve to
    ``torch.cuda.synchronize``."""

    def __init__(self, tree: ast.AST):
        self.alias: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.alias[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def resolve(self, dotted: str | None) -> str | None:
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        base = self.alias.get(head, head)
        return f"{base}.{rest}" if rest else base


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class FileContext:
    def __init__(self, path: str, relpath: str, src: str, tree: ast.AST):
        self.path = path
        self.relpath = relpath
        self.src = src
        self.tree = tree
        self.lines = src.splitlines()
        self.imports = ImportMap(tree)
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def resolve_call(self, call: ast.Call) -> str | None:
        return self.imports.resolve(dotted_name(call.func))

    def finding(self, node: ast.AST, rule: str, message: str,
                hint: str = "") -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(self.relpath, line, rule, message, hint,
                       self.line_text(line))

    def in_with(self, node: ast.AST, leaf: str) -> bool:
        """True when ``node`` sits inside a ``with <leaf>(...)`` block."""
        for anc in self.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    if isinstance(item.context_expr, ast.Call):
                        name = self.resolve_call(item.context_expr) or ""
                        if name.split(".")[-1] == leaf:
                            return True
        return False

    def in_atomic_with(self, node: ast.AST) -> bool:
        """True when ``node`` sits inside a ``with atomic_artifact(...)``
        block: the write is then the temp-file half of an atomic
        rename."""
        return self.in_with(node, "atomic_artifact")


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------

def _suppressions(lines: list[str]) -> dict[int, set[str]]:
    """Map line number -> suppressed rule ids. A tag on a code line
    covers that line; a tag on its own comment line covers the next
    non-blank, non-comment line."""
    out: dict[int, set[str]] = {}
    pending: set[str] | None = None
    for i, raw in enumerate(lines, start=1):
        stripped = raw.strip()
        m = SUPPRESS_RE.search(raw)
        rules = ({r.strip() for r in m.group(1).split(",") if r.strip()}
                 if m else None)
        if rules and stripped.startswith("#"):
            pending = (pending or set()) | rules
            continue
        if rules:
            out.setdefault(i, set()).update(rules)
        if pending is not None and stripped and not stripped.startswith("#"):
            out.setdefault(i, set()).update(pending)
            pending = None
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str | None) -> dict[tuple, int]:
    """Baseline file -> multiset of finding fingerprints. Missing/None ->
    empty (everything is a new finding)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    out: dict[tuple, int] = {}
    for ent in data.get("findings", []):
        key = (ent["path"], ent["rule"], ent.get("text", ""))
        out[key] = out.get(key, 0) + 1
    return out


def write_baseline(path: str, findings: list[Finding]) -> None:
    data = {
        "version": 1,
        "comment": "grandfathered lint findings of the port; regenerate "
                   "with `python -m cnmf_torch_tpu_torch lint "
                   "--write-baseline` (the goal state is an empty list)",
        "findings": [
            {"path": f.path.replace(os.sep, "/"), "rule": f.rule,
             "text": f.text}
            for f in sorted(findings, key=lambda f: f.key())
        ],
    }
    from ..utils.io import atomic_artifact

    with atomic_artifact(path) as tmp:
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=1)
            fh.write("\n")


def split_baselined(findings: list[Finding],
                    baseline: dict[tuple, int]
                    ) -> tuple[list[Finding], list[Finding]]:
    """(new, baselined): each baseline fingerprint absorbs up to its
    recorded multiplicity, in file order."""
    budget = dict(baseline)
    new, old = [], []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)   # new (gating)
    baselined: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    files: int = 0

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def family_counts(self) -> dict[str, int]:
        out = {fam: 0 for fam in dict.fromkeys(RULE_FAMILIES.values())}
        for f in self.findings:
            fam = RULE_FAMILIES.get(f.rule, "engine")
            out[fam] = out.get(fam, 0) + 1
        return out


def _iter_python_files(paths: list[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        yield os.path.join(root, fn)
        else:
            raise FileNotFoundError(f"lint: no such path: {p}")


def _all_rules():
    from . import (rules_artifacts, rules_concurrency, rules_knobs,
                   rules_sync, rules_telemetry)

    return (rules_sync.check, rules_knobs.check, rules_artifacts.check,
            rules_telemetry.check, rules_concurrency.check)


def _find_knob_doc(paths: list[str]) -> str | None:
    """The generated knob table the registry is held to: the first
    ``KNOBS.md`` holding the table's header, walking up at most four
    directories from each linted path (the port's sits in the package
    directory)."""
    from ..utils.envknobs import TABLE_HEADER

    seen = set()
    for p in paths:
        cur = os.path.abspath(p if os.path.isdir(p) else os.path.dirname(p))
        for _ in range(4):
            if cur in seen:
                break
            seen.add(cur)
            cand = os.path.join(cur, KNOB_DOC)
            if os.path.exists(cand):
                with open(cand, encoding="utf-8") as f:
                    if TABLE_HEADER[0] in f.read():
                        return cand
            nxt = os.path.dirname(cur)
            if nxt == cur:
                break
            cur = nxt
    return None


def _relpath(path: str, root: str | None = None) -> str:
    ap = os.path.abspath(path)
    base = os.path.abspath(root) if root else os.getcwd()
    if ap == base or ap.startswith(base + os.sep):
        return os.path.relpath(ap, base).replace(os.sep, "/")
    return ap.replace(os.sep, "/")


def lint_paths(paths: list[str], baseline_path: str | None = None,
               doc_check: bool = True,
               root: str | None = None) -> LintResult:
    """Lint ``paths`` (files or directory trees). Returns a
    :class:`LintResult` whose ``findings`` are the NEW (unbaselined,
    unsuppressed) violations; ``baselined`` carries the grandfathered
    matches for reporting. Findings name files relative to ``root``
    (default: the working directory), which the baseline's paths are
    too."""
    rules = _all_rules()
    result = LintResult()
    all_findings: list[Finding] = []
    for path in _iter_python_files(paths):
        relpath = _relpath(path, root)
        with open(path, encoding="utf-8") as f:
            src = f.read()
        result.files += 1
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as exc:
            all_findings.append(Finding(
                relpath, exc.lineno or 1, "lint-parse-error",
                f"file does not parse: {exc.msg}", "fix the syntax error"))
            continue
        ctx = FileContext(path, relpath, src, tree)
        file_findings: list[Finding] = []
        for check in rules:
            file_findings.extend(check(ctx))
        sup = _suppressions(ctx.lines)
        for f in file_findings:
            if f.rule in sup.get(f.line, ()):  # inline opt-out
                result.suppressed += 1
            else:
                all_findings.append(f)
    if doc_check:
        doc = _find_knob_doc(paths)
        if doc:
            from .rules_knobs import check_knob_docs

            all_findings.extend(check_knob_docs(doc, root))
    all_findings.sort(key=lambda f: (f.path, f.line, f.rule))
    result.findings, result.baselined = split_baselined(
        all_findings, load_baseline(baseline_path))
    return result


# ---------------------------------------------------------------------------
# output + CLI
# ---------------------------------------------------------------------------

def format_text(result: LintResult) -> str:
    lines = []
    for f in result.findings:
        hint = f" (fix: {f.hint})" if f.hint else ""
        lines.append(f"{f.path}:{f.line}: {f.rule}: {f.message}{hint}")
    counts = result.counts()
    per_rule = " ".join(f"{r}={n}" for r, n in sorted(counts.items()))
    lines.append(
        f"lint: {len(result.findings)} finding(s) across {result.files} "
        f"file(s); {len(result.baselined)} baselined, "
        f"{result.suppressed} suppressed"
        + (f" [{per_rule}]" if per_rule else ""))
    return "\n".join(lines)


def format_json(result: LintResult) -> str:
    return json.dumps({
        "version": 1,
        "findings": [f.as_dict() for f in result.findings],
        "counts": result.counts(),
        "families": result.family_counts(),
        "baselined": len(result.baselined),
        "suppressed": result.suppressed,
        "files": result.files,
    }, indent=1)


def main(argv=None, prog: str = "python -m cnmf_torch_tpu_torch lint") -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog=prog,
        description="Codebase-aware static analysis of the port: host "
                    "syncs and global RNG on the solver paths, knob "
                    "hygiene, artifact atomicity, telemetry schema, lock "
                    "discipline")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to lint (default: the "
                             "cnmf_torch_tpu_torch package)")
    parser.add_argument("--format", choices=["text", "json"],
                        default="text")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline file of grandfathered findings "
                             f"(default: {DEFAULT_BASELINE}); pass an "
                             "empty string to disable")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline file from the current "
                             "findings and exit 0")
    parser.add_argument("--no-doc-check", action="store_true",
                        help="skip the KNOBS.md knob-table drift check")
    parser.add_argument("--knob-table", action="store_true",
                        help="print the knob table generated from the "
                             "registry (the contents of KNOBS.md), then "
                             "exit")
    args = parser.parse_args(argv)

    if args.knob_table:
        from ..utils.envknobs import knob_table

        print(knob_table())
        return 0

    paths = args.paths or [PACKAGE_DIR]
    baseline = args.baseline or None
    try:
        if args.write_baseline:
            if baseline is None:
                # `--baseline ''` means "no baseline"; silently writing
                # the checked-in default instead would grandfather the
                # findings the caller asked to see
                parser.error("--write-baseline needs a baseline path "
                             "(--baseline FILE)")
            pre = lint_paths(paths, baseline_path=None,
                             doc_check=not args.no_doc_check)
            write_baseline(baseline, pre.findings)
            print(f"lint: wrote {len(pre.findings)} finding(s) to "
                  f"{baseline}")
            return 0
        result = lint_paths(paths, baseline_path=baseline,
                            doc_check=not args.no_doc_check)
    except FileNotFoundError as exc:
        parser.error(str(exc))
    print(format_json(result) if args.format == "json"
          else format_text(result))
    return 1 if result.findings else 0
