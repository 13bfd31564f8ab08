"""Lock-discipline rule: module-level mutable state mutates under a lock.

The port's copy of ``cnmf_torch_tpu/analysis/rules_concurrency.py``. The
JAX package found stage-timer rows torn by concurrent statistics threads
and a profiler latch racing the same way; both fixes put a module-level
``threading.Lock`` beside the state and every mutation inside ``with
lock:``, which this rule enforces.

``lock-discipline`` fires when a function mutates a module-level mutable
binding without a module-level lock held:

  * container mutation: ``NAME[k] = v``, ``NAME.append/update/pop/...``
    on a module-level dict/list/set;
  * rebinding: ``global NAME; NAME = ...`` (or an augmented assignment)
    of any module-level binding (the check-then-act latch).

A mutation is clean when an enclosing ``with`` holds a module-level
``threading.Lock``/``RLock``/``Condition``. Instance state (``self._x``
under ``self._lock``) is out of scope. A latch that only one thread ever
sets carries ``# cnmf-lint: disable=lock-discipline`` with a comment
saying why.
"""

from __future__ import annotations

import ast

from .engine import FileContext, Finding

MUTATORS = {"append", "add", "update", "pop", "clear", "extend", "remove",
            "discard", "setdefault", "popitem", "insert"}
LOCK_FACTORIES = {"threading.Lock", "threading.RLock",
                  "threading.Condition"}

HINT = ("guard the mutation with `with <module lock>:` (add a module-"
        "level threading.Lock next to the state), or suppress with a "
        "justification if provably single-threaded")


def _module_bindings(ctx: FileContext):
    """(mutable container names, lock names, all module-level names)."""
    mutable, locks, all_names = set(), set(), set()
    for stmt in ctx.tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        for t in targets:
            all_names.add(t.id)
            if isinstance(value, (ast.Dict, ast.List, ast.Set)):
                mutable.add(t.id)
            elif isinstance(value, ast.Call):
                resolved = ctx.resolve_call(value) or ""
                leaf = resolved.split(".")[-1]
                if resolved in LOCK_FACTORIES:
                    locks.add(t.id)
                elif leaf in ("dict", "list", "set", "OrderedDict",
                              "defaultdict", "deque", "Counter"):
                    mutable.add(t.id)
    return mutable, locks, all_names


def _shallow_walk(fn: ast.AST):
    """Walk ``fn``'s own body WITHOUT descending into nested function/
    lambda scopes — their bindings and mutations are analyzed on their
    own pass (``ast.walk`` would leak a nested ``x = ...`` into the outer
    function's local-shadow set, masking real findings)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _local_names(fn: ast.AST, global_decls: set[str]) -> set[str]:
    """Names bound locally in ``fn``'s own scope (params/assignments/
    for/with/comp targets) and NOT declared global — those shadow module
    state."""
    out = set(p.arg for p in (fn.args.posonlyargs + fn.args.args
                              + fn.args.kwonlyargs))
    if fn.args.vararg:
        out.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        out.add(fn.args.kwarg.arg)
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    # Store context only: the base of `_state[k] = v` is a
                    # Load of module state, not a local binding
                    if isinstance(n, ast.Name) \
                            and isinstance(n.ctx, ast.Store):
                        out.add(n.id)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.NamedExpr) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    out.add(n.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    for n in ast.walk(item.optional_vars):
                        if isinstance(n, ast.Name):
                            out.add(n.id)
        elif isinstance(node, ast.comprehension):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    out.add(n.id)
    return out - global_decls


def _under_lock(ctx: FileContext, node: ast.AST, locks: set[str]) -> bool:
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id in locks:
                    return True
    return False


def check(ctx: FileContext):
    findings: list[Finding] = []
    mutable, locks, module_names = _module_bindings(ctx)
    if not module_names:
        return findings

    funcs = [n for n in ast.walk(ctx.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        global_decls: set[str] = set()
        for node in _shallow_walk(fn):
            if isinstance(node, ast.Global):
                global_decls.update(node.names)
        local = _local_names(fn, global_decls)

        for node in _shallow_walk(fn):
            target_name, what = None, None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in mutable \
                            and t.value.id not in local:
                        target_name = t.value.id
                        what = "item assignment on module-level container"
                    elif isinstance(t, ast.Name) \
                            and t.id in global_decls \
                            and t.id in module_names:
                        target_name = t.id
                        what = "rebind of module-level binding"
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATORS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in mutable \
                    and node.func.value.id not in local:
                target_name = node.func.value.id
                what = f".{node.func.attr}() on module-level container"
            if target_name and not _under_lock(ctx, node, locks):
                lock_note = ("no module-level lock exists in this module"
                             if not locks else
                             "outside every module-level lock")
                findings.append(ctx.finding(
                    node, "lock-discipline",
                    f"{what} `{target_name}` {lock_note} — concurrent "
                    "callers race",
                    HINT))
    return findings
