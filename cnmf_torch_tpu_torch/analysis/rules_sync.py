"""Solver-path rules: no hidden host read, no global RNG draw.

The torch counterpart of ``cnmf_torch_tpu/analysis/rules_trace.py``. A
torch program is not traced, so no scope is found by its decorators: the
hot scopes are named. :data:`HOT_SCOPES` lists, by file, the port's
functions whose bodies run every iteration or every pass (nested
functions included; a name ending in ``*`` is a prefix). Inside them:

  * ``host-sync``: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.to("cpu")``, ``np.asarray``/``np.array`` of a non-literal, and
    ``float()``/``int()``/``bool()`` or an ``if``/``while`` test on a
    tensor reduction (``.any()``, ``.all()``, ``.sum()``, ``.max()``,
    ...). Each one stalls the host until the card has caught up, once an
    iteration. A read the solver means to make sits lexically inside
    ``with host_read():`` (``utils/sanitize.py``), which exempts it here
    and lets it through the runtime guard: one marker serves both checks.
    Shape, size, ``ndim`` and ``len`` probes are host facts and exempt.
  * ``rng-global``: a draw from global RNG state: ``torch.rand*``/
    ``randperm``/``normal``/``bernoulli``/``multinomial``/``poisson`` or an
    in-place ``.uniform_()``-style draw without ``generator=``,
    ``torch.manual_seed``/``seed``, and ``random.*``/legacy
    ``np.random.<draw>``. Replicates must come from their seeds (a rerun
    or a resume reproduces them), so draws take an explicit generator.

The lexical check cannot see a sync that no call spells (boolean-mask
indexing, ``nonzero``, ``if tensor:``): the runtime guard
(``utils/sanitize.py:sync_guard``) catches those on the card.
"""

from __future__ import annotations

import ast

from .engine import FileContext, Finding, dotted_name

# file (relpath suffix) -> functions whose bodies run every iteration or
# every pass; nested functions are inside their parent's scope
HOT_SCOPES = {
    "ops/nmf.py": (
        "_masked_loop", "_chunk_h_solve", "_chunk_h_hals_solve",
        "_solve_w_from_stats*", "_batch_loop", "nmf_fit_batch*",
        "nmf_fit_online", "_update_H", "_update_W", "_dna_h_step",
        "_dna_w_step", "_kl_row_obj", "_kl_col_obj", "_hals_sweep",
        "_apply_rate*", "_rel_change", "_sketched_w_update",
        "bundled_beta2_update", "beta_divergence", "_beta_div_dense"),
    "ops/sparse.py": (
        "_wh_at_nz", "_ratio", "_h_numer", "_slab", "_flat", "_cast",
        "_eps_like", "ell_h_numer", "ell_ratio_flat",
        "ell_w_numer_from_ratio", "ell_w_numer", "ell_kl_h_stats",
        "ell_wh_slots", "ell_wh_at_nz", "ell_h_newton",
        "ell_kl_h_newton_stats", "ell_kl_w_numer", "ell_kl_w_stats",
        "ell_take_rows", "ell_kl_w_stats_rows", "_wh_dense", "_is_ratio",
        "ell_is_h_stats", "ell_is_w_stats", "is_per_elem", "kl_nz_term",
        "ell_beta_err_rows", "ell_beta_err_nz", "total_wh",
        "ell_beta_err"),
    "ops/kernels/kl_ell.py": (
        "h_stats", "w_numer", "beta_err_partials", "h_newton_stats",
        "wh_at_nz", "kl_h_stats", "kl_w_numer", "kl_w_stats",
        "kl_w_stats_rows", "kl_beta_err", "kl_h_newton_stats",
        "kl_wh_at_nz", "_on", "_check", "_row_checks"),
    "parallel/rowshard.py": ("_rowsharded_pass",),
    "serving/batcher.py": ("batched_project",),
}

HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
HOST_SYNC_CALLS = {"numpy.asarray", "numpy.array", "numpy.asanyarray",
                   "numpy.ascontiguousarray"}
CAST_BUILTINS = {"float", "int", "bool"}
REDUCTIONS = {"any", "all", "sum", "max", "min", "mean", "prod", "norm",
              "amax", "amin", "count_nonzero", "argmax", "argmin",
              "median", "std", "var", "nansum", "allclose", "equal",
              "vector_norm"}
# receivers whose reductions run on the host
HOST_MODULES = ("numpy", "math", "builtins", "statistics")
SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
SHAPE_METHODS = {"size", "numel", "dim", "stride", "is_contiguous"}

RNG_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
             "torch.rand_like", "torch.randn_like", "torch.randint_like",
             "torch.normal", "torch.bernoulli", "torch.multinomial",
             "torch.poisson"}
RNG_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
             "torch.random.seed", "torch.cuda.manual_seed",
             "torch.cuda.manual_seed_all", "torch.cuda.seed",
             "torch.cuda.seed_all"}
INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                 "bernoulli_", "geometric_", "cauchy_", "log_normal_"}
# numpy.random names that make an explicit generator, not a draw
NP_GENERATORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "PCG64DXSM", "Philox", "SFC64", "MT19937", "BitGenerator",
                 "RandomState"}

SYNC_HINT = ("keep it on the card (torch ops, a lane mask), hoist it out "
             "of the loop, or mark a read the solver means to make with "
             "`with host_read():` (utils/sanitize.py)")
RNG_HINT = ("draw from an explicit torch.Generator (generator=...) or a "
            "np.random.default_rng(seed), seeded from the replicate's "
            "seed")


def _hot_names(relpath: str):
    rel = relpath.replace("\\", "/")
    for suffix, names in HOT_SCOPES.items():
        if rel == suffix or rel.endswith("/" + suffix):
            return names
    return ()


def _matches(name: str, patterns) -> bool:
    return any(name.startswith(p[:-1]) if p.endswith("*") else name == p
               for p in patterns)


def _hot_functions(ctx: FileContext, patterns):
    """The outermost functions of the file that a pattern names (a nested
    function is walked with its parent)."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _matches(node.name, patterns) \
                and not any(a in out for a in ctx.ancestors(node)):
            out.append(node)
    return out


def _static_probe(node: ast.AST) -> bool:
    """``x.shape[0]``, ``x.size(1)``, ``x.numel()``, ``len(xs)``: host
    facts of a tensor, not reads of its values."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in SHAPE_ATTRS:
            return True
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Name) and n.func.id == "len":
                return True
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in SHAPE_METHODS:
                return True
    return False


def _reduction(ctx: FileContext, node: ast.AST) -> str | None:
    """The name of the first tensor reduction called in ``node``: a
    method (``active.any()``) or a ``torch`` function (``torch.any(m)``);
    numpy's and ``math``'s run on the host and do not count."""
    for n in ast.walk(node):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in REDUCTIONS):
            continue
        recv = ctx.imports.resolve(dotted_name(n.func.value)) or ""
        if recv.split(".")[0] in HOST_MODULES:
            continue
        return n.func.attr
    return None


def _is_cpu(node: ast.AST) -> bool:
    """The literal ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return isinstance(node, ast.Call) and bool(node.args) \
        and isinstance(node.args[0], ast.Constant) \
        and node.args[0].value == "cpu"


def _literal(node: ast.AST) -> bool:
    return isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.Dict,
                             ast.Set, ast.ListComp))


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _sync_call(ctx: FileContext, node: ast.Call) -> str | None:
    """Why the call reads the host, or None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in HOST_SYNC_ATTRS:
            recv = ctx.imports.resolve(dotted_name(func.value)) or ""
            if recv.split(".")[0] not in HOST_MODULES:
                return f"`.{func.attr}()` copies to the host"
        if func.attr == "to" and (
                any(_is_cpu(a) for a in node.args)
                or any(kw.arg == "device" and _is_cpu(kw.value)
                       for kw in node.keywords)):
            return "`.to(\"cpu\")` copies to the host"
    resolved = ctx.resolve_call(node)
    if resolved in HOST_SYNC_CALLS and node.args \
            and not _literal(node.args[0]) \
            and not _static_probe(node.args[0]):
        return f"`{resolved}` of a tensor copies it to the host"
    if isinstance(func, ast.Name) and func.id in CAST_BUILTINS \
            and node.args and not _static_probe(node.args[0]):
        red = _reduction(ctx, node.args[0])
        if red is not None:
            return (f"`{func.id}(...)` of a tensor reduction (`.{red}()`) "
                    "reads its value on the host")
    return None


def _rng_call(ctx: FileContext, node: ast.Call) -> str | None:
    resolved = ctx.resolve_call(node) or ""
    if resolved in RNG_DRAWS and not _has_generator(node):
        return f"`{resolved}` without `generator=` draws from global state"
    if resolved in RNG_SEEDS:
        return f"`{resolved}` reseeds global RNG state"
    head, _, leaf = resolved.rpartition(".")
    if head == "random" or (head == "numpy.random"
                            and leaf not in NP_GENERATORS):
        return f"`{resolved}` draws from global RNG state"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in INPLACE_DRAWS and not _has_generator(node):
        return (f"`.{node.func.attr}()` without `generator=` draws from "
                "global state")
    return None


def check(ctx: FileContext):
    patterns = _hot_names(ctx.relpath)
    if not patterns:
        return []
    findings: list[Finding] = []
    seen: set = set()

    def add(node, rule, msg, hint):
        key = (getattr(node, "lineno", 1), rule)
        if key not in seen:
            seen.add(key)
            findings.append(ctx.finding(node, rule, msg, hint))

    for fn in _hot_functions(ctx, patterns):
        where = f" in hot scope `{fn.name}`"
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                why = _rng_call(ctx, node)
                if why is not None:
                    add(node, "rng-global", why + where, RNG_HINT)
                    continue
                why = _sync_call(ctx, node)
                if why is not None and not ctx.in_with(node, "host_read"):
                    add(node, "host-sync", why + where, SYNC_HINT)
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                red = (None if _static_probe(node.test)
                       else _reduction(ctx, node.test))
                if red is not None and not ctx.in_with(node, "host_read"):
                    kw = "while" if isinstance(node, ast.While) else "if"
                    add(node, "host-sync",
                        f"`{kw}` on a tensor reduction (`.{red}()`) reads "
                        f"its value on the host{where}", SYNC_HINT)
    findings.sort(key=lambda f: f.line)
    return findings
