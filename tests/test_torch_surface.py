"""The port's public surface against the JAX package's.

Both packages are parsed with ``ast``; neither is imported. Every public
top-level function and class of ``cnmf_torch_tpu/``, and every public
method and class attribute of such a class, must have a counterpart in
``cnmf_torch_tpu_torch/``: the same name, or the one ``RENAMED`` gives.
A name with neither needs a ``NOT_PORTED`` row with its reason and the
``ROADMAP.md`` item that records it. A new public JAX name with neither
fails here, and so does a row whose name no longer exists on its side.
The same holds for the tutorials, ``examples/*.py`` against
``cnmf_torch_tpu_torch/examples/*.py``.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "cnmf_torch_tpu")
PORT_PKG = os.path.join(ROOT, "cnmf_torch_tpu_torch")

# JAX name -> the port's name for the same thing
RENAMED = {
    # h5ad I/O carries the port's Counts (utils/io.py), not an AnnData
    "AnnDataLite": "Counts",
    "AnnDataLite.copy": "Counts.take",
    "AnnDataLite.n_obs": "Counts.shape",
    "AnnDataLite.n_vars": "Counts.shape",
    "AnnDataLite.shape": "Counts.shape",
    "AnnDataLite.obs_names": "Counts.obs_names",
    "AnnDataLite.var_names": "Counts.var_names",
    "AnnDataLite.var_names_make_unique": "var_names_make_unique",
    "AnnDataLite.write": "write_h5ad",
    # the ELL buffers are torch or numpy leaves of a dataclass
    "EllMatrix.astype": "EllMatrix.with_vals",
    "EllMatrix.dtype": "EllMatrix.vals",
    "ell_device_put": "EllMatrix.to",
    # staging: one controller stages each shard in turn (D10)
    "stream_put_leaves": "put_arrays",
    "stream_store_sharded": "stream_store",
    # the five Pallas kernels' wrappers are the CUDA kernels' wrappers
    # (ops/kernels/kl_ell.py over csrc/kl_ell.cu)
    "pallas_kl_h_stats": "kl_h_stats",
    "pallas_kl_w_numer": "kl_w_numer",
    "pallas_kl_w_stats": "kl_w_stats",
    "pallas_kl_beta_err": "kl_beta_err",
    "pallas_kl_h_newton_stats": "kl_h_newton_stats",
    "pallas_wh_at_nz": "kl_wh_at_nz",
}

# JAX name -> (why the port has no counterpart, the ROADMAP item)
_JAX_COMPAT = ("JAX's own compatibility shims (utils/jax_compat.py): torch "
               "has no threefry partitioning, no forced CPU device count "
               "and no shard_map", "Not to port")
_XLA_WARM = ("warms or caches compiled XLA programs; torch compiles "
             "nothing ahead of a call", "Not to port")
_PALLAS = ("Pallas availability, interpret and cost helpers "
           "(ops/pallas/__init__.py); the CUDA kernels have no interpret "
           "mode and no degrade path", "Not to port")
NOT_PORTED = {
    "assert_threefry_partitionable": _JAX_COMPAT,
    "default_threefry_partitionable": _JAX_COMPAT,
    "force_cpu_devices": _JAX_COMPAT,
    "shard_map": _JAX_COMPAT,
    "enable_persistent_compilation_cache": (
        "XLA's persistent compile cache (CNMF_TPU_COMPILE_CACHE)",
        "Not to port"),
    "clear_sweep_cache": _XLA_WARM,
    "run_warm_jobs": _XLA_WARM,
    "warm_sweep_programs": _XLA_WARM,
    "pallas_available": _PALLAS,
    "pallas_interpret": _PALLAS,
    "pallas_stats_cost": _PALLAS,
    "resolve_pallas": _PALLAS,
    "xla_cost": ("XLA's compiled cost analysis; torch reports no bytes, so "
                 "the port's cost formulas are held to JAX's exactly",
                 "Not to port"),
    "EllMatrix.tree_flatten": ("JAX pytree registration; a torch "
                               "dataclass needs none", "Not to port"),
    "EllMatrix.tree_unflatten": ("JAX pytree registration; a torch "
                                 "dataclass needs none", "Not to port"),
    "ExecutionPlan.use_pallas": ("the plan has no Pallas switch: there is "
                                 "no degrade path from a kernel", "D16"),
    "ExecutionPlan.stream_transport": ("one transport, CSR slabs through "
                                       "pinned pieces", "D5, D16"),
    "gate_n": ("the perf gate's sample count (CNMF_TPU_PERF_GATE_N) comes "
               "with the port's benchmark", "D9"),
    "host_rss_peak_bytes": ("only bench.py reads it; it comes with the "
                            "port's benchmark", "Order of work, item 3"),
    "SolverRecipe.is_identity": (
        "JAX reads it only to key its compiled-program cache "
        "(parallel/replicates.py:432); the port compiles no program",
        "Not to port"),
    "ReplicateGuard.record_torn": (
        "nothing in the JAX package calls it; the port's combine emits "
        "the same torn_artifact fault event itself", "Not to port"),
    "ell_to_dense": ("only the JAX tests call it; the port's tests hold "
                     "the ELL statistics against the CSR source",
                     "Not to port"),
    "ell_w_table": ("the pre-gathered W slab table lives in the CUDA "
                    "kernels' shared memory; the plain statistics gather "
                    "a call", "Not to port"),
}


def _module_body(nodes):
    """Statements at module (or class) level, through ``if``/``try``."""
    for node in nodes:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _module_body(node.body)
            yield from _module_body(node.orelse)
            for handler in getattr(node, "handlers", []):
                yield from _module_body(handler.body)
            yield from _module_body(getattr(node, "finalbody", []))
        else:
            yield node


def _members(cls: ast.ClassDef):
    for node in _module_body(cls.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name
        elif isinstance(node, ast.Assign):
            yield from (t.id for t in node.targets
                        if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            yield node.target.id


def public_names(path: str) -> dict:
    """``{name: {files}}`` of the public top-level functions and classes of
    every ``.py`` under ``path`` (a file or a directory), and
    ``Class.member`` for each public method or class attribute."""
    files = [path] if path.endswith(".py") else sorted(
        os.path.join(d, f) for d, dirs, names in os.walk(path)
        for f in names if f.endswith(".py") and "__pycache__" not in d)
    out: dict = {}
    for fn in files:
        rel = os.path.relpath(fn, ROOT)
        with open(fn) as f:
            tree = ast.parse(f.read(), filename=fn)
        for node in _module_body(tree.body):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            if node.name.startswith("_"):
                continue
            out.setdefault(node.name, set()).add(rel)
            if isinstance(node, ast.ClassDef):
                for m in _members(node):
                    if not m.startswith("_"):
                        out.setdefault(f"{node.name}.{m}", set()).add(rel)
    return out


@pytest.fixture(scope="module")
def surfaces():
    return public_names(JAX_PKG), public_names(PORT_PKG)


def test_every_public_jax_name_has_a_counterpart(surfaces):
    jax, port = surfaces
    missing = sorted(
        f"{name} ({', '.join(sorted(jax[name]))})" for name in jax
        if name not in port and RENAMED.get(name) not in port
        and name not in NOT_PORTED)
    assert not missing, ("public JAX names without a port counterpart, a "
                         "RENAMED entry or a NOT_PORTED row: "
                         + "; ".join(missing))


def test_every_renamed_row_names_both_sides(surfaces):
    jax, port = surfaces
    stale = sorted(f"{a} -> {b}" for a, b in RENAMED.items()
                   if a not in jax or b not in port)
    assert not stale, f"RENAMED rows naming nothing: {stale}"
    same = sorted(a for a in RENAMED if a in port)
    assert not same, f"RENAMED rows for names the port has itself: {same}"


def test_every_not_ported_row_is_live_and_has_a_reason(surfaces):
    jax, port = surfaces
    gone = sorted(name for name in NOT_PORTED if name not in jax)
    assert not gone, f"NOT_PORTED rows for names JAX no longer has: {gone}"
    ported = sorted(name for name in NOT_PORTED if name in port)
    assert not ported, f"NOT_PORTED rows for names the port has: {ported}"
    both = sorted(set(NOT_PORTED) & set(RENAMED))
    assert not both, f"rows both renamed and not ported: {both}"
    for name, (reason, item) in NOT_PORTED.items():
        assert len(reason) > 20 and item, name


def test_the_walk_sees_both_packages(surfaces):
    jax, port = surfaces
    assert len(jax) > 500 and len(port) > 500
    for name in ("cNMF", "cNMF.consensus", "compute_tpm",
                 "StreamStats.record_to", "scale_hvg_columns_device",
                 "Counts.obs_names", "ExecutionPlan.kernel"):
        assert name in port, name
    assert port["compute_tpm"] == {"cnmf_torch_tpu_torch/models/cnmf.py"}
    assert port["StreamStats.record_to"] == {
        "cnmf_torch_tpu_torch/parallel/streaming.py"}


@pytest.mark.parametrize("tutorial", [
    "simulated_tutorial", "pbmc_tutorial", "batch_correction_tutorial",
    "seurat_vignette"])
def test_every_tutorial_has_its_counterpart(tutorial):
    jax = public_names(os.path.join(ROOT, "examples", tutorial + ".py"))
    port = public_names(os.path.join(PORT_PKG, "examples", tutorial + ".py"))
    assert "main" in jax
    assert set(jax) <= set(port), sorted(set(jax) - set(port))
