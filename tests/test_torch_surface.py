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

Parameters are held the same way: every parameter of a public JAX
function or method (``__init__`` included) whose counterpart the port
has must be in the counterpart's signature, or have a ``PARAMS_RENAMED``
row (the port's name for it) or a ``PARAMS_NOT_PORTED`` row (why a user
of the port sees no difference, and the ``ROADMAP.md`` item). A row that
names nothing fails, and so does a reason of 20 characters or fewer.

Every ``NOT_PORTED`` and ``PARAMS_NOT_PORTED`` row cites "Not to port" or
departures that ``ROADMAP.md`` lists, never an open queue item. Each file
of the JAX repo's ``scripts/`` has a ``SCRIPTS`` row: the port module or
the ``chip_smoke.py`` phases that do its job on the card (each phase named
in that script's docstring), or its "Not to port" reason.
"""

import ast
import os
import re

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


# "func.jax_param" -> (the port's parameter, why the name differs)
_DEVICE_NOT_MESH = ("a device or the port's Mesh (parallel/mesh.py) names "
                    "where the rows go; JAX names a jax Mesh")
_TRACE_LIST = ("the solver's SolverTelemetry goes into the caller's trace "
               "list instead of being returned when a flag is set")
_BF16 = ("the bf16 ratio chain's switch, one short name across the port's "
         "ELL statistics and kernel wrappers")
_SEED = ("an integer seed of a CPU torch.Generator stands for the threefry "
         "key: torch has no key objects")
PARAMS_RENAMED = {
    "EllMatrix.astype.dtype": (
        "vals", "the port re-values an encoding with the cast values "
        "themselves: ell.with_vals(ell.vals.to(dtype))"),
    "atomic_artifact.filename": (
        "path", "the port's atomic writer (utils/io.py) takes a path of "
        "any kind, not only an artifact's file name"),
    "check_knob_docs.readme_path": (
        "doc_path", "the port's knob table lives in "
        "cnmf_torch_tpu_torch/KNOBS.md, not in the README"),
    "chip_peaks.device_kind": (
        "device_name", "a card is named by torch.cuda.get_device_name, "
        "where JAX reads a TPU's device_kind"),
    "ell_device_put.x": (
        "self", "ell_device_put is the method EllMatrix.to in the port; "
        "the encoding is its receiver"),
    "ell_device_put.sharding": ("device", _DEVICE_NOT_MESH),
    "measure_collectives.Xd": (
        "gx", "the staged grid is a GridX of tiles (stage_x_grid), not a "
        "sharded jax.Array"),
    "normalize_total.adata": (
        "X", "the port normalizes the count matrix itself and returns the "
        "matrix; a Counts is not needed to carry it"),
    "plan_degraded_mesh.lost_devices": (
        "lost_ids", "the port's mesh entries are ids into Mesh.devices, "
        "since one card may stand at several entries"),
    "prepare_rowsharded.mesh": ("device", _DEVICE_NOT_MESH),
    "stream_rows_to_mesh.mesh": ("device", _DEVICE_NOT_MESH),
    "stream_ell_to_mesh.mesh": ("device", _DEVICE_NOT_MESH),
    "stream_put_leaves.shardings": (
        "device", "one controller copies every leaf to the one device it "
        "names (D10); a sharding per leaf has nothing to choose"),
    "stream_store_sharded.sharding": ("device", _DEVICE_NOT_MESH),
    "write_h5ad.adata": (
        "counts", "h5ad output writes the port's Counts "
        "(utils/anndata_lite.py), its stand-in for AnnDataLite"),
    "nmf_fit_batch.telemetry": ("trace", _TRACE_LIST),
    "nmf_fit_batch_bundled.telemetry": ("trace", _TRACE_LIST),
    "nmf_fit_batch_hals.telemetry": ("trace", _TRACE_LIST),
    "nmf_fit_online.telemetry": ("trace", _TRACE_LIST),
    "ell_is_h_stats.bf16_ratio": ("bf16", _BF16),
    "ell_is_w_stats.bf16_ratio": ("bf16", _BF16),
    "ell_kl_h_stats.bf16_ratio": ("bf16", _BF16),
    "ell_kl_w_numer.bf16_ratio": ("bf16", _BF16),
    "ell_kl_w_stats.bf16_ratio": ("bf16", _BF16),
    "pallas_kl_h_stats.bf16_ratio": ("bf16", _BF16),
    "pallas_kl_w_numer.bf16_ratio": ("bf16", _BF16),
    "pallas_kl_w_stats.bf16_ratio": ("bf16", _BF16),
    "fit_h_default_init.key": ("seed", _SEED),
    "init_factors.key": ("seed", _SEED),
    "nndsvd_init.key": ("seed", _SEED),
    "nndsvd_init_gram.key": ("seed", _SEED),
    "random_init.key": ("seed", _SEED),
}

# "func.param" -> (why a user of the port sees no difference, ROADMAP item)
_STATIC = ("pads to a static width so one compiled XLA program serves every "
           "K; torch compiles nothing and the results are the unpadded "
           "call's", "Not to port")
_NO_PALLAS = ("the Pallas switch: the port has no degrade path, its ELL "
              "statistics launch the CUDA kernels whenever the tensors are "
              "on a card", "D16")
_W_TABLE = ("a pre-gathered W slab table JAX hoists out of its loops; the "
            "CUDA kernels gather W into shared memory themselves and the "
            "statistics are the same", "Not to port")
_INTERPRET = ("runs the Pallas kernel in interpret mode on the CPU; the "
              "port's wrappers take the plain version for a CPU tensor",
              "Not to port")
_AXIS = ("the name of the jax Mesh axis the rows shard over; the port's "
         "row-sharded staging always uses the cells axis of its Mesh",
         "Not to port")
_F32 = ("the element type of the staged or drawn matrix; the port stages "
        "and draws f32 only, as its kernels and solvers take f32, and no "
        "caller in the JAX package asks for another type", "Not to port")
_REFIT_KEY = ("no caller in the JAX package passes a key, so its usage refit "
              "starts from the fixed key 0's draw, as the port's does "
              "(fit_h_default_init, seed 0); another start goes in through "
              "H_init", "Not to port")
_FETCH = ("fetch=False leaves the results as unfetched jax Arrays so JAX's "
          "factorize overlaps the next dispatch with the host copy; torch "
          "runs eagerly, so the port's sweep returns numpy once its work "
          "is done", "Not to port")
PARAMS_NOT_PORTED = {
    "fit_h.key": _REFIT_KEY,
    "fit_h_slabbed.key": _REFIT_KEY,
    "random_init.dtype": _F32,
    "stream_rows_to_mesh.dtype": _F32,
    "stage_x_grid.dtype": _F32,
    "stage_x_2d.dtype": _F32,
    "stream_ell_to_mesh.pad_multiple": (
        "pads rows to a multiple for XLA's static shard shapes; no caller "
        "in the JAX package passes it, so its rows pad to the shard count, "
        "as the port's do", "Not to port"),
    "ell_device_put.stats": (
        "timings of the four leaf uploads; no caller in the JAX package "
        "passes it, and the port's ELL staging records its copies in "
        "stream_ell_to_mesh's stats", "Not to port"),
    "SolverRecipe.signature.kernel": (
        "only JAX's planner passes it, and only when the Pallas kernels "
        "engage (runtime/planner.py); the port has no such switch and its "
        "kernel label is fixed by the device", "D16"),
    "replicate_sweep_packed.telemetry_sink": (
        "JAX's packed sweep emits its replicate telemetry there; in the "
        "port the packed adapter has no caller, and factorize runs the "
        "per-K sweeps, whose replicate_sweep takes the sink", "D12"),
    "replicate_sweep.fetch": _FETCH,
    "replicate_sweep_2d.fetch": _FETCH,
    "replicate_sweep_packed.fetch": _FETCH,
    "auto_replicates_per_batch.n_dev": (
        "JAX rounds a slice to a multiple of its mesh size; the port's "
        "sweep slices each device's replicates by that device's own "
        "budget, one device after another (D10)", "D10"),
    "cNMF.refit_usage.k_pad": _STATIC,
    "fit_h.k_pad": _STATIC,
    "kmeans.k_pad": _STATIC,
    "kmeans.n_rows": _STATIC,
    "kmeans.mask": (
        "clusters the masked rows at the full array's static shape so a "
        "density sweep compiles once; the port clusters X[mask] itself, "
        "as JAX's own callers read only the masked rows' labels",
        "Not to port"),
    "silhouette_score.k_pad": _STATIC,
    "silhouette_score.n_rows": _STATIC,
    "beta_divergence.use_pallas": _NO_PALLAS,
    "kernel_label.use_pallas": _NO_PALLAS,
    "nmf_fit_batch.use_pallas": _NO_PALLAS,
    "nmf_fit_online.use_pallas": _NO_PALLAS,
    "ell_is_h_stats.w_table": _W_TABLE,
    "ell_kl_h_newton_stats.w_table": _W_TABLE,
    "ell_kl_h_stats.w_table": _W_TABLE,
    "ell_kl_w_numer.w_table": _W_TABLE,
    "ell_kl_w_stats.w_table": _W_TABLE,
    "ell_wh_at_nz.w_table": _W_TABLE,
    "pallas_kl_beta_err.interpret": _INTERPRET,
    "pallas_kl_h_newton_stats.interpret": _INTERPRET,
    "pallas_kl_h_stats.interpret": _INTERPRET,
    "pallas_kl_w_numer.interpret": _INTERPRET,
    "pallas_kl_w_stats.interpret": _INTERPRET,
    "pallas_wh_at_nz.interpret": _INTERPRET,
    "stream_rows_to_mesh.axis": _AXIS,
    "stream_ell_to_mesh.axis": _AXIS,
    "measure_collectives.mesh": (
        "the port's GridX carries the mesh it was staged on, so a second "
        "argument could only disagree with it", "Not to port"),
    "normalize_total.inplace": (
        "the port takes and returns the matrix, so there is no object to "
        "update; counts.X = normalize_total(counts.X) is the in-place form",
        "Not to port"),
}


# a file of the JAX repo's scripts/ -> (the port module that does its job,
# the chip_smoke.py phases that run it on the card, what they cover), or
# (None, (), a "Not to port" reason)
SCRIPTS = {
    "accel_smoke.py": (None, ("3", "4", "6"),
                       "the recipes on the card: mu online, dna in batch, "
                       "HALS and amu"),
    "chaos_smoke.py": (None, ("7a", "7b", "7c", "9c", "11e"),
                       "retry, quarantine, torn artifacts, a SIGKILLed "
                       "factorize resumed, a host loss"),
    "fleet_smoke.py": (None, ("12c",),
                       "the fleet: a replica's death, a rollover, a poison "
                       "tenant"),
    "lint_gate.py": ("cnmf_torch_tpu_torch.analysis.gate", ("15a",),
                     "the lint gate over the port"),
    "netstore_smoke.py": (None, ("10a", "10b", "10c"),
                          "the remote store and its four network faults"),
    "obs_smoke.py": (None, ("8", "12a"),
                     "events, metrics, spans and report on the main path; "
                     "the serving events"),
    "ooc_smoke.py": (None, ("9a", "9c"),
                     "the store pair (in memory and store-only) and the "
                     "slab-looped tier"),
    "pallas_smoke.py": (None, ("2", "3"),
                        "each kernel against its plain version, and the "
                        "kernels on the main path"),
    "perf_gate.py": ("cnmf_torch_tpu_torch.obs.perf_gate", ("15c",),
                     "the perf gate as a user runs it, and its baseline "
                     "leg"),
    "plan_smoke.py": (None, ("13c",),
                      "one plan event, its dump and a byte-for-byte "
                      "replay"),
    "serve_smoke.py": (None, ("12a",),
                       "the daemon, batching, solo parity and a poison "
                       "tenant"),
    "sketch_smoke.py": (None, ("7g",),
                        "the sketch recipe in batch and online, and "
                        "sketched consensus"),
    "telemetry_smoke.py": (None, ("8",),
                           "every event of the main path valid, report "
                           "rendered"),
    "verify_tier1.sh": (None, (), (
        "Not to port: JAX's tier-1 driver (its pytest line, then each "
        "script above); the port's tests run under the same pytest line "
        "and chip_smoke.py runs the scripts' jobs in one process on the "
        "card")),
}
# scripts the port added to scripts/ for itself
PORT_SCRIPTS = {"beta_err_probe.py", "multicard_check.py"}


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


def _params(node) -> list:
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def signatures(path: str) -> dict:
    """``{name: [parameter lists]}`` of every public top-level function
    and every public method (and ``__init__``) of a public class, named
    as :func:`public_names` names them; a name defined in several files
    has one list a definition."""
    out: dict = {}
    for d, _, names in os.walk(path):
        if "__pycache__" in d:
            continue
        for f in sorted(names):
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f)) as fh:
                tree = ast.parse(fh.read())
            for node in _module_body(tree.body):
                if getattr(node, "name", "_").startswith("_"):
                    continue
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    out.setdefault(node.name, []).append(_params(node))
                elif isinstance(node, ast.ClassDef):
                    for m in _module_body(node.body):
                        if (isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                                and (m.name == "__init__"
                                     or not m.name.startswith("_"))):
                            out.setdefault(f"{node.name}.{m.name}",
                                           []).append(_params(m))
    return out


@pytest.fixture(scope="module")
def surfaces():
    return public_names(JAX_PKG), public_names(PORT_PKG)


@pytest.fixture(scope="module")
def params():
    """``(jax, port)``: ``{function name: set of parameters}``, the
    parameters of every definition of the name together."""
    return tuple({name: set().union(*map(set, lists))
                  for name, lists in signatures(pkg).items()}
                 for pkg in (JAX_PKG, PORT_PKG))


def _split(row: str):
    """``"func.param"`` as ``(func, param)`` (func may be Class.method)."""
    func, _, param = row.rpartition(".")
    return func, param


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


def test_every_jax_parameter_is_ported_or_has_a_row(params):
    jax, port = params
    missing = []
    for name, jparams in sorted(jax.items()):
        pname = RENAMED.get(name, name)
        if pname not in port:
            continue
        for p in sorted(jparams - {"self", "cls"}):
            row = f"{name}.{p}"
            if (p not in port[pname] and row not in PARAMS_RENAMED
                    and row not in PARAMS_NOT_PORTED):
                missing.append(f"{row} (port: {pname})")
    assert not missing, ("JAX parameters the port's counterpart lacks, with "
                         "no PARAMS_RENAMED or PARAMS_NOT_PORTED row: "
                         + "; ".join(missing))


def test_every_parameter_row_names_something(params):
    jax, port = params
    bad = []
    for row, (new, reason) in PARAMS_RENAMED.items():
        func, p = _split(row)
        pfunc = RENAMED.get(func, func)
        if (func not in jax or p not in jax[func] or pfunc not in port
                or new not in port[pfunc] or p in port[pfunc]):
            bad.append(f"{row} -> {new}")
        if len(reason) <= 20:
            bad.append(f"{row}: reason too short")
    for row, (reason, item) in PARAMS_NOT_PORTED.items():
        func, p = _split(row)
        pfunc = RENAMED.get(func, func)
        if (func not in jax or p not in jax[func] or pfunc not in port
                or p in port[pfunc]):
            bad.append(row)
        if len(reason) <= 20 or not item:
            bad.append(f"{row}: reason too short or no ROADMAP item")
    both = sorted(set(PARAMS_RENAMED) & set(PARAMS_NOT_PORTED))
    assert not bad and not both, (bad, both)


@pytest.mark.parametrize("name, param", [
    ("run_pipeline", "liveness"), ("stream_store_sharded", "liveness"),
    ("stream_rows_to_mesh", "liveness"), ("stream_ell_to_mesh", "liveness"),
    ("prepare_rowsharded", "liveness"), ("stage_x_grid", "liveness"),
    ("stage_x_2d", "liveness"), ("local_density", "D"),
    ("silhouette_score", "D"), ("ols_all_cols", "precision"),
    ("row_sums", "block_rows"), ("column_mean_var", "block_rows"),
    ("column_moments_staged", "block_rows"),
    ("nmf_fit_batch", "update_W_flag")])
def test_the_parameters_that_carry_behaviour_are_ported(params, name, param):
    jax, port = params
    assert param in jax[name]
    assert param in port[RENAMED.get(name, name)]


def _departures() -> set:
    """The departures ``ROADMAP.md`` lists (``- **D<n>**`` bullets)."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        return set(re.findall(r"^- \*\*(D\d+)\*\*", f.read(), re.M))


@pytest.mark.parametrize("table", ["NOT_PORTED", "PARAMS_NOT_PORTED"])
def test_every_row_cites_a_reason_of_record(table):
    """"Not to port" or departures ROADMAP.md lists; no open item (a
    queue entry such as A1, or "Order of work")."""
    departures = _departures()
    assert {"D5", "D10", "D12", "D16"} <= departures
    bad = []
    for name, (_, item) in globals()[table].items():
        if item == "Not to port":
            continue
        cited = [c.strip() for c in item.split(",")]
        if not all(re.fullmatch(r"D\d+", c) and c in departures
                   for c in cited):
            bad.append(f"{name}: {item}")
    assert not bad, f"rows citing no departure of record: {bad}"


def test_every_jax_script_has_a_row():
    files = set(os.listdir(os.path.join(ROOT, "scripts"))) - {"__pycache__"}
    assert PORT_SCRIPTS <= files
    assert set(SCRIPTS) == files - PORT_SCRIPTS, sorted(
        set(SCRIPTS) ^ (files - PORT_SCRIPTS))


def _smoke_phases() -> dict:
    """``chip_smoke.py``'s docstring as ``{phase number: its text}``."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        doc = ast.get_docstring(ast.parse(f.read()))
    parts = re.split(r"^(\d+)\. ", doc, flags=re.M)
    return {num: text for num, text in zip(parts[1::2], parts[2::2])}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_each_script_names_where_the_port_does_its_job(script):
    module, phases, what = SCRIPTS[script]
    if module is None and not phases:
        assert what.startswith("Not to port: ") and len(what) > 40
        return
    assert len(what) > 20
    if module is not None:
        path = os.path.join(ROOT, *module.split(".")) + ".py"
        assert os.path.isfile(path), module
    doc = _smoke_phases()
    for phase in phases:
        num, sub = re.fullmatch(r"(\d+)([a-z]?)", phase).groups()
        assert num in doc, f"chip_smoke.py has no phase {num}"
        if sub:
            assert f"({sub})" in doc[num], f"phase {num} has no ({sub})"
