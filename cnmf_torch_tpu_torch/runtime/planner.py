"""The execution planner: one object that holds a factorize's dispatch.

Own copy of the JAX package's ``cnmf_torch_tpu/runtime/planner.py`` for the
port:

* :class:`ExecutionPlan`, the resolved dispatch as one flat JSON-able
  dataclass, with ``sources`` recording per field group who decided it:
  ``pin`` (an explicit knob or caller argument), ``autotuned`` (a measured
  point of ``utils/autotune.py``) or ``heuristic`` (the static default), in
  that order of precedence;
* :func:`build_plan`, one call per factorize, from :class:`InputStats` and
  :class:`DeviceInventory`. It calls the resolvers the dispatch sites
  call (``ops/sparse.py:resolve_sparse_beta``, ``ops/recipe.py:
  resolve_recipe``, ``ops/nmf.py:resolve_bf16_ratio``,
  ``ops/kernels:kernel_label``, ``parallel/replicates.py:_auto_packed``,
  ``parallel/streaming.py:stream_threads``/``stream_depth``, the grid's,
  ``serving/batcher.py:resolve_buckets``), so the plan is the dispatch
  and not a second copy of it;
* :func:`apply_plan`, which pins the dispatch knobs to a plan's values, so
  ``factorize --plan p.json`` (or ``CNMF_TPU_PLAN=p.json``) reproduces a
  run's dispatch and its files bit for bit, and :func:`render_plan` for
  the report and the CLI's ``plan``.

The port's plan drops the JAX fields ``use_pallas`` and
``stream_transport`` (the port has no degrade path from a kernel to its
plain version, and one slab transport); ``kernel`` carries the port's label
(``ell-cuda``, ``ell-torch``, ``dense-bf16`` or ``dense``). A JAX plan JSON
is refused with the fields that do not belong named.

Import-light: torch and the resolvers are imported inside the functions,
so the CLI's ``plan`` renders a run's plan without touching a device.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field, fields

__all__ = [
    "PLAN_VERSION", "PLAN_ENV", "DISPATCH_KNOBS", "PLAN_ACCESSORS",
    "PLAN_OWNER_FILES",
    "KERNEL_LABELS", "InputStats", "DeviceInventory", "ExecutionPlan",
    "build_plan", "resolve_encoding", "apply_plan", "load_plan",
    "maybe_apply_plan_env", "render_plan", "plan_from_run_dir",
]

PLAN_VERSION = 1
PLAN_ENV = "CNMF_TPU_PLAN"

# the knobs that pick which program runs (the JAX package's set without
# CNMF_TPU_PALLAS and CNMF_TPU_STREAM_TRANSPORT, which the port lacks)
DISPATCH_KNOBS = frozenset({
    "CNMF_TPU_SPARSE_BETA",
    "CNMF_TPU_ACCEL",
    "CNMF_TPU_INNER_REPEATS",
    "CNMF_TPU_KL_NEWTON",
    "CNMF_TPU_SKETCH",
    "CNMF_TPU_SKETCH_DIM",
    "CNMF_TPU_SKETCH_EXACT_EVERY",
    "CNMF_TPU_BF16_RATIO",
    "CNMF_TPU_STREAM_THREADS",
    "CNMF_TPU_STREAM_DEPTH",
    "CNMF_TPU_GRID_BLOCKS",
    "CNMF_TPU_GRID_SHAPE",
    "CNMF_TPU_GRID_OVERLAP",
    "CNMF_TPU_OOC",
    "CNMF_TPU_SERVE_BUCKETS",
    "CNMF_TPU_STORE_URI",
    "CNMF_TPU_PLAN",
    "CNMF_TPU_AUTOTUNE",
})

# the resolver functions: outside PLAN_OWNER_FILES, the only code that
# may read a DISPATCH_KNOBS name (the lint's knob-plan-bypass rule), one
# resolution site a knob, which the dispatch sites and build_plan call
# (the JAX package's set without resolve_pallas and _csr_transport)
PLAN_ACCESSORS = frozenset({
    "resolve_sparse_beta",       # ops/sparse.py          (encoding)
    "resolve_recipe",            # ops/recipe.py          (solver recipe)
    "resolve_consensus_sketch",  # ops/sketch.py          (consensus lane)
    "resolve_bf16_ratio",        # ops/nmf.py             (kernel band)
    "stream_threads",            # parallel/streaming.py
    "stream_depth",              # parallel/streaming.py
    "grid_overlap_enabled",      # parallel/grid2d.py
    "grid_blocks",               # parallel/grid2d.py
    "_grid_rc",                  # parallel/grid2d.py
    "ooc_mode",                  # utils/shardstore.py
    "resolve_backend",           # utils/storebackend.py
    "resolve_buckets",           # serving/batcher.py
})

# files that own dispatch-knob resolution outright (relpath suffixes)
PLAN_OWNER_FILES = (
    "runtime/planner.py",
    "utils/autotune.py",
    "utils/envknobs.py",
)

# ops/kernels:kernel_label's labels
KERNEL_LABELS = ("ell-cuda", "ell-torch", "dense-bf16", "dense")

# JAX plan fields the port's plan drops
_JAX_ONLY_FIELDS = ("use_pallas", "stream_transport")


@dataclass(frozen=True)
class InputStats:
    """The matrix and ledger facts a plan is a function of: equal stats
    (and equal knobs and autotune cache) build equal plans."""

    n: int
    g: int
    beta: float = 1.0
    mode: str = "online"
    init: str = "random"
    algo: str = "mu"
    sparse: bool = False
    density: float | None = None
    ell_width: int | None = None
    k_max: int | None = None
    n_ks: int = 1
    max_replicates: int = 1
    total_workers: int = 1
    has_store: bool = False


@dataclass(frozen=True)
class DeviceInventory:
    """The hardware facts: backend (``cuda`` or ``cpu``), the device's
    name with spaces made ``_``, the card and process counts."""

    backend: str = "cpu"
    device_kind: str = "unknown"
    n_devices: int = 1
    n_processes: int = 1
    cpu_count: int = 1

    @classmethod
    def probe(cls, device="cuda") -> "DeviceInventory":
        """The inventory of ``device``, the one the run uses: a card reads
        ``torch.cuda``; ``"cpu"`` reports the CPU."""
        import torch

        from ..parallel.mesh import process_count

        dev = torch.device(device)
        if dev.type == "cuda":
            kind = torch.cuda.get_device_name(dev)
            backend, n_dev = "cuda", torch.cuda.device_count()
        else:
            kind, backend, n_dev = "cpu", "cpu", 1
        return cls(backend=backend, device_kind=kind.replace(" ", "_"),
                   n_devices=int(n_dev), n_processes=int(process_count()),
                   cpu_count=os.cpu_count() or 1)


@dataclass
class ExecutionPlan:
    """The resolved dispatch of one factorize. ``sources`` maps field
    groups to ``pin`` | ``autotuned`` | ``heuristic``."""

    plan_version: int = PLAN_VERSION
    package_version: str = ""
    fingerprint: str = ""
    beta: float = 1.0
    mode: str = "online"
    # encoding
    use_ell: bool = False
    density: float | None = None
    density_threshold: float | None = None
    ell_width: int | None = None
    # solver recipe
    recipe_algo: str = "mu"
    inner_repeats: int = 1
    kl_newton: bool = False
    sketch_dim: int = 0
    sketch_exact_every: int = 1
    recipe_label: str = "mu"
    # kernel
    bf16_ratio: bool = False
    kernel: str = "dense"
    # program shape + layout
    packed: bool = False
    layout: str = "1d"
    mesh_devices: int = 1
    grid_shape: list | None = None
    grid_blocks: int | None = None
    grid_overlap: bool | None = None
    # streaming
    stream_threads: int = 1
    stream_depth: int = 3
    # ingest tier + store backend
    ooc_engaged: bool = False
    store_backend: str = "local"
    # serve schedule
    serve_buckets: list = field(default_factory=list)
    # provenance: field group -> "pin" | "autotuned" | "heuristic"
    sources: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        if int(d.get("plan_version", 0)) != PLAN_VERSION:
            raise ValueError(
                f"plan_version={d.get('plan_version')!r}: this build "
                f"understands {PLAN_VERSION}")
        unknown = set(d) - {f.name for f in fields(cls)}
        if unknown:
            jax = sorted(unknown & set(_JAX_ONLY_FIELDS))
            hint = (f" ({', '.join(jax)}: a plan of the JAX package; the "
                    "port's plans drop these fields)" if jax else "")
            raise ValueError(f"unknown plan fields {sorted(unknown)}{hint}")
        if d.get("kernel", "dense") not in KERNEL_LABELS:
            raise ValueError(
                f"kernel={d.get('kernel')!r}: the port's kernel labels are "
                f"{', '.join(KERNEL_LABELS)}")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        from ..utils.io import atomic_artifact

        with atomic_artifact(path) as tmp:
            with open(tmp, "w") as f:
                f.write(self.to_json() + "\n")

    def signature(self) -> str:
        """A stable digest of the dispatch fields: ``sources``, the
        measured ``density`` and the ``density_threshold`` that decided
        ``use_ell`` are left out, so two runs that dispatch alike share it,
        pinned or autotuned (a replay pins the lane itself, and the JAX
        package's digest, which keeps the threshold, differs between an
        autotuned run and its replay)."""
        d = self.to_dict()
        for key in ("sources", "density", "density_threshold"):
            d.pop(key, None)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def identity_fragment(self) -> str:
        """The math-affecting fragment (recipe, kernel, encoding) a pass
        checkpoint's identity would carry; a layout or streaming change
        leaves it alone. The kernel label is named only where the CUDA
        kernels run, as the JAX package names only its fused kernels."""
        rec = self.solver_recipe()
        kern = f",kernel={self.kernel}" if self.kernel == "ell-cuda" else ""
        return (rec.signature() + kern
                + f",enc={'ell' if self.use_ell else 'dense'}")

    def solver_recipe(self):
        """The :class:`~..ops.recipe.SolverRecipe` this plan resolved: the
        resolver's own object (its ``source`` the knob's) for a plan that
        :func:`build_plan` made, else rebuilt from the fields."""
        from ..ops.recipe import SolverRecipe

        resolved = getattr(self, "_resolved_recipe", None)
        if resolved is not None:
            return resolved
        return SolverRecipe(
            self.recipe_algo, int(self.inner_repeats),
            bool(self.kl_newton), self.sources.get("recipe", "heuristic"),
            sketch_dim=int(self.sketch_dim),
            sketch_exact_every=int(self.sketch_exact_every))

    def cost_inputs(self) -> dict:
        """The lane and layout inputs of the cost model
        (``obs/costmodel.py:plan_cost``), beyond the problem shape."""
        return {
            "beta": float(self.beta),
            "kernel": str(self.kernel),
            "use_ell": bool(self.use_ell),
            "bf16_ratio": bool(self.bf16_ratio),
            "packed": bool(self.packed),
            "layout": str(self.layout),
            "ell_width": (int(self.ell_width)
                          if self.ell_width is not None else None),
            "density": (float(self.density)
                        if self.density is not None else None),
            "mesh_devices": int(self.mesh_devices),
            "grid_shape": (list(self.grid_shape)
                           if self.grid_shape else None),
            "grid_blocks": (int(self.grid_blocks)
                            if self.grid_blocks is not None else None),
            "recipe_algo": str(self.recipe_algo),
            "inner_repeats": int(self.inner_repeats),
        }


def _env_set(*names: str) -> bool:
    from ..utils.envknobs import env_is_set

    return any(env_is_set(n) for n in names)


def resolve_encoding(stats: InputStats,
                     tuned: dict | None = None) -> tuple[bool, float | None]:
    """Dense or ELL for this input, with the measured crossover consumed
    here and only here. Returns ``(use_ell, effective_threshold)``; the
    ELL lane exists only for sparse random-init plain-MU beta in {1, 0}
    inputs (``ops/nmf.py:run_nmf_use_ell``'s rule)."""
    if not (stats.sparse and stats.beta in (1.0, 0.0)
            and stats.init == "random" and stats.algo == "mu"):
        return False, None
    from ..ops.sparse import SPARSE_DENSITY_THRESHOLD, resolve_sparse_beta

    if tuned is None:
        from ..utils.autotune import cached_plan_points

        tuned = cached_plan_points()
    thr = tuned.get("ell_density_crossover")
    use_ell = resolve_sparse_beta(stats.beta, density=stats.density,
                                  width=stats.ell_width, g=stats.g,
                                  threshold=thr)
    eff = (thr if thr is not None and not _env_set("CNMF_TPU_SPARSE_BETA")
           else SPARSE_DENSITY_THRESHOLD)
    return bool(use_ell), float(eff)


def build_plan(stats: InputStats, inv: DeviceInventory | None = None,
               overrides: dict | None = None) -> ExecutionPlan:
    """Resolve the whole dispatch of one factorize.

    ``overrides`` carries what factorize already resolved from its
    arguments (pins, not heuristics): ``layout``, ``mesh_devices``,
    ``packed`` (None: the rule), ``use_ell``, ``ooc_engaged``,
    ``serve_chunk``, and ``sequential`` (the sequential lane resolves its
    recipe unsized, as each ``run_nmf`` call does). ``inv`` defaults to
    the inventory of the card.

    Precedence per field: explicit knob (or caller override) > autotuned
    point > static heuristic, recorded per field group in ``sources``.
    """
    from ..ops.kernels import kernel_label
    from ..ops.nmf import resolve_bf16_ratio
    from ..ops.recipe import resolve_recipe
    from ..parallel.replicates import _auto_packed
    from ..parallel.streaming import stream_depth, stream_threads
    from ..serving.batcher import resolve_buckets
    from ..utils.autotune import (cached_plan_points, cached_rho_scale,
                                  device_fingerprint)
    from ..utils.envknobs import env_str
    from ..version import __version__

    ov = dict(overrides or {})
    if inv is None:
        inv = DeviceInventory.probe()
    device = "cuda" if inv.backend == "cuda" else "cpu"
    fp = device_fingerprint(device)
    tuned = cached_plan_points(device=device)
    sources: dict = {}

    # -- encoding -------------------------------------------------------
    use_ell, thr = resolve_encoding(stats, tuned)
    if "use_ell" in ov:
        use_ell = bool(ov["use_ell"])
    sources["encoding"] = (
        "pin" if _env_set("CNMF_TPU_SPARSE_BETA")
        else ("autotuned" if "ell_density_crossover" in tuned
              and stats.sparse else "heuristic"))

    # -- solver recipe --------------------------------------------------
    sizes = ({} if ov.get("sequential") else dict(
        n=stats.n, g=stats.g, k=stats.k_max,
        ell_width=stats.ell_width if use_ell else None))
    recipe = resolve_recipe(stats.beta, stats.mode, algo=stats.algo,
                            ell=use_ell, **sizes)
    if _env_set("CNMF_TPU_ACCEL", "CNMF_TPU_INNER_REPEATS",
                "CNMF_TPU_KL_NEWTON", "CNMF_TPU_SKETCH"):
        sources["recipe"] = "pin"
    elif recipe.algo == "amu" and cached_rho_scale(
            stats.beta, use_ell, device=device) is not None:
        sources["recipe"] = "autotuned"
    elif recipe.algo == "sketch" and "sketch_dim" in tuned:
        sources["recipe"] = "autotuned"
    else:
        sources["recipe"] = "heuristic"

    # -- kernel: the dna and sketch recipes keep strict f32 -------------
    bf16 = bool(not (recipe.kl_newton or recipe.algo == "sketch")
                and resolve_bf16_ratio(stats.beta, stats.mode))
    kern = kernel_label(use_ell, device, bf16, stats.beta)
    sources["kernel"] = ("pin" if _env_set("CNMF_TPU_BF16_RATIO")
                         else "heuristic")

    # -- program shape --------------------------------------------------
    packed = ov.get("packed")
    if packed is None:
        packed = _auto_packed(use_ell, stats.algo, stats.init, stats.n_ks,
                              stats.max_replicates, stats.total_workers)
        sources["packed"] = "heuristic"
    else:
        packed = bool(packed)
        sources["packed"] = "pin"
    if packed and recipe.algo == "sketch":
        packed = False

    # -- layout ---------------------------------------------------------
    layout = str(ov.get("layout", "1d"))
    mesh_devices = int(ov.get("mesh_devices", inv.n_devices))
    grid_shape = grid_blk = grid_ovl = None
    if layout == "grid2d":
        from ..parallel.grid2d import (_grid_rc, grid_blocks,
                                       grid_overlap_enabled)

        r, c = _grid_rc(inv.n_devices, inv.n_processes)
        grid_shape = [int(r), int(c)]
        grid_blk = int(grid_blocks(max(1, stats.n // max(r, 1))))
        grid_ovl = bool(grid_overlap_enabled())
        sources["grid"] = (
            "pin" if _env_set("CNMF_TPU_GRID_BLOCKS", "CNMF_TPU_GRID_SHAPE",
                              "CNMF_TPU_GRID_OVERLAP")
            else ("autotuned" if "grid_blocks" in tuned else "heuristic"))

    # -- streaming ------------------------------------------------------
    threads = int(stream_threads())
    depth = int(stream_depth())
    sources["streaming"] = (
        "pin" if _env_set("CNMF_TPU_STREAM_THREADS", "CNMF_TPU_STREAM_DEPTH")
        else ("autotuned" if "stream_threads" in tuned else "heuristic"))

    # -- ingest tier + store backend ------------------------------------
    ooc = bool(ov.get("ooc_engaged", stats.has_store))
    sources["ooc"] = "pin" if _env_set("CNMF_TPU_OOC") else "heuristic"
    uri = env_str("CNMF_TPU_STORE_URI", "").strip()
    store = ("http" if uri.startswith(("http://", "https://"))
             else ("file" if uri.startswith("file://") else "local"))
    sources["store"] = "pin" if uri else "heuristic"

    # -- serve schedule -------------------------------------------------
    buckets = [int(b) for b in resolve_buckets(
        int(ov.get("serve_chunk", 1024)))]
    sources["serve"] = ("pin" if _env_set("CNMF_TPU_SERVE_BUCKETS")
                        else "heuristic")

    plan = ExecutionPlan(
        package_version=str(__version__), fingerprint=fp,
        beta=float(stats.beta), mode=str(stats.mode), use_ell=use_ell,
        density=(None if stats.density is None
                 else round(float(stats.density), 6)),
        density_threshold=thr,
        ell_width=(int(stats.ell_width) if use_ell
                   and stats.ell_width is not None else None),
        recipe_algo=recipe.algo, inner_repeats=int(recipe.inner_repeats),
        kl_newton=bool(recipe.kl_newton),
        sketch_dim=int(recipe.sketch_dim),
        sketch_exact_every=int(recipe.sketch_exact_every),
        recipe_label=recipe.label, bf16_ratio=bf16, kernel=kern,
        packed=bool(packed), layout=layout, mesh_devices=mesh_devices,
        grid_shape=grid_shape, grid_blocks=grid_blk, grid_overlap=grid_ovl,
        stream_threads=threads, stream_depth=depth, ooc_engaged=ooc,
        store_backend=store, serve_buckets=buckets, sources=sources)
    plan._resolved_recipe = recipe
    return plan


def apply_plan(plan: ExecutionPlan) -> dict:
    """Pin the dispatch knobs to this plan's values, so every resolver
    reproduces its dispatch; returns the ``{knob: value}`` map. The
    autotuner is pinned off (a replay must not measure its way to another
    program), and ``CNMF_TPU_STORE_URI`` is not pinned (the recorded
    backend kind is provenance; a URI rarely survives the machine)."""
    from ..utils.envknobs import pin_knob

    pins: dict[str, str] = {"CNMF_TPU_AUTOTUNE": "0",
                            "CNMF_TPU_SPARSE_BETA": "1" if plan.use_ell
                            else "0"}
    if plan.recipe_algo == "sketch":
        pins["CNMF_TPU_SKETCH"] = "1"
        pins["CNMF_TPU_SKETCH_DIM"] = str(int(plan.sketch_dim))
        pins["CNMF_TPU_SKETCH_EXACT_EVERY"] = str(
            int(plan.sketch_exact_every))
        pins["CNMF_TPU_ACCEL"] = "0"
    else:
        pins["CNMF_TPU_SKETCH"] = "0"
        if plan.recipe_algo == "mu":
            pins["CNMF_TPU_ACCEL"] = "0"
        elif plan.recipe_algo == "dna":
            pins["CNMF_TPU_ACCEL"] = "1"
            pins["CNMF_TPU_KL_NEWTON"] = "1"
        elif plan.recipe_algo == "amu":
            pins["CNMF_TPU_ACCEL"] = "1"
            pins["CNMF_TPU_KL_NEWTON"] = "0"
            pins["CNMF_TPU_INNER_REPEATS"] = str(int(plan.inner_repeats))
        # hals is the run's algo, not a knob
    pins["CNMF_TPU_BF16_RATIO"] = "1" if plan.bf16_ratio else "0"
    pins["CNMF_TPU_STREAM_THREADS"] = str(int(plan.stream_threads))
    pins["CNMF_TPU_STREAM_DEPTH"] = str(int(plan.stream_depth))
    if plan.grid_shape:
        pins["CNMF_TPU_GRID_SHAPE"] = "%dx%d" % tuple(plan.grid_shape)
    if plan.grid_blocks is not None:
        pins["CNMF_TPU_GRID_BLOCKS"] = str(int(plan.grid_blocks))
    if plan.grid_overlap is not None:
        pins["CNMF_TPU_GRID_OVERLAP"] = "1" if plan.grid_overlap else "0"
    if plan.serve_buckets:
        pins["CNMF_TPU_SERVE_BUCKETS"] = ",".join(
            str(int(b)) for b in plan.serve_buckets)
    for name, value in pins.items():
        pin_knob(name, value)
    return pins


def load_plan(path: str) -> ExecutionPlan:
    with open(path) as f:
        return ExecutionPlan.from_json(f.read())


def maybe_apply_plan_env() -> ExecutionPlan | None:
    """``CNMF_TPU_PLAN=<file>`` (``factorize --plan``): load and pin before
    any dispatch resolves. None when the knob is unset; a missing or
    invalid file raises."""
    from ..utils.envknobs import env_str

    path = env_str(PLAN_ENV, "").strip()
    if not path:
        return None
    plan = load_plan(path)
    apply_plan(plan)
    return plan


def render_plan(plan_dict: dict) -> list[str]:
    """Text lines of the report's Plan section, from the event/JSON dict:
    the JAX package's text, so either package's report renders either
    package's plan alike (a port plan has no ``stream_transport`` and
    reads ``transport=None``)."""
    d = dict(plan_dict)
    src = d.get("sources") or {}

    def tag(group):
        s = src.get(group)
        return f" [{s}]" if s else ""

    lines = [f"  plan v{d.get('plan_version')}  package "
             f"{d.get('package_version')}  device {d.get('fingerprint')}"]
    enc = "ell" if d.get("use_ell") else "dense"
    dens = d.get("density")
    thr = d.get("density_threshold")
    lines.append(
        f"  encoding: {enc}"
        + (f" (density {dens}" + (f" vs crossover {thr})"
                                  if thr is not None else ")")
           if dens is not None else "")
        + tag("encoding"))
    lines.append(
        f"  recipe:   {d.get('recipe_label')}  (beta={d.get('beta')}, "
        f"mode={d.get('mode')})" + tag("recipe"))
    lines.append(f"  kernel:   {d.get('kernel')}" + tag("kernel"))
    lines.append(
        f"  program:  {'packed K-sweep' if d.get('packed') else 'per-K'}"
        + tag("packed"))
    lay = f"  layout:   {d.get('layout')} x{d.get('mesh_devices')} device(s)"
    if d.get("grid_shape"):
        lay += (f"  grid {d['grid_shape'][0]}x{d['grid_shape'][-1]}"
                f" blocks={d.get('grid_blocks')}"
                f" overlap={'on' if d.get('grid_overlap') else 'off'}"
                + tag("grid"))
    lines.append(lay)
    lines.append(
        f"  stream:   transport={d.get('stream_transport')} "
        f"threads={d.get('stream_threads')} depth={d.get('stream_depth')}"
        + tag("streaming"))
    lines.append(
        "  ingest:   " + ("out-of-core shard store" if d.get("ooc_engaged")
                          else "resident")
        + tag("ooc") + f"  store={d.get('store_backend')}" + tag("store"))
    if d.get("serve_buckets"):
        lines.append(
            "  serve:    buckets="
            + ",".join(str(b) for b in d["serve_buckets"]) + tag("serve"))
    return lines


def plan_from_run_dir(run_dir: str) -> dict | None:
    """The last ``plan`` event of a run directory's telemetry, or None."""
    from ..utils.telemetry import _find_event_files, read_events

    plan = None
    for path in _find_event_files(run_dir):
        for ev in read_events(path):
            if ev.get("t") == "plan":
                plan = ev.get("plan")
    return plan
