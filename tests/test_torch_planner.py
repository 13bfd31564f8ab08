"""The port's execution planner (``runtime/planner.py``).

The cases of the JAX package's ``tests/test_planner.py`` as far as they
apply to the port (its lowering-identity case becomes the same solve bit for
bit; the port has no Pallas field), then:

- field-by-field parity of the port's ``build_plan`` with the JAX package's
  over a grid of beta in {2, 1, 0}, online and batch, dense and sparse
  inputs, densities on both sides of the 0.10 crossover, 1 and 4 workers,
  with and without pins (the port's ``kernel`` label is the JAX label's
  counterpart, and its bf16 chain stays off under the dna and sketch
  recipes, as its dispatch always had it);
- a JAX plan JSON is refused, naming the fields that do not belong;
- ``plan <run_dir> --out`` then ``factorize --plan`` through the CLI on the
  CPU: the same signature, the same iter spectra and consensus usages byte
  for byte, the autotuned groups' sources ``pin``; a missing plan file
  exits non-zero naming the path.

Every test runs with the dispatch knobs cleared, the whole environment
restored after it (``apply_plan`` pins knobs into ``os.environ``), and a
private autotune cache for both packages.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.runtime import planner as jplanner
from cnmf_torch_tpu.utils import autotune as jautotune
from cnmf_torch_tpu_torch.runtime.planner import (
    DISPATCH_KNOBS, DeviceInventory, ExecutionPlan, InputStats, apply_plan,
    build_plan, load_plan, maybe_apply_plan_env, render_plan)
from cnmf_torch_tpu_torch.utils import autotune

INV = DeviceInventory(backend="cpu", device_kind="cpu", n_devices=1,
                      n_processes=1, cpu_count=4)
JINV = jplanner.DeviceInventory(backend="cpu", device_kind="cpu",
                                n_devices=1, n_processes=1, cpu_count=4)

# a sparse batch KL sweep: every contested decision has two outcomes
SPARSE_KL = InputStats(n=2000, g=800, beta=1.0, mode="batch",
                       init="random", algo="mu", sparse=True,
                       density=0.05, ell_width=40, k_max=8, n_ks=2,
                       max_replicates=3, total_workers=1)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    env0 = dict(os.environ)
    for knob in DISPATCH_KNOBS | jplanner.DISPATCH_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    prev = autotune.set_cache_dir(str(tmp_path / "autotune"))
    monkeypatch.setattr(autotune, "_active_device", None)
    real = jautotune.cache_path
    monkeypatch.setattr(jautotune, "cache_path",
                        lambda cache_dir=None: real(
                            cache_dir or str(tmp_path / "jax_autotune")))
    yield
    autotune.set_cache_dir(prev)
    os.environ.clear()
    os.environ.update(env0)


def _plant_points(points: dict) -> None:
    autotune._merge_write(autotune.cache_path(device="cpu"),
                          {"plan_points": points}, device="cpu")


# ---------------------------------------------------------------------------
# determinism and serialization
# ---------------------------------------------------------------------------

def test_build_plan_deterministic():
    a = build_plan(SPARSE_KL, INV)
    b = build_plan(SPARSE_KL, INV)
    assert a.to_dict() == b.to_dict()
    assert a.signature() == b.signature()
    # the shipped defaults on this shape: the ELL lane (density 0.05 <=
    # 0.10), the dna recipe (batch KL), the plain ELL statistics off a card
    assert a.use_ell and a.recipe_algo == "dna" and a.kernel == "ell-torch"
    assert set(a.sources.values()) == {"heuristic"}
    assert "use_pallas" not in a.to_dict()
    assert "stream_transport" not in a.to_dict()


def test_json_round_trip(tmp_path):
    plan = build_plan(SPARSE_KL, INV)
    back = ExecutionPlan.from_json(plan.to_json())
    assert back.to_dict() == plan.to_dict()
    assert back.signature() == plan.signature()
    path = str(tmp_path / "plan.json")
    plan.save(path)
    assert load_plan(path).to_dict() == plan.to_dict()


def test_from_dict_rejects_unknown_fields_and_versions():
    d = build_plan(SPARSE_KL, INV).to_dict()
    with pytest.raises(ValueError, match="unknown plan fields"):
        ExecutionPlan.from_dict(dict(d, not_a_field=1))
    with pytest.raises(ValueError, match="plan_version"):
        ExecutionPlan.from_dict(dict(d, plan_version=99))
    with pytest.raises(ValueError, match="kernel labels"):
        ExecutionPlan.from_dict(dict(d, kernel="ell-pallas"))


def test_signature_excludes_provenance_and_measured_density():
    plan = build_plan(SPARSE_KL, INV)
    sig = plan.signature()
    pinned = ExecutionPlan.from_dict(plan.to_dict())
    pinned.sources = {k: "pin" for k in plan.sources}
    pinned.density = 0.0123
    pinned.density_threshold = 0.31
    assert pinned.signature() == sig
    flipped = ExecutionPlan.from_dict(plan.to_dict())
    flipped.use_ell = not flipped.use_ell
    assert flipped.signature() != sig


def test_render_plan_covers_every_decision_group():
    text = "\n".join(render_plan(build_plan(SPARSE_KL, INV).to_dict()))
    for token in ("encoding:", "recipe:", "kernel:", "program:",
                  "layout:", "stream:", "ingest:", "[heuristic]"):
        assert token in text, token


def test_render_plan_renders_a_jax_plan_as_the_jax_package():
    jplan = jplanner.build_plan(jplanner.InputStats(**SPARSE_KL.__dict__),
                                JINV).to_dict()
    assert render_plan(jplan) == jplanner.render_plan(jplan)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def test_apply_plan_round_trips_to_the_same_signature():
    plan = build_plan(SPARSE_KL, INV)
    pins = apply_plan(plan)
    assert pins["CNMF_TPU_SPARSE_BETA"] == "1"
    assert pins["CNMF_TPU_ACCEL"] == "1"  # dna
    assert pins["CNMF_TPU_AUTOTUNE"] == "0"  # a replay never measures
    assert "CNMF_TPU_PALLAS" not in pins
    assert "CNMF_TPU_STREAM_TRANSPORT" not in pins
    replay = build_plan(SPARSE_KL, INV)
    assert replay.signature() == plan.signature()
    assert replay.sources["encoding"] == "pin"
    assert replay.sources["recipe"] == "pin"


def test_maybe_apply_plan_env(tmp_path):
    assert maybe_apply_plan_env() is None
    plan = build_plan(SPARSE_KL, INV)
    path = str(tmp_path / "plan.json")
    plan.save(path)
    os.environ["CNMF_TPU_PLAN"] = path
    assert maybe_apply_plan_env().signature() == plan.signature()
    assert os.environ["CNMF_TPU_SPARSE_BETA"] == "1"
    os.environ["CNMF_TPU_PLAN"] = str(tmp_path / "nope.json")
    with pytest.raises(OSError):
        maybe_apply_plan_env()


def test_a_jax_plan_json_is_refused(tmp_path):
    jplan = jplanner.build_plan(jplanner.InputStats(**SPARSE_KL.__dict__),
                                JINV)
    path = str(tmp_path / "jax_plan.json")
    jplan.save(path)
    with pytest.raises(ValueError) as exc:
        load_plan(path)
    msg = str(exc.value)
    assert "use_pallas" in msg and "stream_transport" in msg
    assert "JAX package" in msg
    os.environ["CNMF_TPU_PLAN"] = path
    with pytest.raises(ValueError, match="use_pallas"):
        maybe_apply_plan_env()
    assert "CNMF_TPU_SPARSE_BETA" not in os.environ  # nothing pinned


# ---------------------------------------------------------------------------
# precedence: pin > autotuned > heuristic
# ---------------------------------------------------------------------------

def test_autotuned_crossover_beats_static_heuristic():
    stats = InputStats(**dict(SPARSE_KL.__dict__, density=0.15))
    base = build_plan(stats, INV)
    assert not base.use_ell
    assert base.sources["encoding"] == "heuristic"
    _plant_points({"ell_density_crossover": 0.2})
    tuned = build_plan(stats, INV)
    assert tuned.use_ell
    assert tuned.sources["encoding"] == "autotuned"
    assert tuned.density_threshold == 0.2


def test_pin_beats_autotuned_point():
    stats = InputStats(**dict(SPARSE_KL.__dict__, density=0.15))
    _plant_points({"ell_density_crossover": 0.2, "stream_threads": 3})
    tuned = build_plan(stats, INV)
    assert tuned.use_ell and tuned.stream_threads == 3
    assert tuned.sources["streaming"] == "autotuned"
    os.environ["CNMF_TPU_SPARSE_BETA"] = "0"
    os.environ["CNMF_TPU_STREAM_THREADS"] = "2"
    pinned = build_plan(stats, INV)
    assert not pinned.use_ell and pinned.stream_threads == 2
    assert pinned.sources["encoding"] == "pin"
    assert pinned.sources["streaming"] == "pin"


def test_caller_override_is_a_pin():
    assert build_plan(SPARSE_KL, INV,
                      overrides={"packed": True}).sources["packed"] == "pin"
    assert build_plan(SPARSE_KL, INV).sources["packed"] == "heuristic"


def test_cache_invalidated_by_fingerprint_change(monkeypatch):
    from cnmf_torch_tpu_torch import version
    from cnmf_torch_tpu_torch.utils.autotune import cached_plan_points

    _plant_points({"stream_threads": 3})
    assert cached_plan_points(device="cpu").get("stream_threads") == 3
    monkeypatch.setattr(version, "__version__", "999.0.0")
    assert cached_plan_points(device="cpu") == {}


def test_autotune_off_disables_consumption():
    from cnmf_torch_tpu_torch.utils.autotune import cached_plan_points

    _plant_points({"stream_threads": 3, "ell_density_crossover": 0.2})
    os.environ["CNMF_TPU_AUTOTUNE"] = "0"
    assert cached_plan_points(device="cpu") == {}
    plan = build_plan(InputStats(**dict(SPARSE_KL.__dict__, density=0.15)),
                      INV)
    assert not plan.use_ell
    assert plan.sources["encoding"] == "heuristic"


# ---------------------------------------------------------------------------
# the defaults: unset is the plain program
# ---------------------------------------------------------------------------

def test_online_auto_default_is_the_plain_mu_solve():
    """Where the auto lanes do not engage (online mode), unset
    ``CNMF_TPU_ACCEL`` resolves the same identity recipe as ``=0``, and the
    solve under it is the bare solve bit for bit."""
    from cnmf_torch_tpu_torch.ops.nmf import nmf_fit_batch
    from cnmf_torch_tpu_torch.ops.recipe import resolve_recipe

    rec_auto = resolve_recipe(1.0, "online")
    os.environ["CNMF_TPU_ACCEL"] = "0"
    rec_zero = resolve_recipe(1.0, "online")
    del os.environ["CNMF_TPU_ACCEL"]
    for rec in (rec_auto, rec_zero):
        assert (rec.algo, rec.inner_repeats, rec.kl_newton) == ("mu", 1,
                                                                False)
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.gamma(1.0, 1.0, (60, 30)), dtype=torch.float32)
    H0 = torch.as_tensor(rng.uniform(0.1, 1, (1, 60, 3)),
                         dtype=torch.float32)
    W0 = torch.as_tensor(rng.uniform(0.1, 1, (1, 3, 30)),
                         dtype=torch.float32)
    outs = [nmf_fit_batch(X, H0, W0, beta=1.0, max_iter=10, **kw)
            for kw in (dict(inner_repeats=rec_auto.inner_repeats,
                            kl_newton=rec_auto.kl_newton),
                       dict(inner_repeats=rec_zero.inner_repeats,
                            kl_newton=rec_zero.kl_newton), {})]
    for got in outs[1:]:
        for a, b in zip(outs[0][:2], got[:2]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoint identity and the recipe
# ---------------------------------------------------------------------------

def test_identity_fragment_tracks_math_affecting_fields_only():
    plan = build_plan(SPARSE_KL, INV)
    frag = plan.identity_fragment()
    assert "enc=ell" in frag

    def variant(**kw):
        v = ExecutionPlan.from_dict(plan.to_dict())
        for k, val in kw.items():
            setattr(v, k, val)
        return v.identity_fragment()

    assert variant(recipe_algo="mu", kl_newton=False) != frag
    assert variant(kernel="ell-cuda") != frag
    assert variant(use_ell=False) != frag
    assert variant(stream_threads=7, stream_depth=9) == frag
    assert variant(layout="grid2d", mesh_devices=8) == frag


def test_plan_recipe_round_trips():
    plan = build_plan(SPARSE_KL, INV)
    for rec in (plan.solver_recipe(),
                ExecutionPlan.from_json(plan.to_json()).solver_recipe()):
        assert rec.algo == plan.recipe_algo
        assert rec.inner_repeats == plan.inner_repeats
        assert rec.kl_newton == plan.kl_newton
        assert json.loads(plan.to_json())["recipe_label"] == rec.label


def test_plan_cost_prices_the_plan_with_the_lane_formula():
    from cnmf_torch_tpu.obs import costmodel as jcost
    from cnmf_torch_tpu_torch.obs import costmodel as tcost

    plan = build_plan(SPARSE_KL, INV)
    got = tcost.plan_cost(plan.cost_inputs(), 2000, 800, 8)
    want = jcost.plan_cost(dict(plan.cost_inputs(), kernel="ell-jnp"),
                           2000, 800, 8)
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"])
    dense = build_plan(InputStats(n=500, g=300, beta=2.0), INV)
    got = tcost.plan_cost(dense.cost_inputs(), 500, 300, 6)
    want = jcost.plan_cost(dict(dense.cost_inputs(), kernel="vmapped"),
                           500, 300, 6)
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"])


# ---------------------------------------------------------------------------
# parity with the JAX package's build_plan
# ---------------------------------------------------------------------------

_LABELS = {"vmapped": "dense", "vmapped-bf16": "dense-bf16",
           "ell-jnp": "ell-torch", "ell-pallas": "ell-cuda"}
SHARED = ("beta", "mode", "use_ell", "density", "density_threshold",
          "ell_width", "recipe_algo", "inner_repeats", "kl_newton",
          "sketch_dim", "sketch_exact_every", "recipe_label", "packed",
          "layout", "mesh_devices", "grid_shape", "grid_blocks",
          "grid_overlap", "stream_threads", "stream_depth", "ooc_engaged",
          "store_backend", "serve_buckets")
PINS = {
    "none": {},
    "lane+stream": {"CNMF_TPU_SPARSE_BETA": "1", "CNMF_TPU_STREAM_THREADS":
                    "2", "CNMF_TPU_SERVE_BUCKETS": "32,128"},
    "amu": {"CNMF_TPU_ACCEL": "1", "CNMF_TPU_KL_NEWTON": "0",
            "CNMF_TPU_BF16_RATIO": "0", "CNMF_TPU_OOC": "0"},
    "dense+sketch": {"CNMF_TPU_SPARSE_BETA": "0", "CNMF_TPU_SKETCH": "1",
                     "CNMF_TPU_SKETCH_DIM": "300"},
}


@pytest.mark.parametrize("pins", list(PINS))
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("density", [None, 0.05, 0.15])
@pytest.mark.parametrize("mode", ["online", "batch"])
@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0])
def test_build_plan_matches_jax_field_by_field(beta, mode, density, workers,
                                               pins):
    os.environ.update(PINS[pins])
    kw = dict(n=3000, g=900, beta=beta, mode=mode, init="random", algo="mu",
              sparse=density is not None, density=density,
              ell_width=None if density is None else int(density * 900 / 2),
              k_max=9, n_ks=5, max_replicates=6, total_workers=workers)
    got = build_plan(InputStats(**kw), INV).to_dict()
    want = jplanner.build_plan(jplanner.InputStats(**kw), JINV).to_dict()
    for name in SHARED:
        assert got[name] == want[name], name
    assert got["kernel"] == _LABELS[want["kernel"]] or (
        got["recipe_algo"] in ("dna", "sketch") and want["bf16_ratio"]
        and got["kernel"] == "dense")
    if got["recipe_algo"] not in ("dna", "sketch"):
        assert got["bf16_ratio"] == want["bf16_ratio"]
    else:
        assert got["bf16_ratio"] is False
    assert got["sources"] == want["sources"]


# ---------------------------------------------------------------------------
# the replay through the CLI, on the CPU
# ---------------------------------------------------------------------------

def _sparse_counts(n=400, g=1500, seed=14):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(5) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(5, g)) * 40.0 / g
    X = rng.poisson(usage @ spectra * 3.0).astype(np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    return X


def _run(cli_main, out, name, counts_fn, *extra):
    common = ["--output-dir", out, "--name", name, "--device", "cpu"]
    cli_main(["prepare", "-c", counts_fn, "-k", "4", "5", "-n", "5",
              "--seed", "9", "--numgenes", "1200", "--beta-loss",
              "kullback-leibler", "--batch_size", "150"] + common)
    # each CLI command is a process of its own: the plan's pins end with
    # the factorize that applied them
    env0 = dict(os.environ)
    cli_main(["factorize"] + common + list(extra))
    os.environ.clear()
    os.environ.update(env0)
    cli_main(["combine"] + common)
    cli_main(["consensus", "-k", "4", "--local-density-threshold", "2.0",
              "--no-build-reference"] + common)


def _files(out, name, pattern):
    """``{file name without the run name: bytes}`` of the run's files
    (``cnmf_tmp/`` and the run directory) whose names hold ``pattern``."""
    got = {}
    for d in (os.path.join(out, name, "cnmf_tmp"), os.path.join(out, name)):
        for f in sorted(os.listdir(d)):
            if pattern in f and os.path.isfile(os.path.join(d, f)):
                with open(os.path.join(d, f), "rb") as fh:
                    got[f[len(name):]] = fh.read()
    return got


def test_cli_replay_is_bit_identical(tmp_path, capsys):
    from cnmf_torch_tpu_torch import Frame, save_df_to_npz
    from cnmf_torch_tpu_torch.cli import main
    from cnmf_torch_tpu_torch.runtime.planner import plan_from_run_dir
    from cnmf_torch_tpu_torch.utils.telemetry import read_events

    X = _sparse_counts()
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(len(X))]),
                         np.asarray([f"g{j}" for j in range(X.shape[1])])),
                   fn)
    out = str(tmp_path / "out")
    os.environ["CNMF_TPU_TELEMETRY"] = "1"
    _plant_points({"ell_density_crossover": 0.3, "stream_threads": 2})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _run(main, out, "a", fn)
        a_plan = plan_from_run_dir(os.path.join(out, "a"))
        assert a_plan["use_ell"] and a_plan["kernel"] == "ell-torch"
        assert a_plan["sources"]["encoding"] == "autotuned"
        assert a_plan["sources"]["streaming"] == "autotuned"
        p = str(tmp_path / "p.json")
        capsys.readouterr()
        main(["plan", os.path.join(out, "a"), "--out", p])
        shown = capsys.readouterr().out
        assert "encoding: ell" in shown and "[autotuned]" in shown
        _run(main, out, "b", fn, "--plan", p)
    finally:
        torch.set_num_threads(threads)
    events = {name: [e for e in read_events(os.path.join(
        out, name, "cnmf_tmp", f"{name}.events.jsonl")) if e["t"] == "plan"]
        for name in ("a", "b")}
    assert len(events["a"]) == len(events["b"]) == 1
    assert events["a"][0]["signature"] == events["b"][0]["signature"]
    b_plan = events["b"][0]["plan"]
    assert b_plan["sources"]["encoding"] == "pin"
    assert b_plan["sources"]["streaming"] == "pin"
    spectra_a = _files(out, "a", ".iter_")
    assert len(spectra_a) == 10
    assert spectra_a == _files(out, "b", ".iter_")
    usages_a = _files(out, "a", "usages")
    assert usages_a and usages_a == _files(out, "b", "usages")
    # a missing plan file: a usage error naming the path
    missing = str(tmp_path / "no_such_plan.json")
    with pytest.raises(SystemExit) as exc:
        main(["factorize", "--output-dir", out, "--name", "a", "--device",
              "cpu", "--plan", missing])
    assert exc.value.code != 0
    assert missing in capsys.readouterr().err
