"""The port's roofline cost model (``obs/costmodel.py`` and the lane
formulas beside the kernels) against the JAX package's.

``lane_cost`` is the JAX package's exactly (flops and bytes, equality,
not a band) on every mapped lane over a grid of shapes, degenerate
windows included:

    ell-cuda -> ell-pallas, ell-torch -> ell-jnp, dense -> vmapped and
    dense-jnp, dense-bf16 -> vmapped-bf16, bundled -> bundled.

Then the roofline verdicts and the peaks table, the ``perf_model`` events
of a CPU factorize (batched sweeps and the row-sharded path) with the
knob set and unset, artifacts byte for byte with the knob on or off, and
the report's Roofline section and JSON summary text for text as the JAX
package renders the same events file.
"""

import itertools
import math
import os

import numpy as np
import pytest
import torch

from cnmf_torch_tpu.obs import costmodel as jcm
from cnmf_torch_tpu.utils import telemetry as jtel
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.obs import costmodel as cm
from cnmf_torch_tpu_torch.utils import telemetry as tel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


# port label -> the JAX package's labels of the same formula
LANES = {"ell-cuda": ("ell-pallas",), "ell-torch": ("ell-jnp",),
         "dense": ("vmapped", "dense-jnp"),
         "dense-bf16": ("vmapped-bf16",), "bundled": ("bundled",)}
SHAPES = [(512, 256, 9), (5000, 2000, 13), (250_000, 2000, 9),
          (37, 11, 1), (1, 1, 1), (0, 64, 5), (64, 0, 5), (64, 64, 0)]
ELL = [(None, None), (0, None), (8, None), (184, None), (184, 1496),
       (200, 240_424)]


def _cases():
    for (port, theirs), (n, g, k), (w, tw), beta, bf16 in itertools.product(
            LANES.items(), SHAPES, ELL, (2.0, 1.0, 0.0), (False, True)):
        if port.startswith("dense") or port == "bundled":
            if (w, tw) != (None, None):
                continue
        elif beta == 2.0 or bf16:
            continue
        for lane in theirs:
            yield port, lane, n, g, k, w, tw, beta, bf16


CASES = list(_cases())


@pytest.mark.parametrize("port,lane,n,g,k,w,tw,beta,bf16", CASES)
def test_lane_cost_equals_jax(port, lane, n, g, k, w, tw, beta, bf16):
    mine = cm.lane_cost(port, n, g, k, beta=beta, ell_width=w, t_width=tw,
                        bf16_ratio=bf16)
    theirs = jcm.lane_cost(lane, n, g, k, beta=beta, ell_width=w,
                           t_width=tw, bf16_ratio=bf16)
    assert mine.pop("lane") == port
    assert theirs.pop("lane") == lane
    # the exemption is each package's own (interpret mode there, no card
    # here); on the CPU both exempt
    assert mine.pop("perf_exempt", True) is True
    theirs.pop("perf_exempt", None)
    assert mine == theirs
    if n <= 0 or g <= 0 or k <= 0 or (port.startswith("ell") and not w):
        assert mine == {"flops": 0.0, "bytes": 0.0, "degenerate": True}
    else:
        assert "degenerate" not in mine and mine["flops"] > 0


def test_the_card_lane_is_exempt_off_a_card_only():
    assert cm.lane_cost("ell-cuda", 64, 32, 5, ell_width=8,
                        device="cpu")["perf_exempt"] is True
    assert cm.lane_cost("ell-cuda", 64, 32, 5, ell_width=8,
                        device=torch.device("cuda", 0))["perf_exempt"] is False


def test_lane_cost_names_what_it_lacks():
    # the grid lane is priced since the multi-device layer landed
    # (tests/test_torch_grid2d.py holds it to the JAX formula)
    assert cm.lane_cost("grid2d", 64, 64, 5)["collective_bytes"] > 0
    with pytest.raises(ValueError, match="unknown lane"):
        cm.lane_cost("vmapped", 64, 64, 5)


# ---------------------------------------------------------------------------
# peaks and the roofline verdict
# ---------------------------------------------------------------------------

def test_chip_peaks_lookup_and_nominal_fallback():
    h100 = cm.chip_peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"flops": 67e12, "bw": 3.35e12, "source": "datasheet"}
    for unknown in (None, "", "cpu", "NVIDIA H100 PCIe", "TPU v4"):
        p = cm.chip_peaks(unknown)
        assert p == jcm.chip_peaks(None)
        assert p["source"] == "nominal-cpu"
    assert cm.device_peaks("cpu") == cm.chip_peaks(None)


_ROOFS = [(2e12, 1e9, 1.0), (1e12, 5e11, 1.0), (0.0, 0.0, 1.0),
          (1e9, 1e6, 0.0), (1e9, 1e6, None), (1e9, 0.0, 2.0),
          (3.1e11, 7.7e10, 1.83)]


@pytest.mark.parametrize("flops,nbytes,wall", _ROOFS)
@pytest.mark.parametrize("peaks", [
    None, {"flops": 100e12, "bw": 1e12, "source": "datasheet"},
    {"flops": 67e12, "bw": 3.35e12, "source": "datasheet"}])
@pytest.mark.parametrize("exempt", [False, True])
def test_roofline_equals_jax(flops, nbytes, wall, peaks, exempt):
    assert (cm.roofline(flops, nbytes, wall, peaks, perf_exempt=exempt)
            == jcm.roofline(flops, nbytes, wall, peaks,
                            perf_exempt=exempt))


def test_roofline_verdicts():
    peaks = {"flops": 100e12, "bw": 1e12, "source": "datasheet"}
    r = cm.roofline(2e12, 1e9, 1.0, peaks)
    assert r["bound"] == "compute-bound" and not r["perf_exempt"]
    assert r["mfu"] == pytest.approx(0.02)
    r = cm.roofline(1e12, 5e11, 1.0, peaks)
    assert r["bound"] == "memory-bound"
    assert r["bw_frac"] == pytest.approx(0.5)
    assert cm.roofline(0.0, 0.0, 1.0, peaks)["bound"] == "idle"
    assert cm.roofline(1e9, 1e6, 0.0, peaks)["bound"] == "idle"
    assert cm.roofline(1e9, 1e6, 1.0, None)["perf_exempt"] is True
    assert cm.roofline(1e9, 1e6, 1.0, peaks,
                       perf_exempt=True)["perf_exempt"] is True


# ---------------------------------------------------------------------------
# the perf_model events of a factorize
# ---------------------------------------------------------------------------

def _counts(tmp_path, n=160, g=90, seed=5):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(4) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(4, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * 260.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


# (loss, rowshard threshold) -> the stage and lane of the event; the KL
# batched run takes the ELL lane (CNMF_TPU_SPARSE_BETA=1), the others the
# dense one (the bf16 ratio chain of online KL, and beta=2)
RUNS = {"kl": ("kullback-leibler", 200_000, "factorize", "ell-torch"),
        "kl_dense": ("kullback-leibler", 200_000, "factorize",
                     "dense-bf16"),
        "frobenius": ("frobenius", 200_000, "factorize", "dense"),
        "rowshard": ("kullback-leibler", 50, "factorize_rowshard", "dense")}


def _run(tmp_path, monkeypatch, which, knob, name=None):
    loss, threshold, _, _ = RUNS[which]
    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.setenv("CNMF_TPU_SPARSE_BETA", "1" if which == "kl"
                       else "0")
    if knob:
        monkeypatch.setenv(cm.PERF_MODEL_ENV, "1")
    else:
        monkeypatch.delenv(cm.PERF_MODEL_ENV, raising=False)
    name = name or which
    obj = cNMF(str(tmp_path), name, device="cpu",
               rowshard_threshold=threshold)
    obj.prepare(_counts(tmp_path), components=[3, 4], n_iter=3, seed=7,
                num_highvar_genes=70, beta_loss=loss, batch_size=64,
                max_NMF_iter=60)
    obj.factorize()
    run_dir = str(tmp_path / name)
    return obj, run_dir, os.path.join(run_dir, "cnmf_tmp",
                                      name + ".events.jsonl")


@pytest.mark.parametrize("which", sorted(RUNS))
def test_perf_model_event_end_to_end(tmp_path, monkeypatch, which):
    obj, run_dir, events_fn = _run(tmp_path, monkeypatch, which, knob=True)
    _, _, stage, lane = RUNS[which]
    # both packages' validators accept the port's events file
    assert tel.validate_events_file(events_fn) == \
        jtel.validate_events_file(events_fn)
    events = tel.read_events(events_fn)
    (pm,) = [e for e in events if e["t"] == "perf_model"]
    assert (pm["stage"], pm["lane"]) == (stage, lane)
    assert lane == obj.factorize_info["kernel"]
    # the multiplicity: the solver iterations of the replicates events
    # (batched sweeps), or each job's pass cap (the row-sharded path)
    if which == "rowshard":
        want = {k: 3 * obj.factorize_info["n_passes"] for k in (3, 4)}
    else:
        want = {}
        for e in events:
            if e["t"] == "replicates":
                want[int(e["k"])] = want.get(int(e["k"]), 0) + sum(
                    r["iters"] for r in e["records"])
    assert pm["predicted"]["by_k"] == {str(k): v for k, v in want.items()}
    assert pm["measured"]["passes"] == sum(want.values())
    beta = 2.0 if which == "frobenius" else 1.0
    width = _width(obj) if lane.startswith("ell") else None
    flops = nbytes = 0.0
    for k, iters in want.items():
        c = cm.lane_cost(lane, 160, 70, k, beta=beta, ell_width=width,
                         bf16_ratio=obj.factorize_info["bf16_ratio"])
        flops += c["flops"] * iters
        nbytes += c["bytes"] * iters
    assert pm["predicted"]["flops"] == flops
    assert pm["predicted"]["bytes"] == nbytes
    roof, wall = pm["roofline"], pm["measured"]["wall_s"]
    assert wall > 0
    # a CPU run: nominal peaks, exempt, never compared
    assert roof["peak_source"] == "nominal-cpu" and roof["perf_exempt"]
    peaks = cm.chip_peaks(None)
    assert roof["mfu"] == pytest.approx(flops / wall / peaks["flops"],
                                        rel=5e-3)
    assert roof["bw_frac"] == pytest.approx(nbytes / wall / peaks["bw"],
                                            rel=5e-3)
    assert roof["mfu"] > 0 and roof["bw_frac"] > 0


def _width(obj):
    """The ELL row width of the run's normalized counts (what factorize
    prices the ELL lanes at)."""
    from cnmf_torch_tpu_torch.ops.sparse import ell_row_width
    from cnmf_torch_tpu_torch.utils.io import load_matrix

    return int(ell_row_width(load_matrix(
        obj.paths["normalized_counts"]).X))


@pytest.mark.parametrize("which", sorted(RUNS))
def test_no_perf_model_event_without_the_knob(tmp_path, monkeypatch, which):
    _, _, events_fn = _run(tmp_path, monkeypatch, which, knob=False)
    events = tel.read_events(events_fn)
    assert [e["t"] for e in events if e["t"] == "replicates"] or \
        which == "rowshard"
    assert not [e for e in events if e["t"] == "perf_model"]


def _stored_arrays(obj, ks=(3, 4), n_iter=3):
    out = {}
    for k in ks:
        for it in range(n_iter):
            with np.load(obj.paths["iter_spectra"] % (k, it)) as f:
                out[(k, it)] = tuple(np.asarray(f[key]).tobytes()
                                     for key in f.files)
    return out


@pytest.mark.parametrize("which", sorted(RUNS))
def test_artifacts_byte_identical_with_the_knob_on_or_off(tmp_path,
                                                          monkeypatch,
                                                          which):
    off, _, _ = _run(tmp_path, monkeypatch, which, knob=False, name="off")
    on, _, _ = _run(tmp_path, monkeypatch, which, knob=True, name="on")
    assert _stored_arrays(off) == _stored_arrays(on)


@pytest.mark.parametrize("which", sorted(RUNS))
def test_report_roofline_renders_as_jax_renders_it(tmp_path, monkeypatch,
                                                   which):
    _, run_dir, events_fn = _run(tmp_path, monkeypatch, which, knob=True)
    mine, theirs = tel.render_report(run_dir), jtel.render_report(run_dir)

    def roofline_section(text):
        lines = text.splitlines()
        i = lines.index("Roofline")
        j = next((m for m in range(i + 2, len(lines))
                  if not lines[m].startswith("  ")), len(lines))
        return lines[i:j]

    assert roofline_section(mine) == roofline_section(theirs)
    assert RUNS[which][3] in "\n".join(roofline_section(mine))
    events = tel.read_events(events_fn)
    s_mine = tel.summarize_events(events)["roofline"]
    s_theirs = jtel.summarize_events(jtel.read_events(events_fn))["roofline"]
    assert s_mine == s_theirs and len(s_mine) == 1
    assert math.isfinite(s_mine[0]["flops"])
