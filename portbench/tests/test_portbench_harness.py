"""The harness on the CPU: what it finds by name, the line it prints, the
frozen work counts and the reference against the port's CPU path."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from _tiny import ELL, TINY, run_tiny
from portbench import run
from portbench.harness import workcount


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


TOY_KIND = """
def run(cfg, traffic, seed, seconds, traced, device, workdir):
    return {"end_to_end": {"toy_rate": traffic["rate"] * cfg["scale"]},
            "attempted": 3, "failed": 0, "window_start": 0.0,
            "memory_peak_bytes": 0, "report": {"seed": seed}, "x": 1.5}


def compare(cfg, traffic, record, device):
    return {"toy_gap": record["x"] - 1.5}
"""


def _add_toy_cell(tmp_path, kind_file=True):
    """A copy of the benchmark with a configuration, a mix, a traffic
    kind, an end-to-end metric and a per-layer metric added as new files
    and entries."""
    shutil.copytree(os.path.join(run.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "scale": 2.0, "limits": {"toy_gap": 0}}))
    (pb / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"kind": "toy_kind", "rate": 4.0}))
    if kind_file:
        (pb / "kinds" / "toy_kind.py").write_text(TOY_KIND)
    (pb / "metrics" / "toy_metric.toy.py").write_text(
        "def read(record):\n    return 2.0 * record['x']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "s",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "toy.toy", "config": "toy",
                               "traffic": "toy-mix", "chips": 1, "why": "w"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "x/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.toy"]})
    bench["per_layer"].append({"name": "toy_metric.toy", "unit": "x",
                               "better": "lower", "source": "program_span",
                               "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy.toy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return pb, before


def test_an_added_cell_is_found_by_name_and_runs(tmp_path, monkeypatch):
    """A configuration, a mix, a traffic kind and two metrics, each added
    as files and entries, run through the harness with no file of it
    edited."""
    pb, before = _add_toy_cell(tmp_path)
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "HERE", str(pb))
    spec = run.resolve(run.load_benchmark(), "toy.toy")
    assert spec["config"]["scale"] == 2.0
    assert spec["traffic"]["rate"] == 4.0
    assert [m["name"] for m in spec["per_layer"]] == ["toy_metric.toy"]
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s",
                                                        "toy_rate"]
    out = run.run_cell(spec, 9, 1.0, False, "cpu", -1.0)
    assert out["correct"] is True and out["checks"] == {"toy_gap": [0.0, 0]}
    assert out["metrics"] == {"toy_rate": {"value": 8.0, "unit": "x/s"},
                              "setup_s": {"value": 1.0, "unit": "s"}}
    out = run.run_cell(spec, 9, 1.0, True, "cpu", -1.0)
    assert out["metrics"] == {"toy_metric.toy": {"value": 3.0, "unit": "x"}}
    line = run.result_line(out, {"kind": "cpu stand-in",
                                 "power_limit_w": None}, 1, True)
    assert line["report"] == {"seed": 9, "reference_s": pytest.approx(
        line["report"]["reference_s"])}
    after = _digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_added_mix_of_an_existing_kind_is_data_alone(tmp_path,
                                                        monkeypatch):
    pb, _ = _add_toy_cell(tmp_path, kind_file=False)
    (pb / "traffic" / "toy-mix.json").write_text(json.dumps(
        {"kind": "factorize_jobs", "sample_per_job_per_k": 2}))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "HERE", str(pb))
    spec = run.resolve(run.load_benchmark(), "toy.toy")
    kind = run.kind_module(spec["traffic"]["kind"])
    assert callable(kind.run) and callable(kind.compare)


@pytest.mark.parametrize("cell", ["pbmc10k-kl.factorize",
                                  "pbmc10k-frob.factorize"])
def test_each_cell_finds_its_metrics(cell):
    spec = run.resolve(run.load_benchmark(), cell)
    for m in spec["per_layer"]:
        assert callable(run.reader(m["name"]))
    assert {"setup_s", "replicates_per_s"} == {
        m["name"] for m in spec["end_to_end"]}


def test_a_run_without_a_card_prints_no_result(capsys):
    rc = run.main(["--workload", "pbmc10k-kl.factorize", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "CUDA card" in out.err


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_has_the_contracts_shape(trace):
    out = run_tiny("pbmc10k-kl.factorize", seed=2 ** 31 + 11, trace=trace,
                   **ELL)
    line = run.result_line(out, {"kind": "cpu stand-in",
                                 "power_limit_w": None}, 1, trace)
    json.dumps(line)
    keys = list(line)
    assert keys[:4] == ["correct", "attempted", "failed", "metrics"]
    assert keys[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert line["attempted"] == TINY["n_iter"] * len(
        TINY["components"]) * len(line["report"]["jobs_s"])
    assert line["report"]["path"]["lane"] == "ell" and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        # no card: the device's metrics find nothing to read
        assert names == {"passes_per_replicate.factorize"}
    else:
        assert names == {"replicates_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]) == set(out["record"]["config"]["limits"])


def test_the_work_counts_match_a_hand_count():
    # R=2 replicates, 10 stored slots, 4 rows, k=3, 5 genes
    ops, nbytes = workcount.h_stats(2, 10, 4, 3, 5, "bf16")
    assert ops == 2 * 10 * 13 + 2 * 3 * 5
    assert nbytes == 10 * 4 + 2 * 4 * 3 * 2 + 2 * 3 * 5 * 2 + 2 * 4 * 3 * 4 \
        + 2 * 3 * 4
    ops, nbytes = workcount.w_numer(2, 10, 4, 3, 5, "bf16")
    assert ops == 2 * 10 * 13
    assert nbytes == 10 * 4 + 2 * 4 * 3 * 2 + 2 * 3 * 5 * 2 + 2 * 3 * 5 * 4
    t, by = workcount.least_seconds(ops, nbytes, "bf16")
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    t, by = workcount.least_seconds(1e12, 1.0, "f32")
    assert by == "ops" and t == pytest.approx(1e12 / 67e12)


def test_the_roofline_reader_prices_each_group_at_its_k():
    from portbench.harness.roofline import share_pct

    rec = {"config": {"num_highvar_genes": 5, "chain": "bf16"},
           "chunks": [(4, 10), (4, 10)],
           "profile": {"by_name": {"h_stats_kernel<16>": 1e-6}},
           "jobs": [{"groups": [{"k": 3, "R": 2, "launches": {"h_stats": 2}},
                                {"k": 2, "R": 2, "launches": {"h_stats": 1}}]
                     }]}
    least = (2 * workcount.least_seconds(*workcount.h_stats(2, 10, 4, 3, 5))[0]
             + workcount.least_seconds(*workcount.h_stats(2, 10, 4, 2, 5))[0])
    assert share_pct(rec, "h_stats", ("h_stats_kernel",)) == pytest.approx(
        100 * least / 1e-6)
    rec["profile"]["by_name"] = {}
    assert share_pct(rec, "h_stats", ("h_stats_kernel",)) is None


@pytest.mark.parametrize("cell,spectra_gap,objective_gap", [
    # float32 throughout: the same operations in the same order, the same
    # bits whatever the thread count
    ("pbmc10k-frob.factorize", 0.0, 1e-6),
    # the bf16 chain: a bf16 product's bits depend on how the CPU's GEMM
    # blocks it (R=4 lanes against the reference's one), and a flipped
    # rounding grows over the passes
    ("pbmc10k-kl.factorize", 2e-2, 1e-3)])
def test_the_reference_follows_the_ports_dense_path(cell, spectra_gap,
                                                    objective_gap):
    out = run_tiny(cell)
    nums = out["record"]["numbers"]
    assert out["record"]["jobs"][0]["path"]["lane"] == "dense"
    assert nums["path_mismatch"] == 0
    assert nums["hvg_mismatch"] == 0 and nums["missing"] == 0
    assert nums["spectra_gap_max"] <= spectra_gap
    assert nums["objective_gap_max"] <= objective_gap


def test_the_counts_file_is_the_10x_directory_the_port_reads(tmp_path):
    from cnmf_torch_tpu_torch.utils.io import load_counts

    kind = run.kind_module("factorize_jobs")
    counts = kind.make_counts(dict(cells=300, genes=700, programs_planted=5,
                                   umi_scale=30.0), 2 ** 31 + 5)
    counts[0, 0] = 1234.0
    fn = kind.write_10x(counts, str(tmp_path / "c"))
    got = load_counts(fn)
    assert got.X.format == "csr"
    assert (got.X != counts).nnz == 0
    assert list(got.var_names[:2]) == ["g0", "g1"]
    assert list(got.obs_names[-1:]) == ["c299"]


def test_the_reference_prepare_matches_the_ports(tmp_path):
    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.utils.io import load_matrix
    from portbench.reference import prepare

    kind = run.kind_module("factorize_jobs")
    counts = kind.make_counts(dict(cells=900, genes=2000, programs_planted=14,
                                   umi_scale=30.0), 3)
    fn = kind.write_10x(counts, str(tmp_path / "c"))
    obj = cNMF(str(tmp_path), "r", device="cpu")
    obj.prepare(fn, components=[5], n_iter=2, seed=1,
                beta_loss="kullback-leibler", num_highvar_genes=400)
    got = load_matrix(obj.paths["normalized_counts"])
    X, hvg = prepare.normalize(counts.toarray(), 400)
    assert [f"g{i}" for i in hvg] == [str(v) for v in got.var_names]
    np.testing.assert_allclose(got.X.toarray(), X, rtol=2e-7, atol=0)
