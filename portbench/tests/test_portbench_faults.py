"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven, once
for each fault a factorize cell can have (one card: no exchange between
cards to leave out). On the CPU at a tiny size; on a card, at the cell's
own size with as many replicates compared as a run of the cell compares."""

import json
import time

import numpy as np
import pytest

from _tiny import run_tiny
from portbench import run

CELLS = ["pbmc10k-kl.factorize", "pbmc10k-frob.factorize"]


def _state_unchanged(monkeypatch):
    """Every spectra step returns its state unchanged."""
    from cnmf_torch_tpu_torch.ops import nmf

    monkeypatch.setattr(nmf, "_update_W", lambda X, H, W, *a, **k: W)
    monkeypatch.setattr(nmf, "_solve_w_from_stats",
                        lambda W, *a, **k: W)


def _half_left_out(monkeypatch):
    """The solver sees the first half of the cells twice and never the
    second half: half of the batch left out, the rest counted in its
    place."""
    from cnmf_torch_tpu_torch.ops import nmf

    orig = nmf._chunk

    def first_half(Xc, c):
        n_chunks = (Xc.vals if hasattr(Xc, "vals") else Xc).shape[0]
        return orig(Xc, c % max(1, n_chunks // 2))
    monkeypatch.setattr(nmf, "_chunk", first_half)


def _altered_from(share: float):
    """Each sweep's spectra altered where they are produced, in the lanes
    from ``share`` of the sweep on: the first program of each such
    replicate half as large again."""
    def plant(monkeypatch):
        from cnmf_torch_tpu_torch.models import cnmf

        orig = cnmf.replicate_sweep

        def altered(*a, **kw):
            spectra, usages, errs = orig(*a, **kw)
            spectra = np.array(spectra)
            spectra[int(share * spectra.shape[0]):, 0] *= 1.5
            return spectra, usages, errs
        monkeypatch.setattr(cnmf, "replicate_sweep", altered)
    return plant


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _altered_from(0.0),
          # a fault past a tile boundary: lanes 64-99 of 100
          "upper_lanes_altered": _altered_from(0.64)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    # every replicate compared, so that a fault in some lanes is sampled
    out = run_tiny(cell, seed=31, per_k=4)
    assert out["correct"] is False, out["record"]["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_path_is_correct(cell):
    out = run_tiny(cell, seed=31, per_k=4)
    assert out["correct"] is True, out["record"]["numbers"]


def test_a_fault_in_a_few_lanes_passes_the_medians():
    """The lanes from 64 of 100 on are a minority: the medians hold there,
    and only the share of outlying replicates can see the fault."""
    gaps = [0.002] * 64 + [0.2] * 36
    assert np.median(gaps) == 0.002
    spec = run.resolve(run.load_benchmark(), "pbmc10k-kl.factorize")
    cfg = spec["config"]
    assert np.median(gaps) <= cfg["limits"]["spectra_gap_median"]
    share = 100.0 * sum(g > cfg["outlier_gap"] for g in gaps) / len(gaps)
    assert share > cfg["limits"]["spectra_outlier_pct"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS) + ["none"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_at_the_cells_size(cell, fault, monkeypatch):
    """One job at the cell's own size on the card, with five replicates
    of each K compared (a run of the cell compares one of each K a job
    over about five jobs); prints the numbers."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the cell's own size runs on a CUDA card")
    if fault != "none":
        FAULTS[fault](monkeypatch)
    spec = run.resolve(run.load_benchmark(), cell)
    spec["traffic"] = dict(spec["traffic"], sample_per_job_per_k=5)
    out = run.run_cell(spec, 3_000_000_017, 0.01, False, "cuda:0",
                       time.time())
    print("reading", json.dumps({"cell": cell, "fault": fault,
                                 "correct": out["correct"],
                                 "numbers": out["record"]["numbers"]}))
    assert out["correct"] is (fault == "none"), out["record"]["numbers"]
