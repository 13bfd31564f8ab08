"""The port's pass checkpoints (``runtime/checkpoint.py``) and the
checkpointed row-sharded loop, against the JAX package's.

A checkpoint either package writes loads in the other with the same
state and identity; identity mismatches, a wrong shape and a truncated
file are torn, never trusted; the knobs parse as the JAX package's. The
solver's one host loop gives the same bits with checkpointing on or off;
a resume with H in the checkpoint is bit for bit the uninterrupted run
(without H, within 5% of its objective, the JAX test's band); a torn
checkpoint restarts the replicate from scratch. At the pipeline level,
factorize writes and discards its checkpoints, and a CLI factorize
killed at a pass boundary resumes to the uninterrupted run's bytes.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cnmf_torch_tpu.runtime import checkpoint as jck
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded
from cnmf_torch_tpu_torch.runtime import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture()
def X():
    rng = np.random.default_rng(0)
    return (rng.gamma(0.8, 1.0, size=(64, 24))
            * rng.binomial(1, 0.4, size=(64, 24))).astype(np.float32)


def _meta(digest, **kw):
    meta = dict(k=3, iter=0, seed=7, attempt=0, digest=digest, beta=2.0)
    meta.update(kw)
    return meta


class _Interrupt(Exception):
    """Stands in for a SIGKILL in process: raised after a checkpoint write
    lands, the state a preemption leaves."""


class _KillAt(ck.PassCheckpointer):
    def __init__(self, *a, kill_pass, **kw):
        super().__init__(*a, **kw)
        self._kill_pass = kill_pass

    def save(self, *, pass_idx, **kw):
        super().save(pass_idx=pass_idx, **kw)
        if pass_idx == self._kill_pass:
            raise _Interrupt


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, t, **kw):
        self.events.append(dict(kw, t=t))


def _save(mod, path, with_h, digest="d1"):
    rng = np.random.default_rng(1)
    W = np.abs(rng.normal(size=(3, 24))).astype(np.float32)
    H = np.abs(rng.normal(size=(10, 3))).astype(np.float32)
    mod.save_pass_checkpoint(
        path, k=3, it=0, seed=7, attempt=0, digest=digest, beta=2.0,
        pass_idx=4, err_prev=np.float32(5.5), err=np.float32(4.5),
        trace=np.arange(8, dtype=np.float32), W=W,
        A=np.ones((3, 24), np.float32), B=np.eye(3, dtype=np.float32),
        H=H if with_h else None, params="sig")
    return W, H


# ---------------------------------------------------------------------------
# knobs and files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [None, "0", "3", "-1", "often"])
def test_cadence_knob_parses_as_the_jax_package(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CNMF_TPU_CKPT_EVERY_PASSES", raising=False)
    else:
        monkeypatch.setenv("CNMF_TPU_CKPT_EVERY_PASSES", value)
    try:
        want = jck.ckpt_every_passes()
    except ValueError:
        with pytest.raises(ValueError, match="CNMF_TPU_CKPT_EVERY_PASSES"):
            ck.ckpt_every_passes()
        return
    assert ck.ckpt_every_passes() == want


@pytest.mark.parametrize("name,fn", [
    ("CNMF_TPU_CKPT_H_BYTES", "ckpt_h_budget_bytes"),
    ("CNMF_TPU_CKPT_MIN_INTERVAL_S", "ckpt_min_interval_s")])
def test_budget_and_interval_knobs(monkeypatch, name, fn):
    monkeypatch.delenv(name, raising=False)
    assert getattr(ck, fn)() == getattr(jck, fn)()
    monkeypatch.setenv(name, "12")
    assert getattr(ck, fn)() == getattr(jck, fn)() == 12
    monkeypatch.setenv(name, "x")
    with pytest.raises(ValueError, match=name):
        getattr(ck, fn)()


@pytest.mark.parametrize("writer,reader", [(ck, jck), (jck, ck), (ck, ck)])
@pytest.mark.parametrize("with_h", [False, True])
def test_a_checkpoint_loads_in_either_package(tmp_path, writer, reader,
                                              with_h):
    path = str(tmp_path / "a.ckpt.npz")
    W, H = _save(writer, path, with_h)
    meta = dict(_meta("d1"), params="sig")
    state = reader.load_pass_checkpoint(path, expect=meta, n_genes=24,
                                        n_rows=10)
    assert state["pass_idx"] == 4 and state["err"] == np.float32(4.5)
    assert state["err_prev"] == np.float32(5.5)
    np.testing.assert_array_equal(state["W"], W)
    np.testing.assert_array_equal(state["trace"], np.arange(8))
    np.testing.assert_array_equal(state["B"], np.eye(3))
    if with_h:
        np.testing.assert_array_equal(state["H"], H)
    else:
        assert state["H"] is None
    with np.load(path) as f:
        assert sorted(f.files) == sorted(
            ["schema", "k", "iter", "seed", "attempt", "digest", "beta",
             "params", "pass_idx", "err_prev", "err", "trace", "W", "A",
             "B"] + (["H"] if with_h else []))


@pytest.mark.parametrize("bad,match", [
    ({"seed": 8}, "seed"), ({"k": 4}, "k="), ({"beta": 1.0}, "beta"),
    ({"digest": "other"}, "digest"), ({"params": "tol=1e-5"}, "params"),
    ({"attempt": 1}, "attempt"), ({"iter": 2}, "iter")])
def test_identity_mismatches_are_torn(tmp_path, bad, match):
    path = str(tmp_path / "a.ckpt.npz")
    _save(ck, path, True)
    meta = dict(_meta("d1"), params="sig")
    meta.update(bad)
    with pytest.raises(ck.TornCheckpointError, match=match):
        ck.load_pass_checkpoint(path, expect=meta)


def test_shapes_and_truncation_are_torn(tmp_path):
    path = str(tmp_path / "a.ckpt.npz")
    _save(ck, path, True)
    with pytest.raises(ck.TornCheckpointError, match="gene"):
        ck.load_pass_checkpoint(path, n_genes=25)
    with pytest.raises(ck.TornCheckpointError, match="H shape"):
        ck.load_pass_checkpoint(path, n_rows=11)
    assert ck.load_pass_checkpoint(path, n_rows_min=9)["H"].shape == (10, 3)
    with pytest.raises(ck.TornCheckpointError, match="H shape"):
        ck.load_pass_checkpoint(path, n_rows_min=11)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 3))
    state, reason = ck.probe_pass_checkpoint(path)
    assert state is None and "unreadable" in reason
    assert ck.probe_pass_checkpoint(str(tmp_path / "nope.npz"))[1] == \
        "missing"


def test_min_interval_floors_the_write_rate(tmp_path, monkeypatch):
    saves = []
    monkeypatch.setattr(ck, "save_pass_checkpoint",
                        lambda path, **kw: saves.append(kw["pass_idx"]))
    kw = dict(err_prev=1.0, err=0.5, trace=np.zeros(2, np.float32),
              W=np.ones((3, 4), np.float32), A=np.zeros((3, 4), np.float32),
              B=np.zeros((3, 3), np.float32))
    c = ck.PassCheckpointer(str(tmp_path / "m.ckpt.npz"), 1,
                            meta=_meta("d"), min_interval_s=3600.0)
    assert c.due()
    c.save(pass_idx=1, **kw)
    assert not c.due()
    c.save(pass_idx=2, **kw)
    assert saves == [1]
    c0 = ck.PassCheckpointer(str(tmp_path / "n.ckpt.npz"), 1,
                             meta=_meta("d"), min_interval_s=0.0)
    c0.save(pass_idx=1, **kw)
    c0.save(pass_idx=2, **kw)
    assert saves == [1, 1, 2]


def test_a_fresh_run_discards_a_stale_checkpoint(tmp_path):
    path = str(tmp_path / "b.ckpt.npz")
    with open(path, "wb") as f:
        f.write(b"stale")
    ck.PassCheckpointer(path, 1, meta=_meta("d"), resume=False)
    assert not os.path.exists(path)


def test_the_torn_and_kill_hooks_fire_at_the_write(tmp_path, monkeypatch):
    """``torn:artifact=ckpt`` truncates the checkpoint just written and
    ``kill:stage=pass`` fires after it (the kill itself runs in the CLI
    test below)."""
    from cnmf_torch_tpu_torch.runtime import faults

    kills = []
    monkeypatch.setattr(faults, "maybe_kill",
                        lambda stage, worker=None: kills.append(stage))
    monkeypatch.setenv("CNMF_TPU_FAULT_SPEC", "torn:artifact=ckpt,after=1")
    path = str(tmp_path / "x.ckpt.k_3.iter_0.npz")
    c = ck.PassCheckpointer(path, 1, meta=_meta("d"))
    kw = dict(err_prev=1.0, err=0.5, trace=np.zeros(2, np.float32),
              W=np.ones((3, 4), np.float32), A=np.zeros((3, 4), np.float32),
              B=np.zeros((3, 3), np.float32))
    c.save(pass_idx=1, **kw)
    assert ck.probe_pass_checkpoint(path)[0] is not None
    c.save(pass_idx=2, **kw)
    assert "unreadable" in ck.probe_pass_checkpoint(path)[1]
    assert kills == ["pass", "pass"]


# ---------------------------------------------------------------------------
# the checkpointed loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_checkpointing_on_or_off_gives_the_same_bits(tmp_path, X,
                                                     beta_loss):
    H0, W0, e0 = nmf_fit_rowsharded(X, 3, beta_loss=beta_loss, seed=7,
                                    n_passes=12, device="cpu")
    ckpt = ck.PassCheckpointer(str(tmp_path / "c.ckpt.npz"), 1,
                               meta=_meta(ck.input_digest(X)))
    H1, W1, e1 = nmf_fit_rowsharded(X, 3, beta_loss=beta_loss, seed=7,
                                    n_passes=12, checkpoint=ckpt,
                                    device="cpu")
    np.testing.assert_array_equal(W1, W0)
    np.testing.assert_array_equal(H1, H0)
    assert e1 == e0


@pytest.mark.parametrize("kill_pass", [1, 4, 11])
def test_an_interrupted_run_resumes_bit_for_bit(tmp_path, X, kill_pass):
    dig = ck.input_digest(X)
    path = str(tmp_path / "d.ckpt.npz")
    H1, W1, e1 = nmf_fit_rowsharded(X, 3, seed=7, n_passes=12, device="cpu")
    killer = _KillAt(path, 1, meta=_meta(dig), kill_pass=kill_pass)
    with pytest.raises(_Interrupt):
        nmf_fit_rowsharded(X, 3, seed=7, n_passes=12, checkpoint=killer,
                           device="cpu")
    events = _Events()
    resumer = ck.PassCheckpointer(path, 1, meta=_meta(dig), resume=True,
                                  events=events)
    H2, W2, e2 = nmf_fit_rowsharded(X, 3, seed=7, n_passes=12,
                                    checkpoint=resumer, device="cpu")
    np.testing.assert_array_equal(W2, W1)
    np.testing.assert_array_equal(H2, H1)
    assert e2 == e1
    resumes = [e for e in events.events
               if e["t"] == "checkpoint" and e["action"] == "resume"]
    assert len(resumes) == 1
    assert resumes[0]["context"]["pass_idx"] == kill_pass
    assert resumes[0]["context"]["with_h"] is True


def test_a_resume_without_h_is_within_tolerance(tmp_path, X):
    dig = ck.input_digest(X)
    meta = _meta(dig, beta=1.0)
    _, W1, e1 = nmf_fit_rowsharded(X, 3, beta_loss="kullback-leibler",
                                   seed=7, n_passes=8, device="cpu")
    path = str(tmp_path / "g.ckpt.npz")
    killer = _KillAt(path, 1, meta=meta, h_budget_bytes=0, kill_pass=3)
    with pytest.raises(_Interrupt):
        nmf_fit_rowsharded(X, 3, beta_loss="kullback-leibler", seed=7,
                           n_passes=8, checkpoint=killer, device="cpu")
    resumer = ck.PassCheckpointer(path, 1, meta=meta, resume=True,
                                  h_budget_bytes=0)
    _, W2, e2 = nmf_fit_rowsharded(X, 3, beta_loss="kullback-leibler",
                                   seed=7, n_passes=8, checkpoint=resumer,
                                   device="cpu")
    assert abs(e2 - e1) / max(e1, 1e-9) < 0.05
    assert np.isfinite(W2).all() and (W2 >= 0).all()


def test_a_torn_checkpoint_restarts_from_scratch(tmp_path, X):
    dig = ck.input_digest(X)
    _, W1, e1 = nmf_fit_rowsharded(X, 3, seed=7, n_passes=12, device="cpu")
    path = str(tmp_path / "i.ckpt.npz")
    killer = _KillAt(path, 1, meta=_meta(dig), kill_pass=4)
    with pytest.raises(_Interrupt):
        nmf_fit_rowsharded(X, 3, seed=7, n_passes=12, checkpoint=killer,
                           device="cpu")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 3))
    events = _Events()
    resumer = ck.PassCheckpointer(path, 1, meta=_meta(dig), resume=True,
                                  events=events)
    with pytest.warns(RuntimeWarning, match="restarts from scratch"):
        _, W2, e2 = nmf_fit_rowsharded(X, 3, seed=7, n_passes=12,
                                       checkpoint=resumer, device="cpu")
    np.testing.assert_array_equal(W2, W1)
    assert e2 == e1
    faults = [e for e in events.events if e["t"] == "fault"]
    assert faults and faults[0]["kind"] == "torn_artifact"
    assert not any(e["t"] == "checkpoint" and e["action"] == "resume"
                   for e in events.events)


def test_the_port_resumes_a_jax_written_cursor(tmp_path, X):
    """A checkpoint the JAX package wrote (same identity, same shapes)
    resumes the port's loop: the state is the file's."""
    dig = ck.input_digest(X)
    path = str(tmp_path / "j.ckpt.npz")
    rng = np.random.default_rng(5)
    W = (np.abs(rng.normal(size=(3, 24))) + 0.1).astype(np.float32)
    H = (np.abs(rng.normal(size=(64, 3))) + 0.1).astype(np.float32)
    jck.save_pass_checkpoint(
        path, k=3, it=0, seed=7, attempt=0, digest=dig, beta=2.0,
        pass_idx=12, err_prev=np.float32(2.0), err=np.float32(1.0),
        trace=np.zeros(64, np.float32), W=W,
        A=np.zeros((3, 24), np.float32), B=np.zeros((3, 3), np.float32),
        H=H)
    resumer = ck.PassCheckpointer(path, 1, meta=_meta(dig), resume=True)
    Hr, Wr, er = nmf_fit_rowsharded(X, 3, seed=7, n_passes=12,
                                    checkpoint=resumer, device="cpu")
    # the cursor is at the cap: nothing runs, the file's state comes back
    np.testing.assert_array_equal(Wr, W)
    np.testing.assert_array_equal(Hr, H)
    assert er == 1.0


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _counts_file(tmp_path, n=60, g=100):
    rng = np.random.default_rng(3)
    counts = rng.binomial(40, 0.02, size=(n, g)).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


def test_factorize_writes_and_discards_its_checkpoints(tmp_path,
                                                       monkeypatch):
    saves = []
    orig_save = ck.save_pass_checkpoint

    def spy(path, **kw):
        saves.append(kw["pass_idx"])
        return orig_save(path, **kw)

    monkeypatch.setattr(ck, "save_pass_checkpoint", spy)
    fn = _counts_file(tmp_path)
    obj = cNMF(str(tmp_path), "ckpl", device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=4, num_highvar_genes=50,
                total_workers=1)
    obj.factorize(rowshard=True)
    assert saves, "no checkpoint written under the default cadence"
    for it in range(2):
        assert os.path.exists(obj.paths["iter_spectra"] % (3, it))
    assert not glob.glob(str(tmp_path / "ckpl" / "cnmf_tmp" / "*.ckpt.*"))
    saves.clear()
    monkeypatch.setenv("CNMF_TPU_CKPT_EVERY_PASSES", "0")
    obj2 = cNMF(str(tmp_path), "ckoff", device="cpu")
    obj2.prepare(fn, components=[3], n_iter=2, seed=4, num_highvar_genes=50,
                 total_workers=1)
    obj2.factorize(rowshard=True)
    assert not saves
    for it in range(2):
        with open(obj.paths["iter_spectra"] % (3, it), "rb") as a, \
                open(obj2.paths["iter_spectra"] % (3, it), "rb") as b:
            assert a.read() == b.read()


def test_a_cli_factorize_killed_at_a_pass_resumes_bit_for_bit(tmp_path):
    """``kill:stage=pass`` SIGKILLs a CLI factorize after its fourth pass
    checkpoint; ``--skip-completed-runs`` resumes the replicate from it
    and writes the uninterrupted run's bytes."""
    fn = _counts_file(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("CNMF_TPU_FAULT_SPEC", None)
    base = [sys.executable, "-m", "cnmf_torch_tpu_torch"]

    def cli(name, *args, extra=None):
        return subprocess.run(
            base + list(args) + ["--output-dir", str(tmp_path), "--name",
                                 name, "--device", "cpu"],
            env=dict(env, **(extra or {})), capture_output=True, text=True,
            timeout=300)

    for name in ("clean", "killed"):
        proc = cli(name, "prepare", "-c", fn, "-k", "3", "-n", "2",
                   "--seed", "4", "--numgenes", "50",
                   "--beta-loss", "kullback-leibler")
        assert proc.returncode == 0, proc.stderr[-2000:]
    proc = cli("clean", "factorize", "--rowshard")
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = cli("killed", "factorize", "--rowshard",
               extra={"CNMF_TPU_FAULT_SPEC": "kill:stage=pass,after=3"})
    assert proc.returncode == -9, proc.stderr[-2000:]
    tmp = tmp_path / "killed" / "cnmf_tmp"
    assert os.path.exists(tmp / "killed.ckpt.k_3.iter_0.npz")
    proc = cli("killed", "factorize", "--rowshard", "--skip-completed-runs",
               extra={"CNMF_TPU_TELEMETRY": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    for it in range(2):
        with open(tmp_path / "clean" / "cnmf_tmp"
                  / f"clean.spectra.k_3.iter_{it}.df.npz", "rb") as a, \
                open(tmp / f"killed.spectra.k_3.iter_{it}.df.npz",
                     "rb") as b:
            assert np.array_equal(np.load(a)["data"], np.load(b)["data"])
    from cnmf_torch_tpu_torch.utils.telemetry import read_events

    events = read_events(str(tmp / "killed.events.jsonl"))
    resumes = [e["context"] for e in events
               if e["t"] == "checkpoint" and e["action"] == "resume"]
    assert [r["pass_idx"] for r in resumes] == [4]
