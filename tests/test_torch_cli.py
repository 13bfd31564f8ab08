"""The port's CLI against the JAX package's: the ``k_selection_plot``
command (fault F3), the ``report`` and ``trace`` renderers with their
optional ``run_dir`` positional, and the refusal of a stray positional on
any other command."""

import json
import os

import numpy as np
import pytest
import torch

from cnmf_torch_tpu import load_df_from_npz as jax_load_df
from cnmf_torch_tpu.cli import main as jax_cli
from cnmf_torch_tpu_torch import Frame, save_df_to_npz
from cnmf_torch_tpu_torch.cli import main as port_cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _counts_fn(tmp, n=80, g=90, seed=5):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(3) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(3, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * 250.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """prepare -> factorize -> combine -> k_selection_plot through the
    port's CLI, with telemetry on."""
    tmp = str(tmp_path_factory.mktemp("cli"))
    base = ["--output-dir", tmp, "--name", "run", "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        for key in ("CNMF_TPU_TELEMETRY", "CNMF_TPU_TRACE_SAMPLE"):
            mp.setenv(key, "1")
        port_cli(["prepare", "-c", _counts_fn(tmp), "-k", "3", "4",
                  "-n", "3", "--seed", "2", "--numgenes", "60",
                  "--beta-loss", "kullback-leibler", "--max-nmf-iter", "60",
                  *base])
        port_cli(["factorize", *base])
        port_cli(["combine", *base])
        port_cli(["k_selection_plot", *base])
    return os.path.join(tmp, "run")


def test_f3_k_selection_plot_command(cli_run, capsys):
    """Fault F3: the port's CLI had no ``k_selection_plot`` command
    (argparse exited 2). It writes the K-selection statistics as the JAX
    package does before its figure, readable by the JAX package."""
    path = os.path.join(cli_run, "run.k_selection_stats.df.npz")
    stats = jax_load_df(path)
    assert list(stats.columns) == ["k", "local_density_threshold",
                                   "silhouette", "prediction_error"]
    assert stats["k"].tolist() == [3.0, 4.0]
    assert np.isfinite(stats.values).all()
    events = os.path.join(cli_run, "cnmf_tmp", "run.events.jsonl")
    with open(events) as f:
        stages = [json.loads(ln).get("stage") for ln in f
                  if '"t":"stage"' in ln]
    assert "k_selection_plot" in stages


@pytest.mark.parametrize("argv", [["report"], ["report", "--json"],
                                  ["--json", "report"], ["trace"]])
def test_report_and_trace_print_what_the_jax_cli_prints(cli_run, capsys,
                                                        argv):
    outs = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        cli(argv + [cli_run])
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    if "trace" in argv:
        assert "factorize.worker" in outs["port"]
    elif "--json" in argv:
        assert json.loads(outs["port"])["event_files"] == 1
    else:
        assert "Replicate convergence" in outs["port"]


def test_report_defaults_to_output_dir_and_name(cli_run, capsys):
    port_cli(["report", "--output-dir", os.path.dirname(cli_run),
              "--name", "run"])
    assert "Stage waterfall" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["report", "/no/such/run"],
                                  ["trace", "/no/such/run"]])
def test_report_and_trace_refuse_a_missing_run_dir(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        port_cli(argv)
    assert exc.value.code == 2
    assert "run directory not found" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["consensus", "9"],
                                  ["factorize", "extra"],
                                  ["k_selection_plot", "x"]])
def test_cli_rejects_stray_positional_for_non_report(argv, capsys):
    """As ``tests/test_telemetry.py`` requires of the JAX CLI: the
    optional positional serves ``report`` and ``trace`` only."""
    for cli in (port_cli, jax_cli):
        with pytest.raises(SystemExit) as exc:
            cli(argv)
        assert exc.value.code == 2
        assert "unrecognized argument" in capsys.readouterr().err
