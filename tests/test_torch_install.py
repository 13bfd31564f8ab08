"""The port as an install: a wheel of the repo, installed with ``pip
install --no-deps --no-index --target``, against the checkout.

Every build runs on a copy of the tree under ``tmp_path``, never in the
repo. The wheel must carry every file of ``cnmf_torch_tpu_torch/`` (found
by walking the package, so a subpackage missing from ``pyproject.toml``
fails here) and the ``cnmf-tpu-torch`` console script. The installed copy
is run from a working directory outside the repo with ``PYTHONPATH`` set
to the install target only: it builds into its own package directory,
refuses a build directory it cannot write, runs the main path through its
console script to the checkout's consensus artifacts byte for byte, and
its ``run_parallel`` workers import it. The deployment guide's commands
parse against the port's CLI.
"""

import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import types
import zipfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cnmf_torch_tpu_torch")
WHEEL_FILES = ("pyproject.toml", "README.md", "cnmf_torch_tpu",
               "cnmf_torch_tpu_torch")
# what a checkout holds that is not source: never in a wheel
NOT_SOURCE_DIRS = {"__pycache__", "build"}
NOT_SOURCE_SUFFIXES = (".pyc", ".so", ".tmp", ".log")
GUIDE = os.path.join(PORT, "deploy", "README.md")
DOCKERFILE = os.path.join(PORT, "deploy", "Dockerfile")
# the data files named in pyproject.toml's package-data
DATA_FILES = ["KNOBS.md", "csrc/kl_ell.cu", "native/mtx_reader.cpp",
              "analysis/baseline.json", "deploy/Dockerfile",
              "deploy/README.md", "examples/__init__.py"]

# the main path's small run: two Ks, three replicates
KS = ["3", "4"]
STEPS = [
    ["prepare", "-k", *KS, "-n", "3", "--seed", "14", "--beta-loss",
     "kullback-leibler", "--numgenes", "200", "--max-nmf-iter", "100"],
    ["factorize"],
    ["combine"],
    # three replicates: two neighbours a spectrum
    ["consensus", "-k", "3", "--local-density-threshold", "2.0",
     "--local-neighborhood-size", "0.67"],
    ["k_selection_plot"],
]
CONSENSUS = ("spectra.k_3.dt_2_0.consensus.df.npz",
             "usages.k_3.dt_2_0.consensus.df.npz",
             "gene_spectra_score.k_3.dt_2_0.df.npz",
             "gene_spectra_tpm.k_3.dt_2_0.df.npz",
             "starcat_spectra.k_3.dt_2_0.df.npz",
             "local_density_cache.k_3.merged.df.npz",
             "spectra.k_3.merged.df.npz", "spectra.k_4.merged.df.npz")


def _port_files() -> set:
    """Every source and data file of the checkout's port, relative to the
    repo root."""
    out = set()
    for d, dirs, files in os.walk(PORT):
        dirs[:] = [x for x in dirs if x not in NOT_SOURCE_DIRS]
        for f in files:
            if not f.endswith(NOT_SOURCE_SUFFIXES):
                out.add(os.path.relpath(os.path.join(d, f), ROOT)
                        .replace(os.sep, "/"))
    return out


def _run(cmd, cwd, env=None, timeout=300):
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, (cmd, proc.stdout[-3000:],
                                  proc.stderr[-3000:])
    return proc.stdout


def _env(site, **extra):
    """A child's environment: ``PYTHONPATH`` the install target only, one
    torch thread (the checkout's run below uses one too)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=site, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               **extra)
    return env


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """A copy of the tree, its wheel, and the wheel installed with
    ``--target``; ``work`` is an empty working directory outside the
    repo."""
    root = tmp_path_factory.mktemp("install")
    src, dist = root / "src", root / "dist"
    src.mkdir()
    skip = shutil.ignore_patterns(*NOT_SOURCE_DIRS, "*.so", "*.egg-info")
    for name in WHEEL_FILES:
        path = os.path.join(ROOT, name)
        if os.path.isdir(path):
            shutil.copytree(path, src / name, ignore=skip)
        else:
            shutil.copy2(path, src)
    _run([sys.executable, "-m", "pip", "wheel", "--no-deps",
          "--no-build-isolation", "--no-index", "-q", "-w", str(dist),
          str(src)], cwd=str(src))
    (wheel,) = dist.glob("*.whl")
    site = root / "site"
    _run([sys.executable, "-m", "pip", "install", "--no-deps",
          "--no-index", "-q", "--target", str(site), str(wheel)],
         cwd=str(root))
    work = root / "work"
    work.mkdir()
    return types.SimpleNamespace(root=str(root), src=str(src),
                                 wheel=str(wheel), site=str(site),
                                 work=str(work),
                                 pkg=str(site / "cnmf_torch_tpu_torch"))


# -- the wheel -----------------------------------------------------------


def test_the_wheel_carries_every_file_of_the_port(installed):
    with zipfile.ZipFile(installed.wheel) as z:
        names = set(z.namelist())
    missing = sorted(_port_files() - names)
    assert not missing, missing
    # nothing built in a checkout rides along
    assert not [n for n in names if n.endswith(".so") or "/build/" in n]


@pytest.mark.parametrize("rel", DATA_FILES)
def test_the_wheel_carries_the_ports_data_files(installed, rel):
    with zipfile.ZipFile(installed.wheel) as z:
        assert f"cnmf_torch_tpu_torch/{rel}" in z.namelist()
    assert os.path.isfile(os.path.join(installed.pkg, rel))


def _entry_points(wheel) -> dict:
    with zipfile.ZipFile(wheel) as z:
        (name,) = [n for n in z.namelist()
                   if n.endswith(".dist-info/entry_points.txt")]
        text = z.read(name).decode()
    section, out = None, {}
    for line in text.splitlines():
        if line.startswith("["):
            section = line.strip("[]")
        elif "=" in line:
            key, val = (t.strip() for t in line.split("=", 1))
            out[(section, key)] = val
    return out


@pytest.mark.parametrize("script,target", [
    ("cnmf-tpu-torch", "cnmf_torch_tpu_torch.cli:main"),
    ("cnmf-tpu", "cnmf_torch_tpu.cli:main"),
])
def test_the_wheel_installs_both_commands(installed, script, target):
    assert _entry_points(installed.wheel)[("console_scripts", script)] \
        == target
    assert os.access(os.path.join(installed.site, "bin", script), os.X_OK)


# -- the installed copy --------------------------------------------------

PROBE = r"""
import json, os, sys
import cnmf_torch_tpu_torch, cnmf_torch_tpu_torch.examples as ex
from cnmf_torch_tpu_torch import native
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.utils import builddir
out = dict(package=cnmf_torch_tpu_torch.__file__, examples=ex.__file__,
           kernels=kl_ell.BUILD_DIR, native=native.BUILD_DIR,
           kernel_source=kl_ell.SOURCE, native_source=native.SOURCE,
           build_root=builddir.BUILD_ROOT)
# a build directory under a regular file cannot be created, even by root
blocker = os.path.join(sys.argv[1], "not_a_directory")
open(blocker, "w").close()
for name, fn in (("kernels", kl_ell.build),
                 ("native", lambda: native._build(native._lib_path()))):
    mod = kl_ell if name == "kernels" else native
    mod.BUILD_DIR = os.path.join(blocker, name)
    try:
        fn()
        out[name + "_error"] = None
    except RuntimeError as exc:
        out[name + "_error"] = str(exc)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe(installed):
    """What the installed copy says of itself, imported by a child whose
    working directory is outside the repo."""
    out = _run([sys.executable, "-c", PROBE, installed.work],
               cwd=installed.work, env=_env(installed.site))
    return json.loads(out.splitlines()[-1])


@pytest.mark.parametrize("key", ["package", "examples", "kernel_source",
                                 "native_source"])
def test_the_installed_copy_imports_from_the_target(installed, probe, key):
    assert probe[key].startswith(installed.pkg + os.sep)


@pytest.mark.parametrize("kind", ["kernels", "native"])
def test_build_directories_lie_inside_the_installed_package(installed,
                                                            probe, kind):
    assert probe[kind] == os.path.join(installed.pkg, "build", kind)
    assert probe["build_root"] == os.path.join(installed.pkg, "build")
    # never the shared site-packages/build (another package's import dir)
    assert not probe[kind].startswith(
        os.path.join(installed.site, "build") + os.sep)


@pytest.mark.parametrize("kind,what", [
    ("kernels", "the CUDA kernels are built at first use"),
    ("native", "the .mtx reader is built at first use"),
])
def test_an_unwritable_build_directory_raises_with_its_name(installed,
                                                            probe, kind,
                                                            what):
    """No nvcc runs: the directory is refused first."""
    err = probe[kind + "_error"]
    assert err is not None
    assert os.path.join(installed.work, "not_a_directory", kind) in err
    assert what in err


def test_the_checkout_build_directories_follow_the_same_rule():
    from cnmf_torch_tpu_torch import native
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    assert kl_ell.BUILD_DIR == os.path.join(PORT, "build", "kernels")
    assert native.BUILD_DIR == os.path.join(PORT, "build", "native")


def test_an_unwritable_kernel_directory_raises_in_process(tmp_path,
                                                          monkeypatch):
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    blocker = tmp_path / "file"
    blocker.write_text("")
    target = str(blocker / "kernels")
    monkeypatch.setattr(kl_ell, "BUILD_DIR", target)
    monkeypatch.setattr(kl_ell, "_lib", None)
    with pytest.raises(RuntimeError, match=re.escape(target)):
        kl_ell.build()


def test_the_console_script_help(installed):
    out = _run([os.path.join(installed.site, "bin", "cnmf-tpu-torch"),
                "--help"], cwd=installed.work, env=_env(installed.site))
    # argparse names the command the user typed
    assert out.startswith("usage: cnmf-tpu-torch ")


def test_python_m_keeps_its_own_name(monkeypatch):
    from cnmf_torch_tpu_torch import cli

    monkeypatch.setattr(sys, "argv", [os.path.join(PORT, "__main__.py")])
    assert cli.build_parser().prog == "python -m cnmf_torch_tpu_torch"
    monkeypatch.setattr(sys, "argv", ["/x/bin/cnmf-tpu-torch"])
    assert cli.build_parser().prog == "cnmf-tpu-torch"


# -- the main path through the installed console script ------------------


def _counts(path, n=240, g=400, seed=3):
    from cnmf_torch_tpu_torch import Frame, save_df_to_npz

    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(4) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(4, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * 60.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), path)
    return path


def _consensus_bytes(run_dir, name) -> dict:
    out = {}
    for leaf in CONSENSUS:
        with np.load(os.path.join(run_dir, "cnmf_tmp", f"{name}.{leaf}"),
                     allow_pickle=True) as f:
            out[leaf] = tuple(np.asarray(f[k]).tobytes() for k in f.files)
    return out


@pytest.fixture(scope="module")
def main_paths(installed, tmp_path_factory):
    """The small main path twice: through the installed console script
    from a working directory outside the repo (telemetry on), and through
    the checkout's CLI in this process, on one torch thread each."""
    import torch

    from cnmf_torch_tpu_torch.cli import main as port_cli

    d = tmp_path_factory.mktemp("main_paths")
    counts = _counts(str(d / "counts.df.npz"))
    script = os.path.join(installed.site, "bin", "cnmf-tpu-torch")
    env = _env(installed.site, CNMF_TPU_TELEMETRY="1")
    where = ["--output-dir", installed.work, "--name", "inst",
             "--device", "cpu"]
    for step in STEPS:
        argv = step + (["-c", counts] if step[0] == "prepare" else [])
        _run([script, *argv, *where], cwd=installed.work, env=env)
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("CNMF_TPU_TELEMETRY", raising=False)
            for step in STEPS:
                argv = step + (["-c", counts] if step[0] == "prepare"
                               else [])
                port_cli([*argv, "--output-dir", str(d), "--name", "ckout",
                          "--device", "cpu"])
    finally:
        torch.set_num_threads(previous)
    return (os.path.join(installed.work, "inst"),
            os.path.join(str(d), "ckout"))


def test_installed_main_path_matches_the_checkout_byte_for_byte(main_paths):
    inst, ckout = main_paths
    mine, theirs = (_consensus_bytes(inst, "inst"),
                    _consensus_bytes(ckout, "ckout"))
    assert mine == theirs
    with np.load(os.path.join(inst, "inst.k_selection_stats.df.npz")) as a, \
            np.load(os.path.join(ckout, "ckout.k_selection_stats.df.npz")) \
            as b:
        assert a["data"].tobytes() == b["data"].tobytes()


def test_every_installed_stage_imported_the_installed_copy(installed,
                                                           main_paths):
    from cnmf_torch_tpu_torch.utils.telemetry import read_events

    events = read_events(os.path.join(main_paths[0], "cnmf_tmp",
                                      "inst.events.jsonl"))
    paths = [e["package_path"] for e in events if e["t"] == "manifest"]
    assert paths == [installed.pkg] * len(STEPS)


def test_run_parallel_workers_import_the_installed_copy(installed,
                                                        tmp_path):
    """Started from a working directory that holds the checkout's copy of
    the port, the installed command's workers still import the installed
    copy (``python -P``, the install first on their path)."""
    from cnmf_torch_tpu_torch.utils.telemetry import read_events

    counts = _counts(str(tmp_path / "counts.df.npz"), n=120, g=200)
    out = tmp_path / "out"
    _run([os.path.join(installed.site, "bin", "cnmf-tpu-torch"),
          "run_parallel", "-c", counts, "-k", "3", "-n", "2", "--seed",
          "14", "--numgenes", "100", "--max-nmf-iter", "40",
          "--total-workers", "2", "--engine", "subprocess",
          "--output-dir", str(out), "--name", "rp", "--device", "cpu"],
         cwd=installed.src, env=_env(installed.site, CNMF_TPU_TELEMETRY="1"))
    events = read_events(str(out / "rp" / "cnmf_tmp" / "rp.events.jsonl"))
    workers = [e for e in events if e["t"] == "stage"
               and e["stage"] == "factorize"]
    paths = {e["package_path"] for e in events if e["t"] == "manifest"}
    assert len(workers) == 2
    assert paths == {installed.pkg}


@pytest.mark.parametrize("site_dir", [False, True])
def test_port_env_puts_a_non_site_copy_first(monkeypatch, tmp_path,
                                             site_dir):
    """A checkout or ``--target`` copy goes first on the children's
    ``PYTHONPATH`` (once); a site directory of the interpreter does not
    (the child finds it, and it must not precede the standard library)."""
    import site

    from cnmf_torch_tpu_torch import launcher

    parent = (site.getsitepackages()[0] if site_dir else str(tmp_path))
    monkeypatch.setattr(launcher, "_PKG_PARENT", os.path.abspath(parent))
    env = launcher.port_env({"PYTHONPATH": os.pathsep.join(
        ["/elsewhere", parent])})
    want = (["/elsewhere"] if site_dir
            else [os.path.abspath(parent), "/elsewhere"])
    assert env["PYTHONPATH"].split(os.pathsep) == want
    cmd = launcher.port_command("serve")
    assert cmd[0] == sys.executable and cmd[-3:] == ["-m",
                                                     "cnmf_torch_tpu_torch",
                                                     "serve"]


# -- the deployment guide -------------------------------------------------

_STOP = {">", ">>", "|", "&", "&&", ";", "2>&1"}


def _guide_commands() -> list:
    """Every ``cnmf-tpu-torch <subcommand> ...`` line of the guide's code
    blocks (continuations joined), and the container's arguments after the
    image name, as argument lists."""
    with open(GUIDE, encoding="utf-8") as f:
        text = f.read()
    cmds = []
    for block in re.findall(r"```bash\n(.*?)```", text, flags=re.S):
        for line in block.replace("\\\n", " ").splitlines():
            # a shell variable stands for a value the CLI takes
            toks = [re.sub(r"\$\{?\w+\}?", "0", t)
                    for t in shlex.split(line, comments=True)]
            for i, tok in enumerate(toks):
                if (os.path.basename(tok) == "cnmf-tpu-torch"
                        or (tok == "cnmf-torch" and "run" in toks[:i])):
                    rest = []
                    for t in toks[i + 1:]:
                        if t in _STOP:
                            break
                        rest.append(t)
                    if rest and not rest[0].startswith("-"):
                        cmds.append(rest)
                    break
    return cmds


def test_the_guide_has_commands_of_every_kind():
    kinds = {c[0] for c in _guide_commands()}
    assert {"prepare", "factorize", "combine", "consensus",
            "k_selection_plot", "run_parallel", "serve", "fleet",
            "lint"} <= kinds


@pytest.mark.parametrize("argv", _guide_commands(),
                         ids=lambda a: " ".join(a)[:60])
def test_every_guide_command_parses_against_the_cli(argv):
    from cnmf_torch_tpu_torch.cli import build_parser

    if argv[0] == "lint":
        from cnmf_torch_tpu_torch.analysis.engine import main as lint_main

        assert lint_main(argv[1:] + ["--knob-table"]) == 0
        return
    args = build_parser().parse_intermixed_args(argv)
    assert args.command == argv[0]


def test_the_dockerfile_copies_the_port_and_installs_no_jax():
    with open(DOCKERFILE, encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines()
                 if not ln.lstrip().startswith("#")]
    text = "\n".join(lines)
    assert re.search(r"^FROM nvidia/cuda:\S+-devel-\S+$", text, flags=re.M)
    assert re.search(r"^COPY cnmf_torch_tpu_torch ", text, flags=re.M)
    assert "pip install --no-cache-dir --no-deps ." in text
    assert "jax" not in text.lower()
