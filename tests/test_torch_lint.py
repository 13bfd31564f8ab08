"""The port's static analysis (``cnmf_torch_tpu_torch/analysis/``) on the
CPU: positive and negative fixtures for every rule, suppression and
baseline semantics, the JSON shape, parse errors, the CLI and the gate,
the knob table ``KNOBS.md`` and its drift both ways, the registry's kinds
and defaults against the JAX package's, the port linting clean with the
shipped empty baseline, and the rules the two packages share giving the
same findings on the same sources (JAX's engine is read-only here: it
imports no JAX)."""

import ast
import json
import os
import textwrap

import pytest

from cnmf_torch_tpu_torch.analysis import rules_sync
from cnmf_torch_tpu_torch.analysis.engine import (DEFAULT_BASELINE,
                                                  PACKAGE_DIR, format_json,
                                                  format_text, lint_paths,
                                                  write_baseline)
from cnmf_torch_tpu_torch.analysis.gate import main as gate_main
from cnmf_torch_tpu_torch.cli import main as cli_main
from cnmf_torch_tpu_torch.utils import envknobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS_MD = os.path.join(PACKAGE_DIR, "KNOBS.md")
HOT_FILE = "hot_fixture.py"
SHARED_RULES = ("knob-raw-env", "artifact-nonatomic", "telemetry-schema",
                "lock-discipline", "lint-parse-error")


def _lint_src(tmp_path, src, name="fixture.py", baseline=None,
              doc_check=False):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return lint_paths([str(p)], baseline_path=baseline, doc_check=doc_check,
                      root=str(tmp_path))


def _rules(result):
    return sorted(f.rule for f in result.findings)


@pytest.fixture
def hot(monkeypatch):
    """``hot_fixture.py``'s ``solve`` and ``loop*`` functions are hot
    scopes."""
    monkeypatch.setitem(rules_sync.HOT_SCOPES, HOT_FILE, ("solve", "loop*"))


# ---------------------------------------------------------------------------
# host-sync and rng-global (rules_sync)
# ---------------------------------------------------------------------------

HOST_SYNC_POSITIVE = {
    "item": "y = x.item()",
    "tolist": "y = x.tolist()",
    "cpu": "y = x.cpu()",
    "numpy": "y = x.numpy()",
    "to_cpu": 'y = x.to("cpu")',
    "to_device_cpu": 'y = x.to(device=torch.device("cpu"))',
    "np_asarray": "y = np.asarray(x)",
    "np_array_expr": "y = np.array(x * 2)",
    "bool_any": "y = bool(x.any())",
    "float_sum": "y = float(x.sum())",
    "int_torch_max": "y = int(torch.max(x))",
    "if_any": "if x.any():\n        y = 1",
    "while_all": "while bool(x.all()):\n        x = x - 1",
    "ifexp_sum": "y = 1 if x.sum() > 0 else 0",
    "nested_fn": "def inner():\n        return x.item()\n    y = inner()",
}


@pytest.mark.parametrize("case", sorted(HOST_SYNC_POSITIVE))
def test_host_sync_in_a_hot_scope_is_found(tmp_path, hot, case):
    src = ("import numpy as np\nimport torch\n\n\ndef solve(x):\n    "
           + HOST_SYNC_POSITIVE[case] + "\n    return x\n")
    res = _lint_src(tmp_path, src, HOT_FILE)
    assert _rules(res) == ["host-sync"], format_text(res)
    assert res.findings[0].line >= 6
    assert "hot scope `solve`" in res.findings[0].message


def test_a_prefix_pattern_names_a_family(tmp_path, hot):
    res = _lint_src(tmp_path, """
        def loop_a(x):
            return x.item()


        def loop_b(x):
            return x.cpu()


        def cold(x):
            return x.item()
        """, HOT_FILE)
    assert [f.line for f in res.findings] == [3, 7]


HOST_SYNC_NEGATIVE = {
    "host_read": "with host_read():\n        y = bool(x.any())",
    "host_read_alias": "with sanitize.host_read():\n        y = x.cpu()",
    "shape": "y = int(x.shape[0])",
    "size": "y = int(x.size(1))",
    "numel": "y = float(x.numel())",
    "len": "y = int(len(x))",
    "np_literal": "y = np.asarray([1, 2, 3])",
    "np_host_max": "y = float(np.max(a))",
    "cast_plain": "y = float(beta)",
    "if_shape": "if x.shape[0] > 3:\n        y = 1",
    "device_to": "y = x.to(x.device)",
}


@pytest.mark.parametrize("case", sorted(HOST_SYNC_NEGATIVE))
def test_chosen_reads_and_host_facts_are_clean(tmp_path, hot, case):
    src = ("import numpy as np\nimport torch\nfrom pkg.utils import "
           "sanitize\nfrom pkg.utils.sanitize import host_read\n\n\n"
           "def solve(x, a, beta):\n    y = 0\n    "
           + HOST_SYNC_NEGATIVE[case] + "\n    return y\n")
    res = _lint_src(tmp_path, src, HOT_FILE)
    assert res.findings == [], format_text(res)


def test_outside_a_hot_scope_or_file_is_clean(tmp_path, hot):
    src = """
        import torch


        def cold(x):
            torch.manual_seed(0)
            return bool(x.any()), x.cpu(), torch.rand(3)
        """
    assert _lint_src(tmp_path, src, HOT_FILE).findings == []
    # a hot name in a file HOT_SCOPES does not list
    assert _lint_src(tmp_path, src.replace("cold", "solve"),
                     "elsewhere.py").findings == []


RNG_POSITIVE = {
    "rand": "y = torch.rand(3)",
    "randn": "y = torch.randn(2, 2)",
    "randint": "y = torch.randint(0, 4, (3,))",
    "randperm": "y = torch.randperm(5)",
    "rand_like": "y = torch.rand_like(x)",
    "normal": "y = torch.normal(0.0, 1.0, (3,))",
    "manual_seed": "torch.manual_seed(0)",
    "cuda_seed": "torch.cuda.manual_seed_all(0)",
    "np_draw": "y = np.random.rand(3)",
    "np_seed": "np.random.seed(1)",
    "py_random": "y = random.random()",
    "inplace": "x.uniform_()",
}


@pytest.mark.parametrize("case", sorted(RNG_POSITIVE))
def test_global_rng_in_a_hot_scope_is_found(tmp_path, hot, case):
    src = ("import random\nimport numpy as np\nimport torch\n\n\n"
           "def solve(x):\n    " + RNG_POSITIVE[case] + "\n    return x\n")
    res = _lint_src(tmp_path, src, HOT_FILE)
    assert _rules(res) == ["rng-global"], format_text(res)
    assert res.findings[0].line == 7


RNG_NEGATIVE = {
    "generator": "y = torch.rand(3, generator=gen)",
    "randperm_gen": "y = torch.randperm(5, generator=gen)",
    "inplace_gen": "x.normal_(generator=gen)",
    "default_rng": "y = np.random.default_rng(0).random(3)",
    "generator_seed": "g = torch.Generator().manual_seed(1)",
}


@pytest.mark.parametrize("case", sorted(RNG_NEGATIVE))
def test_explicit_generators_are_clean(tmp_path, hot, case):
    src = ("import numpy as np\nimport torch\n\n\n"
           "def solve(x, gen):\n    " + RNG_NEGATIVE[case]
           + "\n    return x\n")
    res = _lint_src(tmp_path, src, HOT_FILE)
    assert res.findings == [], format_text(res)


def _functions(rel):
    with open(os.path.join(PACKAGE_DIR, rel)) as f:
        tree = ast.parse(f.read())
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@pytest.mark.parametrize("rel,pattern", [
    (rel, pat) for rel, pats in sorted(rules_sync.HOT_SCOPES.items())
    for pat in pats])
def test_every_hot_scope_names_a_port_function(rel, pattern):
    """A renamed solver must not leave the rule checking nothing."""
    assert any(rules_sync._matches(name, (pattern,))
               for name in _functions(rel)), (rel, pattern)


# ---------------------------------------------------------------------------
# knob rules
# ---------------------------------------------------------------------------

KNOB_RAW = {
    "subscript": 'os.environ["CNMF_TPU_OOC"]',
    "get": 'os.environ.get("CNMF_X")',
    "getenv": 'os.getenv("JAX_FOO")',
    "in": '"CNMF_Y" in os.environ',
    "alias": 'environ.get("CNMF_Z")',
    "setdefault": 'os.environ.setdefault("CNMF_TPU_METRICS", "1")',
}


@pytest.mark.parametrize("case", sorted(KNOB_RAW))
def test_raw_env_read_is_found(tmp_path, case):
    res = _lint_src(tmp_path, "import os\nfrom os import environ\n\n\n"
                    "def f():\n    return " + KNOB_RAW[case] + "\n")
    assert _rules(res) == ["knob-raw-env"]
    assert res.findings[0].line == 6


def test_accessors_and_other_variables_are_clean(tmp_path):
    res = _lint_src(tmp_path, """
        import os
        from pkg.utils.envknobs import env_flag, env_str


        def f():
            return (env_str("CNMF_TPU_FAULT_SPEC"),
                    env_flag("CNMF_TPU_SANITIZE", False),
                    os.environ.get("HOME"),
                    {k: v for k, v in os.environ.items()})
        """)
    assert res.findings == []


def test_unregistered_knob_and_plan_bypass_are_found(tmp_path):
    res = _lint_src(tmp_path, """
        from pkg.utils.envknobs import env_int, env_str

        OOC_ENV = "CNMF_TPU_OOC"


        def f():
            a = env_int("CNMF_TPU_NOT_A_KNOB", 1)
            b = env_str("CNMF_TPU_SPARSE_BETA")
            c = env_str(OOC_ENV)
            return a, b, c


        def resolve_sparse_beta():
            return env_str("CNMF_TPU_SPARSE_BETA")
        """)
    assert [(f.rule, f.line) for f in res.findings] == [
        ("knob-unregistered", 8), ("knob-plan-bypass", 9),
        ("knob-plan-bypass", 10)]


def test_the_knob_owner_and_planner_files_are_exempt(tmp_path):
    src = """
        import os
        from .envknobs import env_str


        def f():
            return os.environ.get("CNMF_TPU_OOC"), env_str("CNMF_TPU_OOC")
        """
    assert _lint_src(tmp_path, src, "utils/envknobs.py").findings == []
    res = _lint_src(tmp_path, src, "runtime/planner.py")
    assert _rules(res) == ["knob-raw-env"]


# ---------------------------------------------------------------------------
# artifact-nonatomic, telemetry-schema, lock-discipline
# ---------------------------------------------------------------------------

def test_nonatomic_writes_are_found_and_atomic_ones_clean(tmp_path):
    res = _lint_src(tmp_path, """
        import numpy as np
        from pkg.utils.io import atomic_artifact


        def f(p, df, fig, a):
            open(p, "w").write("x")
            open(p, mode="ab")
            np.save(p, a)
            np.savez_compressed(p, a=a)
            df.to_csv(p)
            fig.savefig(p)
            open(p).read()
            open(p, "rb").read()
            with atomic_artifact(p) as tmp:
                with open(tmp, "w") as fh:
                    fh.write("x")
                np.savez(tmp, a=a)
        """)
    assert [(f.rule, f.line) for f in res.findings] == [
        ("artifact-nonatomic", line) for line in range(7, 13)]


def test_telemetry_schema_is_checked_at_emit_sites(tmp_path):
    res = _lint_src(tmp_path, """
        def f(events, kw, kind):
            events.emit("no_such_event", x=1)
            events.emit("stage")
            events.emit("stage", **kw)
            events.emit(kind, x=1)
        """)
    assert [(f.rule, f.line) for f in res.findings] == [
        ("telemetry-schema", 3), ("telemetry-schema", 4)]
    assert "omits required field" in res.findings[1].message


def test_lock_discipline(tmp_path):
    res = _lint_src(tmp_path, """
        import threading

        _STATE = {}
        _LIST = []
        _latch = None
        _lock = threading.Lock()


        def bad(k):
            global _latch
            _STATE[k] = 1
            _LIST.append(k)
            _latch = k


        def good(k):
            global _latch
            with _lock:
                _STATE[k] = 1
                _latch = k
            _STATE2 = {}
            _STATE2[k] = 1


        def shadow(_STATE):
            _STATE[0] = 1
        """)
    assert [(f.rule, f.line) for f in res.findings] == [
        ("lock-discipline", 12), ("lock-discipline", 13),
        ("lock-discipline", 14)]


# ---------------------------------------------------------------------------
# the engine: suppression, baseline, output, parse errors
# ---------------------------------------------------------------------------

def test_suppression_on_the_line_and_the_line_above(tmp_path):
    res = _lint_src(tmp_path, """
        import os


        def f(p):
            open(p, "w")  # cnmf-lint: disable=artifact-nonatomic
            # a reason, then the tag on its own line
            # cnmf-lint: disable=knob-raw-env,artifact-nonatomic
            os.environ.get("CNMF_TPU_OOC")
            open(p, "w")  # cnmf-lint: disable=knob-raw-env
        """)
    assert [(f.rule, f.line) for f in res.findings] == [
        ("artifact-nonatomic", 10)]
    assert res.suppressed == 2


def test_baseline_absorbs_its_findings_and_no_more(tmp_path):
    src = 'def f(p):\n    open(p, "w")\n'
    first = _lint_src(tmp_path, src)
    base = str(tmp_path / "baseline.json")
    write_baseline(base, first.findings)
    with open(base) as f:
        assert json.load(f)["findings"][0]["rule"] == "artifact-nonatomic"
    # the fingerprint is path + rule + text: a moved line stays absorbed
    moved = _lint_src(tmp_path, "\n\n" + src, baseline=base)
    assert moved.findings == [] and len(moved.baselined) == 1
    twice = _lint_src(tmp_path, src + '    open(p, "w")\n', baseline=base)
    assert len(twice.findings) == 1 and len(twice.baselined) == 1


def test_json_output_shape(tmp_path):
    res = _lint_src(tmp_path, 'def f(p):\n    open(p, "w")\n')
    data = json.loads(format_json(res))
    assert set(data) == {"version", "findings", "counts", "families",
                         "baselined", "suppressed", "files"}
    assert data["counts"] == {"artifact-nonatomic": 1}
    assert data["families"]["artifact"] == 1
    assert set(data["families"]) >= {"sync", "knobs", "artifact",
                                     "telemetry", "concurrency", "engine"}
    assert set(data["findings"][0]) == {"path", "line", "rule", "message",
                                        "hint", "text"}
    assert data["findings"][0]["path"] == "fixture.py"


def test_a_file_that_does_not_parse_is_a_finding(tmp_path):
    res = _lint_src(tmp_path, "def f(:\n    pass\n")
    assert _rules(res) == ["lint-parse-error"]
    assert res.findings[0].line == 1


# ---------------------------------------------------------------------------
# the CLI and the gate
# ---------------------------------------------------------------------------

def _cli(argv):
    with pytest.raises(SystemExit) as exc:
        cli_main(argv)
    return exc.value.code


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text('def f(p):\n    open(p, "w")\n')
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    assert _cli(["lint", str(bad), "--baseline", ""]) == 1
    assert "artifact-nonatomic" in capsys.readouterr().out
    assert _cli(["lint", str(good)]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert _cli(["lint", str(bad), "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["counts"] == {
        "artifact-nonatomic": 1}
    assert _cli(["lint", str(tmp_path / "missing.py")]) == 2
    assert _cli(["lint", str(bad), "--write-baseline", "--baseline",
                 ""]) == 2
    base = tmp_path / "b.json"
    assert _cli(["lint", str(bad), "--write-baseline", "--baseline",
                 str(base)]) == 0
    assert _cli(["lint", str(bad), "--baseline", str(base)]) == 0
    with pytest.raises(SystemExit) as exc:
        cli_main(["--name", "x", "lint"])
    assert exc.value.code == 2


def test_cli_knob_table_is_knobs_md(capsys):
    assert _cli(["lint", "--knob-table"]) == 0
    with open(KNOBS_MD) as f:
        assert capsys.readouterr().out == f.read()


def test_the_gate_passes_and_prints_its_line(capsys):
    assert gate_main() == 0
    line = capsys.readouterr().out.strip().splitlines()[0]
    assert line.startswith("LINT_GATE: artifact=0 concurrency=0 engine=0 "
                           "knobs=0 sync=0 telemetry=0 baselined=0 ")
    assert "files=" in line and "suppressed=" in line


def test_the_port_lints_clean_with_the_empty_baseline():
    with open(DEFAULT_BASELINE) as f:
        assert json.load(f)["findings"] == []
    res = lint_paths([PACKAGE_DIR], baseline_path=DEFAULT_BASELINE,
                     root=REPO)
    assert res.findings == [], format_text(res)
    assert res.baselined == [] and res.files > 70


# ---------------------------------------------------------------------------
# the registry and KNOBS.md
# ---------------------------------------------------------------------------

def test_knobs_md_is_the_generated_table():
    with open(KNOBS_MD) as f:
        text = f.read()
    assert text == envknobs.knob_table() + "\n"
    table = envknobs.parse_knob_table(text)
    assert table == {k.name: (k.default, k.doc)
                     for k in envknobs.REGISTRY.values()}


def test_knobs_is_the_name_to_doc_view():
    assert envknobs.KNOBS == {k.name: k.doc
                              for k in envknobs.REGISTRY.values()}
    assert envknobs.REGISTRY["CNMF_TPU_SANITIZE"].kind == "flag"
    assert "set_sync_debug_mode" in envknobs.KNOBS["CNMF_TPU_SANITIZE"]
    assert "transfer_guard" not in envknobs.KNOBS["CNMF_TPU_SANITIZE"]


def test_parse_knob_table_tolerates_a_pipe_in_a_doc():
    table = envknobs.parse_knob_table(
        "| knob | default | what it does |\n|---|---|---|\n"
        "| `CNMF_A` | `1` | a \\| b or c | d |\n")
    assert table == {"CNMF_A": ("`1`", "a \\| b or c | d")}


def _drift(rows):
    """KNOBS.md's text with its rows edited by ``rows(list) -> list``."""
    with open(KNOBS_MD) as f:
        lines = f.read().splitlines()
    return "\n".join(lines[:2] + rows(lines[2:])) + "\n"


DRIFTS = {
    "missing row": lambda rows: rows[1:],
    "unregistered row": lambda rows: rows + [
        "| `CNMF_TPU_NOT_A_KNOB` | `0` | nothing |"],
    "stale default": lambda rows: [rows[0].replace("| auto |", "| `1` |")]
    + rows[1:],
    "stale doc": lambda rows: [rows[0][:-2] + " (edited) |"] + rows[1:],
}


@pytest.mark.parametrize("kind", sorted(DRIFTS))
def test_knob_table_drift_is_found_both_ways(tmp_path, kind):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "KNOBS.md").write_text(_drift(DRIFTS[kind]))
    (pkg / "mod.py").write_text("X = 1\n")
    res = lint_paths([str(pkg)], doc_check=True, root=str(tmp_path))
    assert _rules(res) == ["knob-doc-drift"], format_text(res)
    assert res.findings[0].text.startswith(kind)
    assert res.findings[0].path == "pkg/KNOBS.md"
    assert lint_paths([str(pkg)], doc_check=False).findings == []


def test_an_unedited_table_has_no_drift(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "KNOBS.md").write_text(_drift(lambda rows: rows))
    (pkg / "mod.py").write_text("X = 1\n")
    assert lint_paths([str(pkg)], doc_check=True).findings == []


@pytest.mark.parametrize("name", sorted(envknobs.REGISTRY))
def test_kind_and_default_are_the_jax_packages(name):
    from cnmf_torch_tpu.utils.envknobs import REGISTRY as JAX_REGISTRY

    mine, theirs = envknobs.REGISTRY[name], JAX_REGISTRY[name]
    assert (mine.kind, mine.default, mine.documented) == (
        theirs.kind, theirs.default, theirs.documented)


# ---------------------------------------------------------------------------
# parity: the rules both packages have give the same findings
# ---------------------------------------------------------------------------

PARITY_SOURCES = {
    "raw_env": """
        import os
        from os import environ


        def f():
            a = os.environ["CNMF_TPU_OOC"]
            b = os.environ.get("CNMF_X", "")
            c = os.getenv("JAX_FOO")
            d = "CNMF_Y" in os.environ
            e = environ.get("CNMF_Z")
            g = os.environ.get("HOME")
            h = os.environ.get("CNMF_W")  # cnmf-lint: disable=knob-raw-env
            return a, b, c, d, e, g, h
        """,
    "writes": """
        import numpy as np
        from somewhere import atomic_artifact


        def f(p, df, fig, a):
            open(p, "w").write("x")
            with open(p, "a") as fh:
                fh.write("y")
            np.save(p, a)
            np.savez(p, a=a)
            df.to_parquet(p)
            fig.savefig(p)
            open(p).read()
            with atomic_artifact(p) as tmp:
                np.save(tmp, a)
        """,
    "telemetry": """
        def f(events, kw):
            events.emit("not_an_event_type", x=1)
            events.emit("stage")
            events.emit("stage", **kw)
            events.emit("memory")
        """,
    "locks": """
        import threading

        _A = {}
        _B = set()
        _C = list()
        _flag = False
        _lock = threading.Lock()


        def f(k):
            global _flag
            _A[k] = 1
            _B.add(k)
            _C.extend([k])
            _flag = True
            with _lock:
                _A.pop(k)


        def g(_A):
            _A[1] = 2
        """,
    "parse_error": """
        def f(:
            pass
        """,
    "mixed": """
        import os
        import threading

        _REG = {}


        def f(p, events):
            _REG[p] = os.environ.get("CNMF_TPU_OOC")
            open(p, "x")
            events.emit("nope")
        """,
}


@pytest.mark.parametrize("case", sorted(PARITY_SOURCES))
def test_shared_rules_agree_with_the_jax_engine(tmp_path, case):
    from cnmf_torch_tpu.analysis.engine import lint_paths as jax_lint_paths

    p = tmp_path / f"{case}.py"
    p.write_text(textwrap.dedent(PARITY_SOURCES[case]))

    def shared(res):
        return sorted((f.rule, f.line) for f in res.findings
                      if f.rule in SHARED_RULES)

    mine = lint_paths([str(p)], doc_check=False)
    theirs = jax_lint_paths([str(p)], doc_check=False)
    assert shared(mine) == shared(theirs)
    assert shared(mine), "a parity fixture must exercise its rule"
    assert mine.suppressed == theirs.suppressed
