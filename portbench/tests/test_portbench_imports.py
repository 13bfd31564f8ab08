"""No run loads JAX or the JAX package, and the reference takes nothing
of the program."""

import ast
import os
import subprocess
import sys

from portbench import run

REFERENCE = os.path.join(run.HERE, "reference")


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, control\n"
        "from portbench.harness import check, counts, peaks, roofline, "
        "trace, workcount\n"
        "from portbench.reference import online_nmf, prepare\n"
        "import cnmf_torch_tpu_torch, cnmf_torch_tpu_torch.models.cnmf\n"
        "bench = run.load_benchmark()\n"
        "for m in bench['per_layer']: run.reader(m['name'])\n"
        "for w in bench['workloads']:\n"
        "    run.kind_module(run.resolve(bench, w['name'])['traffic']"
        "['kind'])\n"
        "print('loaded:', ','.join(run.forbidden_modules()))\n" % run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=run.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def test_top_level_names_are_compared_whole():
    assert "cnmf_torch_tpu_torch" not in run.FORBIDDEN
    assert run.forbidden_modules(["cnmf_torch_tpu_torch.ops.nmf",
                                  "jaxtyping", "flaxen", "os"]) == []
    assert run.forbidden_modules(["cnmf_torch_tpu.ops", "jax._src.core",
                                  "jaxlib", "flax.linen"]) == [
        "cnmf_torch_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = [f for f in os.listdir(REFERENCE) if f.endswith(".py")]
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(os.path.join(REFERENCE, f))}
        assert not tops & {"cnmf_torch_tpu_torch", "cnmf_torch_tpu", "jax",
                           "jaxlib", "portbench"}, (f, tops)
