"""The control of each cell's comparison comes out not correct: the plain
reference in the program's place, in the precision below the
configuration's (KL: the ratio chain in float8 e4m3 for bfloat16;
Frobenius: TF32 for float32 with TF32 off), at the cell's own size with
the sample of a run of five jobs. TF32 exists only on the card, and at the
cell's size the CPU would take many minutes, so the test runs on the card
alone. It prints the numbers."""

import json

import pytest

from portbench import control, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pbmc10k-kl.factorize",
                                  "pbmc10k-frob.factorize"])
def test_the_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    spec = run.resolve(run.load_benchmark(), cell)
    out = control.control_numbers(spec, 1234567, 5)
    print("reading", json.dumps({"cell": cell, **out}))
    assert out["correct"] is False, out["numbers"]
