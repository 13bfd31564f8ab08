"""The port's sanitizer (``utils/sanitize.py``) on the CPU.

- ``sync_guard("cpu")`` and ``host_read()`` never touch ``torch.cuda``
  (whose sync debug mode raises on a build without CUDA): a CPU has no
  device-to-host sync to catch, and the guard says it guarded nothing.
- With ``torch.cuda.get_sync_debug_mode``/``set_sync_debug_mode`` stubbed
  and a card reported present, a CUDA guard sets ``"error"`` and restores
  the previous mode on exit, after an exception too; ``host_read()`` drops
  the mode to 0 for its body and is counted by every active guard; guards
  nest.
- ``CNMF_TPU_SANITIZE`` parses as the JAX package's ``env_flag`` parses it.
- Every card test that ``tests/test_torch_cuda.py`` designates for the
  sanitizer exists.

The guard on the card (the negative control, the solver paths under it)
is ``tests/test_torch_cuda.py``'s.
"""

import ast
import os

import pytest
import torch

from cnmf_torch_tpu_torch.utils import sanitize
from cnmf_torch_tpu_torch.utils.sanitize import host_read, sync_guard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda_calls(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.cuda's sync debug mode was touched")

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", boom)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", boom)


@pytest.fixture
def stub_mode(monkeypatch):
    """A recorded stand-in for the card's process-wide sync debug mode."""
    state = {"mode": 0, "sets": []}
    words = {"default": 0, "warn": 1, "error": 2}

    def set_mode(mode):
        state["mode"] = words.get(mode, mode)
        state["sets"].append(state["mode"])

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    # a card "present", so a guard on "cuda" resolves its device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return state


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_a_cpu_guard_is_a_no_op_that_says_so(no_cuda_calls, device):
    with sync_guard(device) as guard:
        assert not guard.active
        assert not sanitize._guards
        with host_read():
            assert float(torch.ones(3).sum()) == 3.0
    assert guard.reads == 0


def test_host_read_outside_a_guard_does_nothing(no_cuda_calls):
    with host_read():
        pass
    assert not sanitize._guards


def test_the_cpu_build_cannot_read_the_mode():
    """Why the helpers must not touch ``torch.cuda`` without a card
    (a CUDA build without a card may answer; this one raises)."""
    if torch.cuda.is_available() or torch.version.cuda is not None:
        pytest.skip("this check is about a CPU-only torch build")
    with pytest.raises((AssertionError, RuntimeError)):
        torch.cuda.get_sync_debug_mode()


def test_a_cuda_guard_sets_error_and_restores(stub_mode):
    stub_mode["mode"] = 1
    with sync_guard("cuda") as guard:
        assert guard.active and bool(sanitize._guards)
        assert stub_mode["mode"] == 2
        with host_read():
            assert stub_mode["mode"] == 0
        assert stub_mode["mode"] == 2
        with host_read():
            pass
    assert guard.reads == 2
    assert stub_mode["mode"] == 1
    assert not sanitize._guards
    assert stub_mode["sets"] == [2, 0, 2, 0, 2, 1]


def test_guards_nest_and_count_every_read(stub_mode):
    with sync_guard("cuda:0") as outer:
        with host_read():
            pass
        with sync_guard("cuda") as inner:
            assert stub_mode["mode"] == 2
            with host_read():
                assert stub_mode["mode"] == 0
        assert stub_mode["mode"] == 2 and bool(sanitize._guards)
    assert (outer.reads, inner.reads) == (2, 1)
    assert stub_mode["mode"] == 0 and not sanitize._guards


def test_the_mode_is_restored_after_an_exception(stub_mode):
    with pytest.raises(ValueError):
        with sync_guard("cuda"):
            with host_read():
                raise ValueError("inside a chosen read")
    assert stub_mode["mode"] == 0 and not sanitize._guards
    with pytest.raises(KeyError):
        with sync_guard("cuda"):
            raise KeyError("inside the guard")
    assert stub_mode["mode"] == 0 and not sanitize._guards


@pytest.mark.parametrize("value", ["1", "0", "", "true", "FALSE", "off",
                                   "no", "yes", " 1 ", "on", None])
def test_sanitize_knob_parses_like_the_jax_package(monkeypatch, value):
    from cnmf_torch_tpu.utils.envknobs import env_flag as jax_env_flag

    from cnmf_torch_tpu_torch.utils.envknobs import env_flag

    if value is None:
        monkeypatch.delenv("CNMF_TPU_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("CNMF_TPU_SANITIZE", value)
    want = jax_env_flag("CNMF_TPU_SANITIZE", False)
    assert env_flag("CNMF_TPU_SANITIZE", False) is want
    assert sanitize.sanitize_enabled() is want


def _card_test_names():
    path = os.path.join(ROOT, "tests", "test_torch_cuda.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    subset = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SANITIZE_SUBSET"
                for t in node.targets):
            subset = ast.literal_eval(node.value)
    return names, subset


def test_every_designated_card_test_exists():
    names, subset = _card_test_names()
    assert subset, "tests/test_torch_cuda.py designates no sanitize subset"
    missing = [name for name in subset if name not in names]
    assert not missing, missing
    assert "test_sync_guard_raises_on_an_implicit_sync" in subset
