"""The port's native MatrixMarket reader (``cnmf_torch_tpu_torch/native``)
against the JAX package's ``read_mtx``, case by case as
``tests/test_native.py`` holds the JAX reader: real, integer and pattern
files, comments between entries, the symmetric file that goes to scipy,
malformed, truncated and out-of-bounds files (the same ``ValueError``), and
``.gz``. Values must be equal bit for bit (both parse to f64)."""

import gzip
import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from cnmf_torch_tpu import native as jnative
from cnmf_torch_tpu_torch import native as tnative


def test_the_port_builds_its_own_library_under_build():
    assert tnative.native_available()
    lib = tnative._lib_path()
    assert os.path.dirname(lib) == tnative.BUILD_DIR
    assert os.path.basename(os.path.dirname(tnative.BUILD_DIR)) == "build"
    assert os.path.exists(lib)
    # nothing is built beside the source
    assert not [f for f in os.listdir(os.path.dirname(tnative.SOURCE))
                if f.endswith(".so")]


def test_a_build_race_installs_a_whole_library(tmp_path, monkeypatch):
    """Two builds of one library: each compiles to its own temp name and
    renames it into place, so the result loads and no temp is left."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    path = tnative._lib_path()
    assert tnative._build(path) and tnative._build(path)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    import ctypes

    assert ctypes.CDLL(path).mtx_parse_body


def _roundtrip(tmp_path, M, name="m.mtx", field=None, gz=False):
    fn = tmp_path / name
    scipy.io.mmwrite(str(fn), M, field=field)
    if gz:
        data = fn.read_bytes()
        fn = tmp_path / (name + ".gz")
        with gzip.open(fn, "wb") as f:
            f.write(data)
    return str(fn)


def _same(fn):
    got, want = tnative.read_mtx(fn), jnative.read_mtx(fn)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    return got


@pytest.mark.parametrize("gz", [False, True])
def test_real_matrix_parity(tmp_path, gz):
    M = sp.random(123, 47, density=0.15, random_state=0, format="coo")
    got = _same(_roundtrip(tmp_path, M, gz=gz))
    np.testing.assert_allclose(got.toarray(), M.toarray(), rtol=1e-12)


def test_integer_matrix_parity(tmp_path):
    rng = np.random.default_rng(0)
    M = sp.coo_matrix(rng.integers(0, 5, size=(30, 20)))
    got = _same(_roundtrip(tmp_path, M, field="integer"))
    np.testing.assert_array_equal(got.toarray(), M.toarray())


def test_pattern_matrix(tmp_path):
    fn = tmp_path / "p.mtx"
    fn.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "% a comment\n3 4 3\n1 1\n2 3\n3 4\n")
    got = _same(str(fn))
    expected = np.zeros((3, 4))
    expected[0, 0] = expected[1, 2] = expected[2, 3] = 1.0
    np.testing.assert_array_equal(got.toarray(), expected)


def test_comments_between_entries(tmp_path):
    fn = tmp_path / "c.mtx"
    fn.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 2\n1 1 5.5\n% interleaved comment\n2 2 -1e-3\n")
    got = _same(str(fn))
    np.testing.assert_allclose(got.toarray(), [[5.5, 0.0], [0.0, -1e-3]])


def test_symmetric_goes_to_scipy(tmp_path):
    fn = tmp_path / "s.mtx"
    fn.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "2 2 2\n1 1 1.0\n2 1 3.0\n")
    got = _same(str(fn))  # scipy expands the symmetric half
    np.testing.assert_allclose(got.toarray(), [[1.0, 3.0], [3.0, 0.0]])


def test_without_a_toolchain_every_file_goes_to_scipy(tmp_path,
                                                      monkeypatch):
    M = sp.random(40, 9, density=0.2, random_state=2, format="coo")
    fn = _roundtrip(tmp_path, M)
    want = tnative.read_mtx(fn)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", True)
    assert not tnative.native_available()
    np.testing.assert_array_equal(tnative.read_mtx(fn).toarray(),
                                  want.toarray())


@pytest.mark.parametrize("body, match", [
    ("2 2 2\n1 1 1.0\n2 oops 2.0\n", "malformed|entries"),
    ("5 5 10\n1 1 1.0\n", "declares 10 entries"),
    ("2 2 1\n3 1 1.0\n", "out of declared bounds"),
    ("2 2 1\n1 1 1.0\n2 2 2.0\n", "more entries than the header"),
])
def test_bad_files_raise_as_jax(tmp_path, body, match):
    fn = tmp_path / "bad.mtx"
    fn.write_text("%%MatrixMarket matrix coordinate real general\n" + body)
    with pytest.raises(ValueError, match=match) as got:
        tnative.read_mtx(str(fn))
    with pytest.raises(ValueError) as want:
        jnative.read_mtx(str(fn))
    assert str(got.value) == str(want.value)
