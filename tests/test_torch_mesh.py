"""The port's mesh (``parallel/mesh.py``) and the replicate axis over it
(``parallel/replicates.py``), on the CPU.

A mesh repeats the ``cpu`` device as the JAX tests' 8 virtual CPU devices
repeat one host (``tests/conftest.py``). The sharded replicate sweep is
held to the JAX package's ``replicate_sweep`` over ``default_mesh()`` (8
virtual devices, 11 replicates: not a multiple of 8) from JAX's inits, at
``rtol 1e-4`` in the objective and ``1e-3`` in the spectra (strict f32),
and to the port's own sweep without a mesh bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.parallel import replicates as jrep
from cnmf_torch_tpu_torch.parallel import mesh as tmesh
from cnmf_torch_tpu_torch.parallel import replicates as trep
from cnmf_torch_tpu_torch.parallel.mesh import Mesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _counts(n=160, g=120, k=4, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.dirichlet(np.ones(k) * 0.4, size=n)
    S = rng.gamma(0.4, 1.0, size=(k, g)) * 30.0 / g
    X = rng.poisson(U @ S * 2.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    return X


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_a_mesh_repeats_devices_and_names_its_entries():
    m = Mesh(["cpu"] * 8, ("cells",))
    assert m.shape == {"cells": 8} and m.size == 8
    assert m.local_ids() == list(range(8))
    assert m.local_shards() == list(range(8))
    assert not m.spans_processes
    m2 = Mesh(np.asarray(["cpu"] * 6, dtype=object).reshape(2, 3),
              ("replicates", "cells"))
    assert m2.fiber("cells", 4).size == 3
    assert m2._fiber_key("cells", 4) == (3, 4, 5)
    assert m2._fiber_key("replicates", 4) == (1, 4)
    with pytest.raises(ValueError, match="do not match"):
        Mesh(["cpu"] * 4, ("a", "b"))


def test_psum_adds_the_shards_in_order_and_keeps_one_shard_as_it_is():
    m = Mesh(["cpu"] * 3, ("cells",))
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
             torch.tensor([1.0, 1.0])]
    got = m.psum(parts)
    want = (parts[0] + parts[1]) + parts[2]
    assert len(got) == 3 and all(torch.equal(t, want) for t in got)
    one = Mesh(["cpu"], ("cells",))
    t = torch.ones(4)
    assert one.psum([t])[0] is t
    assert m.stats["all_reduces"] == 0


def test_default_mesh_is_none_on_one_device():
    assert trep.default_mesh(device="cpu") is None
    assert tmesh.visible_devices("cpu") == [torch.device("cpu")]
    assert tmesh.process_index() == 0 and tmesh.process_count() == 1
    assert tmesh.backend() is None


def test_global_devices_put_process_zero_first():
    devices, owners = tmesh.global_devices(["cpu", "cpu"], n_proc=3)
    assert len(devices) == 6 and owners == [0, 0, 1, 1, 2, 2]


# ---------------------------------------------------------------------------
# the replicate axis
# ---------------------------------------------------------------------------

@pytest.fixture
def strict_f32(monkeypatch):
    monkeypatch.setenv("CNMF_TPU_BF16_RATIO", "0")


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler"])
def test_the_replicate_axis_matches_jax_over_eight_devices(strict_f32,
                                                           beta_loss):
    X = _counts()
    seeds, k = list(range(3, 14)), 4
    mesh = jrep.default_mesh()
    assert mesh is not None and mesh.devices.size == 8
    kw = dict(beta_loss=beta_loss, mode="online", online_chunk_size=80,
              n_passes=6)
    spectra_j, _, errs_j = jrep.replicate_sweep(X, seeds, k, mesh=mesh, **kw)
    H0, W0 = jrep._stacked_inits(jnp.asarray(X), k, seeds, "random")
    spectra_t, _, errs_t = trep.replicate_sweep(
        X, seeds, k, inits=(np.asarray(H0), np.asarray(W0)), device="cpu",
        mesh=Mesh(["cpu"] * 8, ("replicates",)), **kw)
    assert spectra_t.shape == (11, k, X.shape[1])
    np.testing.assert_allclose(errs_t, np.asarray(errs_j), rtol=1e-4)
    assert _rel(spectra_t, spectra_j) < 1e-3


@pytest.mark.parametrize("kind", ["dense", "csr"])
@pytest.mark.parametrize("mode", ["online", "batch"])
def test_a_mesh_sweep_is_the_sweep_without_one(kind, mode):
    X = _counts(seed=1)
    if kind == "csr":
        X = sp.csr_matrix(np.where(np.random.default_rng(2).random(X.shape)
                                   < 0.06, X + 1.0, 0.0).astype(np.float32))
    kw = dict(beta_loss="kullback-leibler", mode=mode, n_passes=4,
              batch_max_iter=30, online_chunk_size=80, return_usages=True,
              device="cpu")
    a = trep.replicate_sweep(X, [5, 6, 7], 3, **kw)
    b = trep.replicate_sweep(X, [5, 6, 7], 3,
                             mesh=Mesh(["cpu"] * 2, ("replicates",)), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_the_packed_sweep_takes_the_mesh():
    X = _counts(seed=4)
    kw = dict(beta_loss="frobenius", mode="online", n_passes=3,
              online_chunk_size=80, device="cpu")
    a = trep.replicate_sweep_packed(X, [3, 4, 3], [1, 2, 3], **kw)
    b = trep.replicate_sweep_packed(
        X, [3, 4, 3], [1, 2, 3], mesh=Mesh(["cpu"] * 4, ("replicates",)),
        **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])


def test_factorize_spreads_replicates_over_its_mesh(tmp_path):
    from cnmf_torch_tpu_torch import Frame, cNMF, load_df_from_npz, \
        save_df_to_npz

    X = _counts(n=200, g=300, seed=5)
    fn = str(tmp_path / "c.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(200)]),
                         np.asarray([f"g{j}" for j in range(300)])), fn)
    runs = {}
    for name, mesh in (("plain", None),
                       ("mesh", Mesh(["cpu"] * 3, ("replicates",)))):
        obj = cNMF(str(tmp_path), name, device="cpu")
        obj.prepare(fn, components=[3], n_iter=4, seed=7,
                    num_highvar_genes=150)
        obj.factorize(mesh=mesh)
        runs[name] = [load_df_from_npz(obj.paths["iter_spectra"] % (3, i))
                      .values for i in range(4)]
    for a, b in zip(runs["plain"], runs["mesh"]):
        np.testing.assert_array_equal(a, b)


def test_factorize_stays_on_one_device_unless_a_mesh_is_asked_for(
        tmp_path, monkeypatch):
    """A host of four devices: with no mesh the batched sweep and the
    row-sharded path run on one; ``mesh_shape='1d'`` spans all four."""
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
    from cnmf_torch_tpu_torch.models import cnmf as tcnmf
    from cnmf_torch_tpu_torch.parallel import rowshard as trow

    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 4)
    assert trep.default_mesh(device="cpu").size == 4
    seen = []
    sweep, fit = tcnmf.replicate_sweep, trow.nmf_fit_rowsharded

    def spy_sweep(*args, **kw):
        seen.append(("sweep", kw.get("mesh")))
        return sweep(*args, **kw)

    def spy_fit(*args, **kw):
        seen.append(("rowshard", kw.get("mesh")))
        return fit(*args, **kw)

    monkeypatch.setattr(tcnmf, "replicate_sweep", spy_sweep)
    monkeypatch.setattr(trow, "nmf_fit_rowsharded", spy_fit)
    X = _counts(n=120, g=200, seed=6)
    fn = str(tmp_path / "c.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(120)]),
                         np.asarray([f"g{j}" for j in range(200)])), fn)
    obj = cNMF(str(tmp_path), "run", device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=7,
                num_highvar_genes=100, beta_loss="kullback-leibler")
    obj.factorize()
    obj.factorize(rowshard=True)
    obj.factorize(mesh_shape="1d")
    sizes = [(what, None if m is None else m.size) for what, m in seen]
    assert sizes == [("sweep", None), ("rowshard", 1), ("rowshard", 1),
                     ("rowshard", 4), ("rowshard", 4)]


def test_a_mesh_across_processes_is_refused_for_the_replicate_axis():
    m = Mesh(["cpu"] * 2, ("replicates",))
    m.owners = np.asarray([0, 1])
    with pytest.raises(ValueError, match="within one process"):
        trep.replicate_sweep(_counts(), [1, 2], 3, mesh=m, device="cpu")


def test_jax_sees_eight_virtual_devices():
    assert len(jax.devices()) == 8
