"""The (cells x genes) grid (``parallel/grid2d.py``), on the CPU.

JAX's ``nmf_fit_grid2d`` is not a reliable live reference in this
environment (its ``shard_map`` programs raise on the installed JAX, in an
order-dependent subset of ``tests/test_grid2d.py``), so the port's grid is
held to what runs: JAX's row-sharded solve over the grid's cell shards
from JAX's init (``rtol 1e-4``: the grid splits the gene contractions the
1-D solve runs whole), and the port's own 1-D solve — bit for bit over a
trivial gene axis with one statistics block, as JAX's own
``test_grid_trivial_gene_axis_*`` claims for its grid. The pure helpers
(``_grid_rc``, ``grid_blocks``, ``grid_pass_cost``,
``coll_bytes_per_pass``, the cost model's grid lane) equal JAX's bit for
bit; JAX's grid module is imported for them and never solves here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cnmf_torch_tpu.obs import costmodel as jcm
from cnmf_torch_tpu.ops import nmf as jnmf
from cnmf_torch_tpu.parallel import grid2d as jgrid
from cnmf_torch_tpu.parallel import rowshard as jrs
from cnmf_torch_tpu_torch.obs import costmodel as tcm
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.ops.nmf import random_init
from cnmf_torch_tpu_torch.parallel import grid2d as tgrid
from cnmf_torch_tpu_torch.parallel import rowshard as trs
from cnmf_torch_tpu_torch.parallel.mesh import Mesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _counts(n=300, g=202, k=4, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.dirichlet(np.ones(k) * 0.3, size=n)
    S = rng.gamma(0.3, 1.0, size=(k, g)) * 50.0 / g
    X = rng.poisson(U @ S * 0.7).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    return X


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grid(c, g):
    return tgrid.mesh_grid2d(c, g, devices=["cpu"] * (c * g))


# ---------------------------------------------------------------------------
# the pure helpers, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,n_proc", [(1, 1), (2, 1), (4, 1), (6, 1),
                                          (8, 1), (8, 2), (8, 4), (12, 3),
                                          (16, 1)])
def test_grid_rc_is_jax(n_dev, n_proc, monkeypatch):
    monkeypatch.delenv("CNMF_TPU_GRID_SHAPE", raising=False)
    assert tgrid._grid_rc(n_dev, n_proc) == jgrid._grid_rc(n_dev, n_proc)


@pytest.mark.parametrize("shape", ["4x2", "2x4", "8x1", "auto"])
def test_the_pinned_grid_shape_is_jax(shape, monkeypatch):
    monkeypatch.setenv("CNMF_TPU_GRID_SHAPE", shape)
    assert tgrid._grid_rc(8, 1) == jgrid._grid_rc(8, 1)
    monkeypatch.setenv("CNMF_TPU_GRID_SHAPE", "3x3")
    with pytest.raises(ValueError, match="devices"):
        tgrid._grid_rc(8, 1)


@pytest.mark.parametrize("extent", [1, 7, 63, 64, 100, 150, 202, 1000])
@pytest.mark.parametrize("want", ["", "1", "3", "8"])
def test_grid_blocks_is_jax(extent, want, monkeypatch):
    if want:
        monkeypatch.setenv("CNMF_TPU_GRID_BLOCKS", want)
    else:
        monkeypatch.delenv("CNMF_TPU_GRID_BLOCKS", raising=False)
    assert tgrid.grid_blocks(extent) == jgrid.grid_blocks(extent)


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0])
@pytest.mark.parametrize("rows,gl,k,nb", [(150, 101, 4, 1), (1000, 500, 9, 4),
                                          (62500, 1000, 13, 2)])
def test_grid_pass_cost_and_bytes_are_jax(beta, rows, gl, k, nb):
    kw = dict(nblk_h=nb, nblk_w=nb, n_dev=4)
    assert tgrid.grid_pass_cost(rows, gl, k, beta, **kw) == \
        jgrid.grid_pass_cost(rows, gl, k, beta, **kw)
    assert tgrid.coll_bytes_per_pass(rows, gl, k, beta, nb, nb, 4) == \
        jgrid.coll_bytes_per_pass(rows, gl, k, beta, nb, nb, 4)


@pytest.mark.parametrize("shape,blocks", [([2, 2], 4), ([4, 1], 1),
                                          ([1, 1], None)])
def test_the_cost_models_grid_lane_is_jax(shape, blocks):
    kw = dict(beta=2.0, grid_shape=shape, grid_blocks=blocks)
    assert tcm.lane_cost("grid2d", 10_000, 2_000, 9, **kw) == \
        jcm.lane_cost("grid2d", 10_000, 2_000, 9, **kw)


def test_mesh_grid2d_shapes():
    m = tgrid.mesh_grid2d(devices=["cpu"] * 8)
    assert m.axis_names == ("cells", "genes")
    assert m.devices.shape == jgrid.mesh_grid2d().devices.shape
    assert _grid(4, 2).devices.shape == (4, 2)
    with pytest.raises(ValueError, match="does not tile"):
        tgrid.mesh_grid2d(3, 3, devices=["cpu"] * 8)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler",
                                       "itakura-saito"])
@pytest.mark.parametrize("c,g", [(2, 1), (2, 2), (4, 2)])
def test_the_grid_matches_jax_row_sharded_solve(beta_loss, c, g):
    X = _counts()
    jmesh = JMesh(np.asarray(jax.devices()[:c]), ("cells",))
    Hj, Wj, ej = jrs.nmf_fit_rowsharded(X, 4, jmesh, beta_loss=beta_loss,
                                        seed=3, n_passes=6)
    n_pad = 300 + (-300) % c
    Xp = jnp.asarray(np.pad(X, ((0, n_pad - 300), (0, 0))))
    H0, W0 = jnmf.random_init(jax.random.key(3), n_pad, 202, 4, jnp.mean(Xp))
    payloads = []
    Ht, Wt, et = tgrid.nmf_fit_grid2d(
        X, 4, _grid(c, g), beta_loss=beta_loss, n_passes=6,
        init_factors=(np.asarray(H0), np.asarray(W0)),
        telemetry_sink=payloads.append)
    assert Ht.shape == (300, 4) and Wt.shape == (4, 202)
    assert _rel(Wt, Wj) < 1e-4 and _rel(Ht, Hj) < 1e-4
    assert abs(et - ej) / ej < 1e-4
    assert payloads[0]["mode"] == "grid2d"
    assert payloads[0]["kernel"] == "dense"


@pytest.mark.parametrize("beta_loss", ["frobenius", "kullback-leibler",
                                       "itakura-saito"])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_a_trivial_gene_axis_is_the_1d_solve_bit_for_bit(beta_loss, c,
                                                         monkeypatch):
    monkeypatch.setenv("CNMF_TPU_GRID_BLOCKS", "1")
    X = _counts(seed=1)
    init = tuple(t.numpy() for t in random_init(5, 300, 202, 4,
                                                float(X.mean())))
    Hg, Wg, eg = tgrid.nmf_fit_grid2d(X, 4, _grid(c, 1),
                                      beta_loss=beta_loss, n_passes=5,
                                      init_factors=init)
    Hr, Wr, er = trs.nmf_fit_rowsharded(X, 4, beta_loss=beta_loss,
                                        n_passes=5, init_factors=init,
                                        mesh=Mesh(["cpu"] * c, ("cells",)))
    np.testing.assert_array_equal(Wg, Wr)
    np.testing.assert_array_equal(Hg, Hr)
    assert eg == er


def test_the_overlap_gives_the_same_bits(monkeypatch):
    X = _counts(seed=2)
    kw = dict(beta_loss="kullback-leibler", n_passes=4, seed=2)
    monkeypatch.setenv("CNMF_TPU_GRID_OVERLAP", "1")
    a = tgrid.nmf_fit_grid2d(X, 4, _grid(2, 2), **kw)
    monkeypatch.setenv("CNMF_TPU_GRID_OVERLAP", "0")
    b = tgrid.nmf_fit_grid2d(X, 4, _grid(2, 2), **kw)
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_the_dna_lane_runs_on_the_grid():
    from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe

    X = _counts(seed=3)
    init = tuple(t.numpy() for t in random_init(1, 300, 202, 4,
                                                float(X.mean())))
    dna = SolverRecipe("dna", 1, True, "caller")
    Hg, Wg, eg = tgrid.nmf_fit_grid2d(
        X, 4, _grid(2, 2), beta_loss="kullback-leibler", n_passes=4,
        init_factors=init, recipe=dna)
    Hr, Wr, er = trs.nmf_fit_rowsharded(
        X, 4, beta_loss="kullback-leibler", n_passes=4, init_factors=init,
        recipe=dna, mesh=Mesh(["cpu"] * 2, ("cells",)))
    assert _rel(Wg, Wr) < 1e-3 and abs(eg - er) / er < 1e-4


def test_the_grid_refuses_what_it_lacks():
    from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe

    X = _counts(n=40, g=30)
    with pytest.raises(ValueError, match="init='random'"):
        tgrid.nmf_fit_grid2d(X, 3, _grid(2, 1), init="nndsvd")
    with pytest.raises(ValueError, match="sketch"):
        tgrid.nmf_fit_grid2d(X, 3, _grid(2, 1),
                             beta_loss="kullback-leibler",
                             recipe=SolverRecipe("sketch", 1, False,
                                                 "caller"))
    with pytest.raises(ValueError, match="beta in"):
        tgrid.nmf_fit_grid2d(X, 3, _grid(2, 1), beta_loss=1.5)
    with pytest.raises(ValueError, match="'cells', 'genes'"):
        tgrid.nmf_fit_grid2d(X, 3, Mesh(["cpu"] * 2, ("cells",)))


def test_the_collective_event_and_the_probe():
    class Rec:
        enabled = True

        def __init__(self):
            self.events = []

        def emit(self, t, **f):
            self.events.append(dict(f, t=t))

    X = _counts(seed=4)
    rec = Rec()
    gx, rpad, cpad = tgrid.stage_x_grid(X, _grid(2, 2))
    assert (gx.shape, rpad, cpad) == ((300, 202), 0, 0)
    kl_ell.reset_launches()
    tgrid.nmf_fit_grid2d(gx, 4, gx.mesh, beta_loss="kullback-leibler",
                         n_passes=3, seed=1, events=rec)
    assert sum(kl_ell.launches.values()) == 0
    (ev,) = [e for e in rec.events if e["t"] == "collective"]
    ctx = ev["context"]
    assert ctx["mesh_shape"] == [2, 2] and ctx["kernel"] == "dense"
    assert ev["nbytes"] == tgrid.coll_bytes_per_pass(
        150, 101, 4, 1.0, ctx["blocks"][0], ctx["blocks"][1], 4)
    probe = tgrid.measure_collectives(gx, 4, beta=2.0, repeats=2)
    assert probe["nbytes_per_pass"] > 0 and probe["pass_overlap_s"] > 0
    assert 0.0 <= probe["pass_hidden_fraction"] <= 1.0


def test_a_grid_factorize_pipeline(tmp_path, monkeypatch):
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
    from cnmf_torch_tpu_torch.utils import telemetry

    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.setenv("CNMF_TPU_PERF_MODEL", "1")
    rng = np.random.default_rng(5)
    X = rng.poisson(rng.gamma(0.5, 1.0, (240, 1))
                    * rng.gamma(0.5, 1.0, (1, 300)) * 4.0).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    fn = str(tmp_path / "c.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(240)]),
                         np.asarray([f"g{j}" for j in range(300)])), fn)
    obj = cNMF(str(tmp_path), "g", device="cpu")
    obj.prepare(fn, components=[3], n_iter=2, seed=3,
                num_highvar_genes=150, beta_loss="kullback-leibler")
    obj.factorize(mesh=_grid(2, 2))
    assert obj.factorize_info["mode"] == "grid2d"
    assert obj.factorize_info["mesh_shape"] == [2, 2]
    obj.combine()
    events = telemetry.read_events(obj._events.path)
    (pm,) = [e for e in events if e["t"] == "perf_model"]
    assert (pm["stage"], pm["lane"]) == ("factorize_grid2d", "grid2d")
    assert pm["predicted"]["flops"] > 0
    assert len([e for e in events if e["t"] == "collective"]) == 2
    telemetry.validate_events_file(obj._events.path)
