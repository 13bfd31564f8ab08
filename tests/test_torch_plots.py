"""The port's figures (``models/plots.py``) against the JAX package's on
the CPU: the clustergram's row order, both figures' pixel sizes, the
clustergram and K-selection figure that ``consensus`` (now
``show_clustering=True`` by default) and ``k_selection_plot`` write, the
CLI's ``--show-clustering``, and the rule for a machine without
matplotlib (``ROADMAP.md`` D17): the figure skipped with a warning that
names it, everything else written, and any other drawing error raised."""

import os
import sys

import matplotlib
import numpy as np
import pandas as pd
import pytest
import torch

from cnmf_torch_tpu.models import plots as jax_plots
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.cli import main as port_cli
from cnmf_torch_tpu_torch.models import plots

matplotlib.use("Agg")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _png_size(path):
    import matplotlib.image as mpimg

    return mpimg.imread(path).shape


def _distances(seed=0, n=24, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, 6))
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + 0.3 * rng.normal(size=(n, 6))
    D = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    return D, labels + 1


def test_cluster_ordering_matches_jax():
    for seed in range(4):
        D, labels = _distances(seed)
        assert (plots.cluster_ordering(D, labels)
                == jax_plots.cluster_ordering(D, labels))


def test_clustergram_has_jax_pixel_size(tmp_path):
    D, labels = _distances(5)
    dens = np.random.default_rng(5).random(len(labels))
    keep = dens < 0.8
    Dk = D[np.ix_(keep, keep)]
    out = {}
    for name, mod in (("port", plots), ("jax", jax_plots)):
        out[name] = str(tmp_path / f"{name}.png")
        fig = mod.clustergram(Dk, labels[keep], dens, keep, 0.8, out[name],
                              close_fig=True)
        assert fig is not None
    assert _png_size(out["port"]) == _png_size(out["jax"])


def test_k_selection_figure_has_jax_pixel_size(tmp_path):
    ks = np.asarray([3.0, 4.0, 5.0])
    sil, err = np.asarray([0.9, 0.8, 0.85]), np.asarray([30.0, 25.0, 22.0])
    stats = Frame(np.stack([ks, np.full(3, 2.0), sil, err], axis=1),
                  np.arange(3), np.asarray(["k", "local_density_threshold",
                                            "silhouette",
                                            "prediction_error"]))
    port, jax = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    plots.k_selection_figure(stats, port, close_fig=True)
    jax_plots.k_selection_figure(
        pd.DataFrame({"k": ks, "silhouette": sil, "prediction_error": err}),
        jax, close_fig=True)
    assert _png_size(port) == _png_size(jax)


def _counts_fn(tmp, n=70, g=80, seed=3):
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
def combined(tmp_path_factory):
    """A small KL run through combine, on the CPU."""
    tmp = str(tmp_path_factory.mktemp("plots"))
    obj = cNMF(tmp, "run", device="cpu")
    obj.prepare(_counts_fn(tmp), components=[3, 4], n_iter=4, seed=2,
                num_highvar_genes=50, beta_loss="kullback-leibler",
                batch_size=64, max_NMF_iter=50)
    obj.factorize()
    obj.combine()
    return obj


def _artifacts(obj, k, dt):
    return [obj.paths[key] % (k, dt) for key in
            ("consensus_spectra", "consensus_usages", "gene_spectra_tpm",
             "gene_spectra_score")]


def test_consensus_draws_the_clustergram_by_default(combined):
    """The default ``show_clustering=True`` writes the clustergram beside
    the artifacts, from the density pass's distances and, on a second
    call, from the cached density (the distances recomputed)."""
    png = combined.paths["clustering_plot"] % (3, "2_0")
    for _ in range(2):
        if os.path.exists(png):
            os.unlink(png)
        combined.consensus(3, density_threshold=2.0,
                           close_clustergram_fig=True)
        assert os.path.exists(png)
        assert all(os.path.exists(p) for p in _artifacts(combined, 3, "2_0"))
    assert _png_size(png)[:2] == (2375, 3750)        # 15 x 9.5 in, 250 dpi


def test_k_selection_plot_draws_the_figure(combined):
    png = combined.paths["k_selection_plot"]
    if os.path.exists(png):
        os.unlink(png)
    stats = combined.k_selection_plot(close_fig=True)
    assert os.path.exists(png) and _png_size(png)[:2] == (1000, 1500)
    np.testing.assert_array_equal(stats.column("k"), [3.0, 4.0])


def test_without_matplotlib_the_figures_are_skipped_loudly(combined,
                                                           monkeypatch,
                                                           capsys):
    """``import matplotlib`` raising ``ImportError``: consensus and
    K-selection write every artifact and statistic, no PNG appears, and
    a ``RuntimeWarning`` naming the PNG is raised and printed to
    stderr."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    png = combined.paths["clustering_plot"] % (4, "0_5")
    with pytest.warns(RuntimeWarning, match="matplotlib") as rec:
        combined.consensus(4, density_threshold=0.5)
    assert any(png in str(w.message) for w in rec)
    assert png in capsys.readouterr().err
    assert not os.path.exists(png)
    assert all(os.path.exists(p) for p in _artifacts(combined, 4, "0_5"))
    stats_fn = combined.paths["k_selection_stats"]
    kpng = combined.paths["k_selection_plot"]
    for p in (stats_fn, kpng):
        if os.path.exists(p):
            os.unlink(p)
    with pytest.warns(RuntimeWarning, match=kpng.replace(".", r"\.")):
        combined.k_selection_plot()
    assert os.path.exists(stats_fn) and not os.path.exists(kpng)


def test_another_drawing_error_raises(combined, monkeypatch):
    """Only a missing matplotlib is skipped: a failure inside the drawing
    propagates."""
    from matplotlib.figure import Figure

    def broken(self, *args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(Figure, "savefig", broken)
    with pytest.raises(OSError, match="disk full"):
        combined.k_selection_plot(close_fig=True)
    with pytest.raises(OSError, match="disk full"):
        combined.consensus(3, density_threshold=2.0,
                           close_clustergram_fig=True)


def test_cli_show_clustering(combined):
    """``consensus`` through the CLI draws the clustergram only with
    ``--show-clustering``, as the JAX CLI does."""
    base = ["--output-dir", combined.output_dir, "--name", combined.name,
            "--device", "cpu", "-k", "4", "--local-density-threshold", "2.0"]
    png = combined.paths["clustering_plot"] % (4, "2_0")
    if os.path.exists(png):
        os.unlink(png)
    port_cli(["consensus", *base])
    assert not os.path.exists(png)
    port_cli(["consensus", *base, "--show-clustering"])
    assert os.path.exists(png)
