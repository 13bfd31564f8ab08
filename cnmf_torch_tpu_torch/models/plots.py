"""Diagnostic figures: the consensus clustergram and the K-selection plot.

Own copy of the JAX package's ``cnmf_torch_tpu/models/plots.py``: the
same figures, drawn on the host with matplotlib (display work, never on
the device), and the same within-cluster leaf order from scipy's
average-linkage hierarchy. matplotlib is imported inside the functions
(through ``importlib``), never when this module is imported.

A machine without matplotlib (the GPU machine has none) still runs every
stage that draws a figure: when ``import matplotlib`` raises
``ImportError``, and only then, the figure is skipped with a
``RuntimeWarning`` that names its path, and the same line goes to stderr;
every artifact and statistic is written as usual. Any other error while
drawing raises (``ROADMAP.md`` D17).
"""

from __future__ import annotations

import importlib
import os
import sys
import warnings

import numpy as np

from ..utils.io import atomic_artifact

__all__ = ["clustergram", "k_selection_figure", "cluster_ordering",
           "pyplot_or_skip"]


def pyplot_or_skip(out_png: str):
    """``matplotlib.pyplot`` on the Agg backend, or ``None`` when matplotlib
    is not installed: then the figure at ``out_png`` is skipped with a
    ``RuntimeWarning`` naming it, and the same line goes to stderr."""
    try:
        matplotlib = importlib.import_module("matplotlib")
    except ImportError:
        msg = (f"figure not written: {out_png} (matplotlib is not "
               "installed; the statistics and artifacts are written)")
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
        print(msg, file=sys.stderr)
        return None
    matplotlib.use("Agg")
    return importlib.import_module("matplotlib.pyplot")


def _save_fig_atomic(fig, out_png: str, dpi: int):
    """Land a figure with the temp-and-rename of every artifact writer. The
    temp name has no extension, so the format comes from the target's
    suffix."""
    ext = os.path.splitext(os.path.basename(out_png))[1]
    with atomic_artifact(out_png) as tmp:
        fig.savefig(tmp, dpi=dpi, format=ext[1:] if ext else "png")


def cluster_ordering(topics_dist: np.ndarray, cluster_labels) -> list[int]:
    """Row order for the clustergram: clusters in label order, the rows of
    a cluster in the leaf order of its average-linkage hierarchy."""
    from scipy.cluster.hierarchy import leaves_list, linkage
    from scipy.spatial.distance import squareform

    labels = np.asarray(cluster_labels)
    order: list[int] = []
    for cl in sorted(set(labels)):
        members = np.where(labels == cl)[0]
        if len(members) > 1:
            cl_dist = squareform(topics_dist[np.ix_(members, members)],
                                 checks=False)
            cl_dist[cl_dist < 0] = 0.0
            leaves = leaves_list(linkage(cl_dist, "average"))
            order += list(members[leaves])
        else:
            order += list(members)
    return order


def clustergram(topics_dist, cluster_labels, local_density, density_filter,
                density_threshold, out_png: str, close_fig: bool = False):
    """The distance matrix in clustergram order with cluster colour strips,
    the local-density histogram and the filter threshold. Returns the
    figure, or ``None`` when matplotlib is missing."""
    plt = pyplot_or_skip(out_png)
    if plt is None:
        return None
    gridspec = importlib.import_module("matplotlib.gridspec")

    labels = np.asarray(cluster_labels)
    order = cluster_ordering(np.asarray(topics_dist), labels)
    D = np.asarray(topics_dist)[np.ix_(order, order)]

    width_ratios = [0.5, 9, 0.5, 4, 1]
    height_ratios = [0.5, 9]
    fig = plt.figure(figsize=(sum(width_ratios), sum(height_ratios)))
    gs = gridspec.GridSpec(len(height_ratios), len(width_ratios), fig,
                           0.01, 0.01, 0.98, 0.98,
                           height_ratios=height_ratios,
                           width_ratios=width_ratios, wspace=0, hspace=0)

    dist_ax = fig.add_subplot(gs[1, 1], xticks=[], yticks=[], frameon=True)
    dist_im = dist_ax.imshow(D, interpolation="none", cmap="viridis",
                             aspect="auto", rasterized=True)

    left_ax = fig.add_subplot(gs[1, 0], xticks=[], yticks=[], frameon=True)
    left_ax.imshow(labels[order].reshape(-1, 1), interpolation="none",
                   cmap="Spectral", aspect="auto", rasterized=True)
    top_ax = fig.add_subplot(gs[0, 1], xticks=[], yticks=[], frameon=True)
    top_ax.imshow(labels[order].reshape(1, -1), interpolation="none",
                  cmap="Spectral", aspect="auto", rasterized=True)

    hist_gs = gridspec.GridSpecFromSubplotSpec(3, 1, subplot_spec=gs[1, 3],
                                               wspace=0, hspace=0)
    hist_ax = fig.add_subplot(hist_gs[0, 0], frameon=True,
                              title="Local density histogram")
    if local_density is not None:
        hist_ax.hist(np.asarray(local_density).ravel(),
                     bins=np.linspace(0, 1, 50))
        hist_ax.yaxis.tick_right()
        xlim = hist_ax.get_xlim()
        ylim = hist_ax.get_ylim()
        if density_threshold < xlim[1]:
            hist_ax.axvline(density_threshold, linestyle="--", color="k")
            hist_ax.text(density_threshold + 0.02, ylim[1] * 0.95,
                         "filtering\nthreshold\n\n", va="top")
        hist_ax.set_xlim(xlim)
        if density_filter is not None:
            df = np.asarray(density_filter)
            hist_ax.set_xlabel(
                "Mean distance to k nearest neighbors\n\n"
                "%d/%d (%.0f%%) spectra above threshold\nwere removed prior "
                "to clustering" % ((~df).sum(), len(df), 100 * (~df).mean()))

    cbar_gs = gridspec.GridSpecFromSubplotSpec(8, 1,
                                               subplot_spec=hist_gs[1, 0],
                                               wspace=0, hspace=0)
    cbar_ax = fig.add_subplot(cbar_gs[4, 0], frameon=True,
                              title="Euclidean Distance")
    fig.colorbar(dist_im, cax=cbar_ax,
                 ticks=np.linspace(D.min(), D.max(), 3),
                 orientation="horizontal")

    _save_fig_atomic(fig, out_png, dpi=250)
    if close_fig:
        plt.close(fig)
    return fig


def k_selection_figure(stats, out_png: str, close_fig: bool = False):
    """Stability (silhouette, left axis) and prediction error (right axis)
    against K, from the K-selection statistics :class:`~..utils.io.Frame`.
    Returns the figure, or ``None`` when matplotlib is missing."""
    plt = pyplot_or_skip(out_png)
    if plt is None:
        return None
    ks = stats.column("k")
    fig = plt.figure(figsize=(6, 4))
    ax1 = fig.add_subplot(111)
    ax2 = ax1.twinx()
    ax1.plot(ks, stats.column("silhouette"), "o-", color="b")
    ax1.set_ylabel("Stability", color="b", fontsize=15)
    for tl in ax1.get_yticklabels():
        tl.set_color("b")
    ax2.plot(ks, stats.column("prediction_error"), "o-", color="r")
    ax2.set_ylabel("Error", color="r", fontsize=15)
    for tl in ax2.get_yticklabels():
        tl.set_color("r")
    ax1.set_xlabel("Number of Components", fontsize=15)
    ax1.grid("on")
    plt.tight_layout()
    _save_fig_atomic(fig, out_png, dpi=250)
    if close_fig:
        plt.close(fig)
    return fig
