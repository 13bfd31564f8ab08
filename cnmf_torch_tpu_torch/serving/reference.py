"""Resident reference spectra for the serving tier.

A projection request is a usage refit against *published* reference
spectra, the one matrix every request shares. This module loads that
matrix once per daemon process and holds it on the device together with
its loop-invariant products, so a request pays only its own usage solve:

  * ``W`` (k x genes, f32), staged through the pipelined staging engine
    (:func:`~cnmf_torch_tpu_torch.parallel.streaming.stream_to_device`,
    the path factorize stages through);
  * ``WWT = W W^T`` for beta=2, or the per-component row sums of W for
    beta=1 (the KL MU denominator): constant across every request and
    every inner step, computed once here by the same torch ops the solo
    refit runs each call, so the products are bit-equal;
  * the solver parameters the solo refit (:meth:`cNMF.refit_usage`) would
    pass (beta, chunk size, inner cap, tolerance, l1), read from the run's
    parameters file.

Reference resolution: a run directory that has been through ``consensus``
holds one consensus-spectra artifact per (k, density threshold);
:func:`find_references` lists them and :func:`load_reference` picks by
(k, dt) or uniquely. A reference may instead live in a shard-store
directory (rows = components): pass its path as ``spectra_path``.
"""

from __future__ import annotations

import importlib
import json
import os
import re

import numpy as np

__all__ = ["ReferenceError", "ResidentReference", "find_references",
           "load_reference"]


class ReferenceError(ValueError):
    """No (or ambiguous) reference spectra for the requested run/k/dt."""


def find_references(run_dir: str) -> list[dict]:
    """Consensus-spectra artifacts under ``run_dir`` as ``{"k", "dt",
    "path"}`` rows, sorted by k then dt."""
    name = os.path.basename(os.path.normpath(run_dir))
    tmp = os.path.join(run_dir, "cnmf_tmp")
    if not os.path.isdir(tmp):
        return []
    pat = re.compile(
        re.escape(name) + r"\.spectra\.k_(\d+)\.dt_([0-9_]+)\.consensus"
        r"\.df\.npz$")
    out = []
    for fn in sorted(os.listdir(tmp)):
        m = pat.match(fn)
        if m:
            out.append({"k": int(m.group(1)),
                        "dt": m.group(2).replace("_", "."),
                        "path": os.path.join(tmp, fn)})
    return sorted(out, key=lambda r: (r["k"], r["dt"]))


def _load_run_params(run_dir: str) -> dict:
    """The run's solver parameters: the port writes JSON at the ``.yaml``
    path; a file that is not JSON (a JAX run directory) is read as YAML
    through a lazy import."""
    name = os.path.basename(os.path.normpath(run_dir))
    path = os.path.join(run_dir, "cnmf_tmp",
                        name + ".nmf_idvrun_params.yaml")
    if not os.path.exists(path):
        raise ReferenceError(
            f"no solver parameters at {path} — serve needs a prepared run "
            f"directory (output_dir/name with cnmf_tmp/)")
    with open(path) as f:
        text = f.read()
    try:
        params = json.loads(text)
    except ValueError:
        try:
            # only a JAX run directory's file gets here; the GPU machine
            # has no PyYAML and never needs it
            yaml = importlib.import_module("yaml")
            params = yaml.load(text, Loader=yaml.FullLoader)
        except Exception as exc:
            raise ReferenceError(
                f"cannot read the solver parameters at {path} (neither "
                f"JSON nor YAML: {exc})") from None
    if not isinstance(params, dict):
        raise ReferenceError(f"solver parameters at {path} are not a "
                             f"mapping")
    return params


class ResidentReference:
    """One published reference, loaded once and held on the device.

    Host side: ``W`` (k x genes f32), ``genes`` (column labels, None for
    store-backed references without names), ``components`` (row labels)
    and the solo refit's solver parameters. Device side (after
    :meth:`stage`): ``Wd`` as ``(1, k, genes)``, ``WWT`` (beta=2) or
    ``w_colsum`` (beta=1), and the tolerance scalar ``h_tol_dev``, on
    ``device``.
    """

    def __init__(self, W: np.ndarray, *, beta: float, chunk_size: int,
                 chunk_max_iter: int, h_tol: float = 0.05,
                 l1_H: float = 0.0, genes=None, components=None,
                 k: int | None = None, density_threshold=None,
                 source: str = "memory"):
        W = np.ascontiguousarray(np.asarray(W, dtype=np.float32))
        if W.ndim != 2 or not W.size:
            raise ReferenceError(
                f"reference spectra must be a (k, genes) matrix, got "
                f"shape {W.shape}")
        if not np.isfinite(W).all():
            raise ReferenceError("reference spectra contain nonfinite "
                                 "values; refusing to serve them")
        self.W = W
        self.beta = float(beta)
        self.chunk_size = int(chunk_size)
        self.chunk_max_iter = int(chunk_max_iter)
        self.h_tol = float(h_tol)
        self.l1_H = float(l1_H)
        self.genes = list(genes) if genes is not None else None
        self.components = (list(components) if components is not None
                           else list(range(1, W.shape[0] + 1)))
        self.k = int(k if k is not None else W.shape[0])
        self.density_threshold = density_threshold
        self.source = source
        # device residents (stage())
        self.device = None
        self.Wd = None
        self.WWT = None
        self.w_colsum = None
        self.h_tol_dev = None
        self.stage_stats = None

    @property
    def n_genes(self) -> int:
        return int(self.W.shape[1])

    def describe(self) -> dict:
        return {"source": self.source, "k": self.k,
                "n_genes": self.n_genes, "beta": self.beta,
                "density_threshold": self.density_threshold,
                "chunk_size": self.chunk_size,
                "chunk_max_iter": self.chunk_max_iter,
                "h_tol": self.h_tol, "l1_H": self.l1_H,
                "resident": self.Wd is not None,
                "device": None if self.device is None else str(self.device)}

    def stage(self, device="cuda", events=None):
        """Upload W through the staging engine onto ``device`` and compute
        the loop-invariant products there. Idempotent on one device;
        staging onto another raises (one daemon, one device). Returns
        self."""
        import torch

        from ..device import resolve_device
        from ..parallel.streaming import StreamStats, stream_to_device

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self.Wd is not None:
            if self.Wd.device != dev:
                raise ReferenceError(
                    f"reference already staged on {self.Wd.device}; "
                    f"cannot serve it from {dev}")
            return self
        stats = StreamStats()
        W = stream_to_device(self.W, dev, stats=stats, events=events)
        self.Wd = W[None]
        self.stage_stats = stats
        if self.beta == 2.0:
            # the solo refit's own expression (ops/nmf.py:fit_h), once a
            # daemon instead of once a call
            self.WWT = self.Wd @ self.Wd.mT
        elif self.beta == 1.0:
            # the KL MU denominator (ops/nmf.py:_update_H): the same
            # reduction, so the serve program's bits are the solo's
            self.w_colsum = self.Wd.sum(-1)
        self.h_tol_dev = torch.tensor(self.h_tol, dtype=torch.float32,
                                      device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.device = dev
        return self


def load_reference(run_dir: str, k: int | None = None,
                   density_threshold=None,
                   spectra_path: str | None = None) -> ResidentReference:
    """Load a reference from a consensus-complete run directory (or an
    explicit spectra artifact or shard-store directory), host side only;
    call :meth:`ResidentReference.stage` to put it on the device."""
    params = _load_run_params(run_dir)
    from ..ops.nmf import beta_loss_to_float

    common = dict(
        beta=beta_loss_to_float(params["beta_loss"]),
        chunk_size=int(params["online_chunk_size"]),
        chunk_max_iter=int(params["online_chunk_max_iter"]),
        l1_H=float(params["l1_ratio_H"]))

    if spectra_path is not None:
        if os.path.isdir(spectra_path):
            # a shard store (rows = components): every slab read checks
            # its content digest
            from ..utils.shardstore import open_shard_store

            store = open_shard_store(spectra_path)
            W = store.to_matrix()
            if hasattr(W, "toarray"):
                W = W.toarray()
            genes = None
            try:
                genes = store.var_names()
            except Exception:
                pass
            return ResidentReference(
                np.asarray(W), genes=genes, source=spectra_path, **common)
        from ..utils.io import load_df_from_npz

        df = load_df_from_npz(spectra_path)
        return ResidentReference(
            df.values, genes=df.columns, components=df.index,
            source=spectra_path, **common)

    refs = find_references(run_dir)
    if k is not None:
        refs = [r for r in refs if r["k"] == int(k)]
    if density_threshold is not None:
        dt = str(density_threshold)
        refs = [r for r in refs if r["dt"] == dt]
    if not refs:
        raise ReferenceError(
            f"no consensus spectra found under {run_dir}"
            + (f" for k={k}" if k is not None else "")
            + (f" dt={density_threshold}"
               if density_threshold is not None else "")
            + " — run `consensus` first")
    if len(refs) > 1:
        choices = ", ".join(f"k={r['k']} dt={r['dt']}" for r in refs)
        raise ReferenceError(
            f"multiple consensus spectra under {run_dir} ({choices}); "
            f"pick one with -k / --local-density-threshold")
    ref = refs[0]
    from ..utils.io import load_df_from_npz

    df = load_df_from_npz(ref["path"])
    return ResidentReference(
        df.values, genes=df.columns, components=df.index,
        k=ref["k"], density_threshold=ref["dt"], source=ref["path"],
        **common)
