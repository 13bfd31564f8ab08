"""The port's packed K-sweep against the JAX package's contract: the
``_auto_packed`` rule, per-(seed, k) spectra equal bit for bit to the per-K
sweeps' with exact zeros beyond each task's k, results in task order, the
JAX refusals, and ``factorize(packed=...)`` / ``--per-k-programs`` writing
the same iter spectra.

Inputs are made with numpy from a seed. Equality is exact (the port solves
each K-homogeneous slice at its own k, so the packed and per-K sweeps run
the same solves); the message checks are JAX's words.
"""

import itertools
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.runtime.planner import InputStats
from cnmf_torch_tpu.runtime.planner import _auto_packed as jax_auto_packed
from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
from cnmf_torch_tpu_torch.cli import main as port_main
from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe
from cnmf_torch_tpu_torch.ops.sparse import csr_to_ell
from cnmf_torch_tpu_torch.parallel import replicates as trep
from cnmf_torch_tpu_torch.utils.io import load_df_from_npz


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test workers share the cores; one torch thread each."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _dense(n=60, g=30, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 4)) @ rng.random((4, g))
            + 0.05 * rng.random((n, g))).astype(np.float32)


@pytest.mark.parametrize("use_ell,algo,init", [
    (False, "mu", "random"), (True, "mu", "random"),
    (False, "halsvar", "random"), (False, "mu", "nndsvd")])
def test_auto_packed_equals_jax(use_ell, algo, init):
    for n_ks, reps, workers in itertools.product((1, 3, 4, 5), (1, 8, 16,
                                                                33),
                                                 (0, 1, 2, 4)):
        stats = InputStats(n=100, g=50, algo=algo, init=init, n_ks=n_ks,
                           max_replicates=reps, total_workers=workers)
        assert trep._auto_packed(use_ell, algo, init, n_ks, reps,
                                 workers) == jax_auto_packed(stats, use_ell)


@pytest.mark.parametrize("mode", ["online", "batch"])
def test_packed_spectra_equal_per_k_in_task_order(mode):
    X = _dense()
    ks = [5, 3, 5, 4, 3, 3]
    seeds = [11, 12, 13, 14, 15, 16]
    kw = dict(mode=mode, online_chunk_size=25, batch_max_iter=40,
              return_usages=True, device="cpu")
    spectra, usages, errs = trep.replicate_sweep_packed(X, ks, seeds, **kw)
    assert spectra.shape == (6, 5, 30) and usages.shape == (6, 60, 5)
    for k in sorted(set(ks)):
        idx = [i for i, v in enumerate(ks) if v == k]
        s_k, u_k, e_k = trep.replicate_sweep(X, [seeds[i] for i in idx], k,
                                             **kw)
        np.testing.assert_array_equal(spectra[idx, :k], s_k)
        np.testing.assert_array_equal(usages[idx, :, :k], u_k)
        np.testing.assert_array_equal(errs[idx], e_k)
        assert (spectra[idx, k:] == 0).all()
        assert (usages[idx, :, k:] == 0).all()


def test_packed_on_slice_writes_each_slice():
    X = _dense(seed=1)
    ks, seeds = [4, 3, 4, 3, 4], [1, 2, 3, 4, 5]
    seen, trace = [], []

    def on_slice(idx, spectra, errs):
        assert len(trace) == len(seen) + 1
        seen.append((list(idx), spectra.shape, errs.shape))

    out = trep.replicate_sweep_packed(
        X, ks, seeds, online_chunk_size=30, replicates_per_batch=2,
        on_slice=on_slice, trace=trace, device="cpu")
    assert out is None
    assert seen == [([1, 3], (2, 4, 30), (2,)), ([0, 2], (2, 4, 30), (2,)),
                    ([4], (1, 4, 30), (1,))]
    empty = trep.replicate_sweep_packed(X, [], [], device="cpu")
    assert empty[0].shape == (0, 0, 30) and empty[2].shape == (0,)


def test_packed_refusals_carry_jax_messages():
    X = _dense()
    with pytest.raises(ValueError, match="does not support ELL"):
        trep.replicate_sweep_packed(csr_to_ell(sp.csr_matrix(X)), [3], [1],
                                    device="cpu")
    with pytest.raises(ValueError, match="require init='random'"):
        trep.replicate_sweep_packed(X, [3], [1], init="nndsvd",
                                    device="cpu")
    with pytest.raises(ValueError, match="mu-family recipes only"):
        trep.replicate_sweep_packed(
            X, [3], [1], recipe=SolverRecipe("hals", 1, False, "caller"),
            device="cpu")
    with pytest.raises(ValueError, match="sketch recipe"):
        trep.replicate_sweep_packed(
            X, [3], [1], beta_loss="kullback-leibler",
            recipe=SolverRecipe("sketch", 1, False, "caller",
                                sketch_dim=16, sketch_exact_every=2),
            device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        trep.replicate_sweep_packed(X, [3, 4], [1], device="cpu")


def _counts_file(tmp_path, n=80, g=120, seed=3):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(4) * 0.3, size=n)
    spectra = rng.gamma(0.5, 1.0, size=(4, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * 30.0).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = os.path.join(tmp_path, "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    return fn


def _iter_spectra(obj, ks, n_iter):
    return {(k, i): load_df_from_npz(obj.paths["iter_spectra"] % (k, i)).values
            for k in ks for i in range(n_iter)}


def test_factorize_packed_writes_the_per_k_spectra(tmp_path):
    """A 4-K ledger of 3 replicates a K packs by the rule; ``packed=True``,
    the auto default and ``--per-k-programs`` (``packed=False``) write the
    same iter spectra bit for bit, and the provenance names the path."""
    import json

    fn = _counts_file(tmp_path)
    ks, n_iter = [3, 4, 5, 6], 3
    outs, infos = {}, {}
    for name, packed in [("auto", None), ("packed", True),
                         ("perk", False)]:
        obj = cNMF(str(tmp_path), name, device="cpu")
        obj.prepare(fn, components=ks, n_iter=n_iter, seed=5,
                    num_highvar_genes=60, batch_size=40)
        obj.factorize(packed=packed)
        outs[name] = _iter_spectra(obj, ks, n_iter)
        infos[name] = dict(obj.factorize_info)
        with open(obj.paths["factorize_provenance"] % 0) as f:
            prov = json.load(f)
        want = "batched-packed" if packed in (None, True) else \
            "batched-dense"
        assert prov["engaged_path"] == want
    assert infos["auto"]["packed"] and not infos["perk"]["packed"]
    for key, val in outs["perk"].items():
        assert val.shape == (key[0], 60)
        np.testing.assert_array_equal(outs["packed"][key], val)
        np.testing.assert_array_equal(outs["auto"][key], val)
    for k in ks:
        assert len(infos["packed"]["trace"][k]) == 1
        np.testing.assert_array_equal(infos["packed"]["errs"][k],
                                      infos["perk"]["errs"][k])
    # the CLI's --per-k-programs pins the per-K sweeps
    port_main(["factorize", "--output-dir", str(tmp_path), "--name", "auto",
               "--device", "cpu", "--per-k-programs"])
    obj = cNMF(str(tmp_path), "auto", device="cpu")
    with open(obj.paths["factorize_provenance"] % 0) as f:
        assert json.load(f)["engaged_path"] == "batched-dense"
    for key, val in _iter_spectra(obj, ks, n_iter).items():
        np.testing.assert_array_equal(val, outs["perk"][key])


def test_factorize_packed_refusals(tmp_path, monkeypatch):
    """JAX's factorize refusals (``models/cnmf.py:1189-1193, 1266-1271``):
    a pinned packed sweep on the ELL lane, and on a non-random init."""
    fn = _counts_file(tmp_path, seed=4)
    obj = cNMF(str(tmp_path), "kl", device="cpu")
    obj.prepare(fn, components=[3, 4, 5, 6], n_iter=2, seed=5,
                beta_loss="kullback-leibler", num_highvar_genes=100,
                batch_size=40)
    monkeypatch.setenv("CNMF_TPU_SPARSE_BETA", "1")
    with pytest.raises(ValueError, match="packed K-sweeps run dense"):
        obj.factorize(packed=True)
    monkeypatch.delenv("CNMF_TPU_SPARSE_BETA")
    obj = cNMF(str(tmp_path), "nndsvd", device="cpu")
    obj.prepare(fn, components=[3, 4], n_iter=2, seed=5, init="nndsvd",
                num_highvar_genes=60, batch_size=40)
    with pytest.raises(ValueError, match="require init='random'"):
        obj.factorize(packed=True)
