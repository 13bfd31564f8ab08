"""The preprocess sidecar's ops against the JAX package on the CPU: the
seurat_v3 HVGs, PCA, Harmony's design, cluster round and cluster phase,
its MOE ridge (also against the float64 oracles of
``tests/reference_oracles.py``), ``run_harmony`` from JAX's own k-means
centres, and the mutual-information estimator against scikit-learn and
its plain version. Inputs are made with numpy from a seed; each tolerance
is stated where it is used."""

import importlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from cnmf_torch_tpu.ops.kmeans import kmeans as jax_kmeans
from cnmf_torch_tpu_torch.ops import (moe_correct_ridge, pca, run_harmony,
                                      seurat_v3_hvg)
from cnmf_torch_tpu_torch.ops import harmony as th
from cnmf_torch_tpu_torch.ops.mutual_info import (mutual_info_classif,
                                                  mutual_info_classif_plain)
from tests.reference_oracles import (harmony_cluster_round_oracle,
                                     moe_correct_ridge_oracle)

# the JAX package's ops/__init__ binds ``pca`` and friends to functions,
# which shadow the submodules of the same name
jh = importlib.import_module("cnmf_torch_tpu.ops.harmony")
jp = importlib.import_module("cnmf_torch_tpu.ops.pca")
js = importlib.import_module("cnmf_torch_tpu.ops.seurat_v3")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


# -- PCA -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(80, 30), (30, 80)],
                         ids=["gram_g", "gram_n"])
@pytest.mark.parametrize("zero_center", [True, False])
def test_pca_matches_jax(shape, zero_center):
    """Scores, components and ratios at rtol 1e-4 (atol 1e-4 of the
    largest entry: f32 Gram matmuls in another summation order), with the
    signs of svd_flip identical."""
    X = np.random.default_rng(1).random(shape).astype(np.float32)
    want = jp.pca(X, n_comps=5, zero_center=zero_center)
    got = pca(X, n_comps=5, zero_center=zero_center, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    # svd_flip: each component's largest |loading| is positive
    top = np.abs(got[1]).argmax(1)
    assert (got[1][np.arange(5), top] > 0).all()
    assert got[0].dtype == np.float32 and got[1].shape == (5, shape[1])


def test_pca_of_a_csr_matrix_is_the_dense_one():
    X = np.random.default_rng(2).random((40, 20)).astype(np.float32)
    X[X < 0.5] = 0.0
    for a, b in zip(pca(sp.csr_matrix(X), 4, device="cpu"),
                    pca(X, 4, device="cpu")):
        np.testing.assert_array_equal(a, b)


# -- seurat_v3 ------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_seurat_v3_matches_jax(fmt):
    """The same HVG set and ranks, ``variances_norm`` at rtol 1e-5, the
    columns in JAX's order."""
    rng = np.random.default_rng(3)
    n, g = 300, 200
    X = rng.poisson(rng.uniform(0.5, 20, size=g), size=(n, g)).astype(float)
    X[:3, 0] = 400.0                     # clipping fires on gene 0
    X[:, 5] = 0.0                        # a constant gene
    if fmt == "csr":
        X = sp.csr_matrix(X)
    want = js.seurat_v3_hvg(X, n_top_genes=50)
    got = seurat_v3_hvg(X, n_top_genes=50, device="cpu")
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(got["highly_variable"],
                                  want["highly_variable"].values)
    np.testing.assert_array_equal(got["highly_variable_rank"],
                                  want["highly_variable_rank"].values)
    np.testing.assert_allclose(got["variances_norm"],
                               want["variances_norm"].values, rtol=1e-5)
    np.testing.assert_allclose(got["means"], want["means"].values,
                               rtol=1e-12)


# -- the design -------------------------------------------------------------

DESIGNS = {
    "strings": {"batch": np.array(["b", "a", "c", "a", "b", "c"] * 5,
                                  dtype=object)},
    "ints": {"batch": np.array([2, 0, 1, 10, 2, 0] * 5)},
    "two_variables": {"batch": np.array(["x", "y"] * 15, dtype=object),
                      "site": np.array([3, 1, 2] * 10)},
}


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_one_hot_design_matches_jax(name):
    """Categories come out sorted, as ``astype("category")`` orders them."""
    meta = DESIGNS[name]
    vars_use = list(meta) if len(meta) > 1 else "batch"
    df = pd.DataFrame(meta)
    np.testing.assert_array_equal(th._one_hot_design(meta, vars_use),
                                  jh._one_hot_design(df, vars_use))
    assert th.design_width(meta, vars_use) == jh.design_width(df, vars_use)


@pytest.mark.parametrize("n", [30, 103, 3000, 20000])
def test_harmony_program_shapes_match_jax(n):
    assert th.harmony_program_shapes(n) == jh.harmony_program_shapes(n)


# -- the MOE ridge ----------------------------------------------------------

def _ridge_inputs(seed=4, d=7, n=90, K=4, B=3):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(d, n)).astype(np.float32)
    R = rng.random(size=(K, n)).astype(np.float32)
    R /= R.sum(axis=0, keepdims=True)
    phi = np.zeros((B, n), np.float32)
    phi[rng.integers(0, B, size=n), np.arange(n)] = 1.0
    Phi_moe = np.concatenate([np.ones((1, n), np.float32), phi], axis=0)
    lamb = np.concatenate([[0.0], np.full(B, 1.0)]).astype(np.float32)
    return Z, R, Phi_moe, lamb


@pytest.mark.parametrize("lamb_form", ["vector", "matrix"])
def test_moe_correct_ridge_matches_jax_and_oracle(lamb_form):
    """Within rtol 1e-5 (atol 1e-5) of JAX's scan and of the float64
    oracle; the vector and matrix ``lamb`` give the same bits."""
    Z, R, Phi_moe, lamb = _ridge_inputs()
    lam = lamb if lamb_form == "vector" else np.diag(lamb)
    got = moe_correct_ridge(Z, R, Phi_moe, lam, device="cpu")
    np.testing.assert_allclose(got, jh.moe_correct_ridge(Z, R, Phi_moe, lam),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, moe_correct_ridge_oracle(Z, R, Phi_moe,
                                                             lam),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got, moe_correct_ridge(Z, R, Phi_moe, np.diag(lamb), device="cpu"))


def test_moe_ridge_keeps_the_intercept():
    """One cluster, a batch offset: the correction removes the offset and
    keeps the global mean (the intercept row is zeroed)."""
    rng = np.random.default_rng(5)
    n, g = 200, 40
    batch = np.tile([0, 1], n // 2)
    X = rng.normal(5.0, 1.0, size=(g, n))
    X[:, batch == 1] += 3.0
    phi = np.stack([(batch == 0), (batch == 1)]).astype(float)
    Xc = moe_correct_ridge(X, np.ones((1, n)),
                           np.vstack([np.ones((1, n)), phi]),
                           np.array([0.0, 1.0, 1.0]), device="cpu")
    gap = np.abs(Xc[:, batch == 0].mean(1) - Xc[:, batch == 1].mean(1))
    assert gap.mean() < 0.05 * 3.0
    assert abs(Xc.mean() - X.mean()) < 0.5


# -- the cluster phase --------------------------------------------------------

def _round_inputs(seed=6, d=6, n=103, K=5):
    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, 2, size=n)
    b2 = rng.integers(0, 3, size=n)
    phi = np.zeros((5, n), np.float32)
    phi[b1, np.arange(n)] = 1.0
    phi[2 + b2, np.arange(n)] = 1.0
    Z_cos = rng.normal(size=(d, n)).astype(np.float32)
    Z_cos /= np.linalg.norm(Z_cos, axis=0, keepdims=True)
    R0 = rng.random(size=(K, n)).astype(np.float32)
    R0 /= R0.sum(axis=0, keepdims=True)
    Pr_b = (phi.sum(axis=1) / n).astype(np.float32)
    return dict(Z_cos=Z_cos, R0=R0, phi=phi, Pr_b=Pr_b,
                sigma=np.full(K, 0.1, np.float32),
                theta=np.full(5, 2.0, np.float32),
                perm=rng.permutation(n))


def _port_round(inp, n_blocks):
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    R = t["R0"].clone()
    E = torch.outer(R.sum(1), t["Pr_b"])
    O = R @ t["phi"].T
    R, E, O, obj = th._cluster_round(t["Z_cos"], R, t["phi"], E, O,
                                     t["perm"], n_blocks, t["Pr_b"],
                                     t["sigma"], t["theta"])
    return R.numpy(), E.numpy(), O.numpy(), float(obj)


def test_one_cluster_round_matches_the_harmonypy_oracle():
    """The centroid refresh and every block's penalized update (two batch
    variables: the penalty sums over them) against the float64 oracle on
    the same equal blocks: R at RMS 1e-5, O at rtol 1e-4, the objective at
    1e-5 relative."""
    inp = _round_inputs()
    n_blocks = 4
    blk = -(-len(inp["perm"]) // n_blocks)
    blocks = [inp["perm"][i * blk:(i + 1) * blk] for i in range(n_blocks)]
    R_want, _, O_want, _, obj_want = harmony_cluster_round_oracle(
        inp["Z_cos"], inp["R0"], inp["phi"], inp["Pr_b"], inp["sigma"],
        inp["theta"], blocks)
    R, _, O, obj = _port_round(inp, n_blocks)
    assert np.sqrt(np.mean((R - R_want) ** 2)) < 1e-5
    np.testing.assert_allclose(O, O_want, rtol=1e-4, atol=1e-4)
    assert abs(obj - obj_want) / abs(obj_want) < 1e-5


def test_one_cluster_round_matches_jax():
    """The same padded permutation through JAX's fused round: R, E and O
    at rtol 1e-5 (atol 1e-6), the objective at 1e-5 relative."""
    inp = _round_inputs(seed=7)
    n, n_blocks = inp["R0"].shape[1], 4
    blk = -(-n // n_blocks)
    perm_pad = np.full(n_blocks * blk, n, np.int32)
    perm_pad[:n] = inp["perm"]
    E0 = jnp.outer(jnp.asarray(inp["R0"]).sum(axis=1), inp["Pr_b"])
    O0 = jnp.asarray(inp["R0"]) @ jnp.asarray(inp["phi"]).T
    want = jh._cluster_round(
        jnp.asarray(inp["Z_cos"]), jnp.asarray(inp["R0"]),
        jnp.asarray(inp["phi"]), E0, O0, jnp.asarray(perm_pad),
        jnp.asarray((perm_pad < n).astype(np.float32)),
        jnp.asarray(inp["Pr_b"]), jnp.asarray(inp["sigma"]),
        jnp.asarray(inp["theta"]), n_blocks)
    got = _port_round(inp, n_blocks)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    assert abs(got[3] - float(want[3])) / abs(float(want[3])) < 1e-5


@pytest.mark.parametrize("eps,rounds", [(1e30, 2), (0.0, 10)],
                         ids=["early_exit", "exhaustion"])
def test_cluster_phase_stops_as_jax_does(eps, rounds):
    """At least two rounds before a convergence exit, all ``max_iter``
    otherwise; the round count and the last two objectives equal JAX's
    (objectives at 1e-5 relative)."""
    inp = _round_inputs(seed=8, n=64, K=3)
    n, n_blocks = 64, 4
    rng = np.random.default_rng(9)
    perms = np.stack([rng.permutation(n) for _ in range(10)])
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    R = t["R0"].clone()
    E = torch.outer(R.sum(1), t["Pr_b"])
    O = R @ t["phi"].T
    *_, prev, obj, it = th._cluster_phase(
        t["Z_cos"], R, t["phi"], E, O, torch.as_tensor(perms), n_blocks,
        t["Pr_b"], t["sigma"], t["theta"], eps, 10)
    want = jh._cluster_phase(
        jnp.asarray(inp["Z_cos"]), jnp.asarray(inp["R0"]),
        jnp.asarray(inp["phi"]),
        jnp.outer(jnp.asarray(inp["R0"]).sum(axis=1), inp["Pr_b"]),
        jnp.asarray(inp["R0"]) @ jnp.asarray(inp["phi"]).T,
        jnp.asarray(perms.astype(np.int32)), jnp.asarray(inp["Pr_b"]),
        jnp.asarray(inp["sigma"]), jnp.asarray(inp["theta"]),
        jnp.float32(eps), n_blocks, 10)
    assert it == int(want[5]) == rounds
    assert abs(obj - float(want[4])) / abs(float(want[4])) < 1e-5
    assert abs(prev - float(want[3])) / abs(float(want[3])) < 1e-5


# -- run_harmony ------------------------------------------------------------

def _harmony_embedding(seed=10, n_per=150, d=10):
    rng = np.random.default_rng(seed)
    bio = np.repeat([0, 1], n_per)
    batch = np.tile([0, 1, 2], 2 * n_per // 3)
    Z = rng.normal(size=(2 * n_per, d)).astype(np.float32)
    Z[bio == 1, 0] += 6.0
    Z[batch == 1, 1] += 4.0
    Z[batch == 2, 2] += 3.0
    meta = {"batch": np.asarray([f"b{b}" for b in batch], dtype=object)}
    return Z, meta, bio, batch


def test_run_harmony_from_jax_centres_matches_jax():
    """Given JAX's own k-means centres (the one draw the packages cannot
    share): ``Z_corr`` and ``R`` within 1e-3 absolute, every objective
    within 1e-4 relative, the same iteration count."""
    Z, meta, _, _ = _harmony_embedding()
    want = jh.run_harmony(Z, pd.DataFrame(meta), "batch", theta=2.0,
                          max_iter_harmony=10, nclust=10, random_state=1)
    Z_cos = np.asarray(jh._normalize_cols(jnp.asarray(Z.T)))
    _, centers, _ = jax_kmeans(Z_cos.T, 10, n_init=10, max_iter=25, seed=1)
    got = run_harmony(Z, meta, "batch", theta=2.0, max_iter_harmony=10,
                      nclust=10, random_state=1,
                      init_centers=np.asarray(centers), device="cpu")
    assert len(got.objective_harmony) == len(want.objective_harmony)
    np.testing.assert_allclose(got.objective_harmony,
                               want.objective_harmony, rtol=1e-4)
    np.testing.assert_allclose(got.Z_corr, want.Z_corr, atol=1e-3)
    np.testing.assert_allclose(got.R, want.R, atol=1e-3)
    np.testing.assert_array_equal(got.Phi_moe, want.Phi_moe)
    np.testing.assert_array_equal(got.lamb, want.lamb)
    assert got.K == want.K == 10


def test_run_harmony_mixes_the_batches_and_keeps_the_biology():
    """From the port's own k-means: the between-batch gap of the
    embedding falls below 0.35 of the uncorrected one (JAX's band) and
    the biological gap stays above 0.7; a rerun gives the same bits."""
    Z, meta, bio, batch = _harmony_embedding(seed=11)
    res = run_harmony(Z, meta, "batch", theta=2.0, max_iter_harmony=10,
                      nclust=10, random_state=1, device="cpu")
    Zc = res.Z_corr.T

    def gap(M, lab, a, b):
        return np.linalg.norm(M[lab == a].mean(0) - M[lab == b].mean(0))

    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert gap(Zc, batch, a, b) < 0.35 * gap(Z, batch, a, b)
    assert gap(Zc, bio, 0, 1) > 0.7 * gap(Z, bio, 0, 1)
    again = run_harmony(Z, meta, "batch", theta=2.0, max_iter_harmony=10,
                        nclust=10, random_state=1, device="cpu")
    np.testing.assert_array_equal(again.Z_corr, res.Z_corr)


# -- mutual information -----------------------------------------------------

MI_CASES = {"three_labels": (150, 40, 3, 0), "five_labels": (400, 60, 5, 7),
            "singleton_label": (57, 10, 4, 3)}


@pytest.mark.parametrize("case", sorted(MI_CASES))
def test_mutual_info_matches_sklearn_and_its_plain_version(case):
    """scikit-learn's ``mutual_info_classif`` (the JAX package's
    estimator) within 1e-12, the plain numpy version within 1e-12; a
    constant column and a label that occurs once included."""
    from sklearn.feature_selection import mutual_info_classif as sk_mi

    n, g, ncl, seed = MI_CASES[case]
    rng = np.random.default_rng(seed)
    cluster = rng.integers(0, ncl, size=n)
    if case == "singleton_label":
        cluster[0] = 99
    X = rng.poisson(5.0, size=(n, g)).astype(float)
    for c in range(ncl):
        X[np.ix_(cluster == c, range(5))] += c * 10
    X[:, 7] = 0.0
    want = sk_mi(X, cluster, discrete_features="auto", n_neighbors=3,
                 copy=True, random_state=seed)
    got = mutual_info_classif(X, cluster, 3, seed, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        mutual_info_classif_plain(X, cluster, 3, seed), got, rtol=0,
        atol=1e-12)
