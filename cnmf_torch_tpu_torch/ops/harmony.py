"""Harmony batch correction (Korsunsky et al. 2019) and its MOE ridge.

Port of ``cnmf_torch_tpu/ops/harmony.py`` as torch on ``device``:

* :func:`run_harmony`: soft k-means with the diversity penalty on the
  cosine-normalized PC embedding, then the per-cluster ridge correction
  of the embedding, for up to ``max_iter_harmony`` iterations. The
  cluster phase of an iteration is a host loop over rounds, each round a
  centroid refresh and one assignment update a cell block over a seeded
  permutation split into equal blocks. The permutations of all
  ``max_iter_kmeans`` rounds are drawn up front with numpy's
  ``default_rng(random_state)``, as in the JAX package, so the draws are
  the same; the round loop reads the objective to the host once a round
  and stops on the JAX package's rule (at least two rounds, then a
  relative change below ``epsilon_cluster``, tested in float32 as its
  ``while_loop`` tests it).
* :func:`moe_correct_ridge`: the mixture-of-experts ridge applied to any
  (features x cells) matrix, one ``torch.linalg.solve`` a cluster with
  the intercept row zeroed. The preprocess sidecar applies it to the
  gene matrix itself.

The k-means init is the port's ``ops/kmeans.py`` (a CPU
``torch.Generator``, not JAX's threefry stream); ``init_centers`` takes
the centres from the caller instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .kmeans import kmeans

__all__ = ["run_harmony", "moe_correct_ridge", "HarmonyResult",
           "harmony_program_shapes", "design_width"]


class HarmonyResult:
    """The harmonypy result surface the sidecar reads: ``Z_corr`` (d x n
    corrected embedding), ``Z_cos`` (its cosine normalization), ``R`` (K x
    n soft assignments), ``Phi_moe`` ((B+1) x n design), ``lamb`` ((B+1) x
    (B+1) ridge matrix), ``K``, ``objective_harmony``."""

    def __init__(self, Z_corr, Z_cos, R, Phi_moe, lamb, K, objectives):
        self.Z_corr = Z_corr
        self.Z_cos = Z_cos
        self.R = R
        self.Phi_moe = Phi_moe
        self.lamb = lamb
        self.K = K
        self.objective_harmony = objectives


def _categories(values) -> tuple[np.ndarray, np.ndarray]:
    """``(categories, present)``: the sorted distinct values of a column,
    missing entries (None, NaN) left out, as ``astype("category")`` orders
    them (strings and numbers alike)."""
    vals = np.asarray(values)
    if vals.dtype.kind == "O":
        present = np.asarray([v is not None and v == v for v in vals],
                             dtype=bool)
    elif vals.dtype.kind == "f":
        present = ~np.isnan(vals)
    else:
        present = np.ones(vals.shape, dtype=bool)
    return np.unique(vals[present]), present


def _one_hot_design(meta_data: dict, vars_use) -> np.ndarray:
    """(B x n) stacked one-hot encoding of the batch columns of
    ``meta_data`` (column name -> 1-D array), categories sorted."""
    if isinstance(vars_use, str):
        vars_use = [vars_use]
    blocks = []
    for v in vars_use:
        vals = np.asarray(meta_data[v])
        cats, present = _categories(vals)
        onehot = np.zeros((len(cats), len(vals)), dtype=np.float32)
        rows = np.searchsorted(cats, vals[present])
        onehot[rows, np.flatnonzero(present)] = 1.0
        blocks.append(onehot)
    return np.concatenate(blocks, axis=0)


def design_width(meta_data: dict, vars_use) -> int:
    """B, the rows :func:`_one_hot_design` makes, without building it."""
    if isinstance(vars_use, str):
        vars_use = [vars_use]
    return sum(len(_categories(meta_data[v])[0]) for v in vars_use)


def harmony_program_shapes(n: int, nclust: int | None = None,
                           block_size: float = 0.05):
    """``(K, n_blocks, n_pad)`` of an n-cell run: the cluster count and the
    equal block split of each round's permutation (the last block short by
    ``n_pad - n``)."""
    if nclust is None:
        nclust = int(min(np.round(n / 30.0), 100))
    K = max(int(nclust), 2)
    n_blocks = max(1, int(np.ceil(1.0 / block_size)))
    blk_len = int(np.ceil(n / n_blocks))
    return K, n_blocks, n_blocks * blk_len


def _normalize_cols(M):
    return M / torch.clamp_min(torch.linalg.vector_norm(M, dim=0,
                                                        keepdim=True), 1e-12)


def _assign_R(Y, Z_cos, sigma):
    """Soft assignments without the diversity term (the init)."""
    dist = 2.0 * (1.0 - Y.T @ Z_cos)
    Rl = -dist / sigma[:, None]
    Rl = Rl - Rl.max(0, keepdim=True).values
    R = torch.exp(Rl)
    return R / R.sum(0, keepdim=True)


def _block_R_update(dist_blk, phi_blk, E, O, R_blk, Pr_b, sigma, theta):
    """One cell block's assignments with the diversity penalty, the
    block's own share taken out of E (expected) and O (observed) first:
    R ~ exp(-dist/sigma) * [((E+1)/(O+1))^theta @ phi] (a sum over the
    batch variables when several are corrected). Returns ``(R_blk, E,
    O)``."""
    E = E - torch.outer(R_blk.sum(1), Pr_b)
    O = O - R_blk @ phi_blk.T
    dist_term = torch.exp(-dist_blk / sigma[:, None])
    penalty = torch.pow((E + 1.0) / (O + 1.0), theta[None, :]) @ phi_blk
    R_new = dist_term * penalty
    R_new = R_new / torch.clamp_min(R_new.sum(0, keepdim=True), 1e-30)
    E = E + torch.outer(R_new.sum(1), Pr_b)
    O = O + R_new @ phi_blk.T
    return R_new, E, O


def _clustering_objective(Y, Z_cos, R, E, O, sigma, theta):
    dist = 2.0 * (1.0 - Y.T @ Z_cos)
    kmeans_err = (R * dist).sum()
    entropy = (R * torch.log(torch.clamp_min(R, 1e-12))
               * sigma[:, None]).sum()
    diversity = (sigma[:, None] * theta * O
                 * torch.log((O + 1.0) / (E + 1.0))).sum()
    return kmeans_err + entropy + diversity


def _cluster_round(Z_cos, R, phi, E, O, perm, n_blocks, Pr_b, sigma, theta):
    """One clustering round: the centroid refresh, then every block of
    ``perm`` (split into ``n_blocks`` equal blocks, the last one short) in
    turn. Returns ``(R, E, O, objective)``; ``R`` is updated in place."""
    Y = _normalize_cols(Z_cos @ R.T)
    dist = 2.0 * (1.0 - Y.T @ Z_cos)
    blk_len = -(-perm.numel() // n_blocks)
    for b in range(n_blocks):
        idx = perm[b * blk_len:(b + 1) * blk_len]
        if idx.numel() == 0:
            continue
        R_blk, E, O = _block_R_update(dist[:, idx], phi[:, idx], E, O,
                                      R[:, idx], Pr_b, sigma, theta)
        R[:, idx] = R_blk
    return R, E, O, _clustering_objective(Y, Z_cos, R, E, O, sigma, theta)


def _converged(obj_prev, obj, eps) -> bool:
    """The JAX cluster phase's test, in float32 as its loop makes it."""
    f32 = np.float32
    return bool(np.abs(f32(obj_prev) - f32(obj))
                < f32(eps) * np.abs(f32(obj_prev)))


def _cluster_phase(Z_cos, R, phi, E, O, perms, n_blocks, Pr_b, sigma, theta,
                   eps, max_iter):
    """Up to ``max_iter`` rounds (one row of ``perms`` each), stopping after
    at least two once the objective's relative change is below ``eps``.
    Returns ``(R, E, O, obj_prev, obj, rounds_run)``."""
    R, E, O, obj = _cluster_round(Z_cos, R, phi, E, O, perms[0], n_blocks,
                                  Pr_b, sigma, theta)
    obj_prev, obj, it = float("inf"), float(obj), 1
    while it < max_iter and (it < 2 or not _converged(obj_prev, obj, eps)):
        R, E, O, new = _cluster_round(Z_cos, R, phi, E, O, perms[it],
                                      n_blocks, Pr_b, sigma, theta)
        obj_prev, obj, it = obj, float(new), it + 1
    return R, E, O, obj_prev, obj, it


def _moe_ridge(Z_orig, R, Phi_moe, lamb):
    """Z_corr = Z_orig - sum_k W_k^T Phi_Rk with per-cluster ridge experts
    W_k = (Phi_Rk Phi_moe^T + lamb)^{-1} Phi_Rk Z_orig^T, Phi_Rk = Phi_moe
    * R[k], the intercept row of each W_k zeroed (the correction never
    removes the global mean). All tensors on one device."""
    Z_corr = Z_orig.clone()
    for k in range(R.shape[0]):
        Phi_Rk = Phi_moe * R[k][None, :]
        x = Phi_Rk @ Phi_moe.T + lamb
        W = torch.linalg.solve(x, Phi_Rk @ Z_orig.T)
        W[0, :] = 0.0
        Z_corr -= W.T @ Phi_Rk
    return Z_corr


def _ridge_matrix(lamb, device):
    lamb = torch.as_tensor(np.asarray(lamb, dtype=np.float32)).to(device)
    return torch.diag(lamb) if lamb.ndim == 1 else lamb


def moe_correct_ridge(Z_orig, R, Phi_moe, lamb, device="cuda") -> np.ndarray:
    """The mixture-of-experts ridge correction of a (features x cells)
    matrix, in f32 on ``device``. ``lamb`` is the (B+1,) ridge diagonal
    (intercept entry 0) or the full (B+1) x (B+1) matrix of
    :class:`HarmonyResult`. Returns numpy."""
    dev = resolve_device(device)

    def on(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dev)

    return _moe_ridge(on(Z_orig), on(R), on(Phi_moe),
                      _ridge_matrix(lamb, dev)).cpu().numpy()


def run_harmony(data_mat, meta_data: dict, vars_use, theta=2.0, lamb=1.0,
                sigma: float = 0.1, nclust: int | None = None,
                max_iter_harmony: int = 10, max_iter_kmeans: int = 20,
                epsilon_cluster: float = 1e-5, epsilon_harmony: float = 1e-4,
                block_size: float = 0.05, random_state: int = 0,
                init_centers=None, device="cuda") -> HarmonyResult:
    """Harmonize a (cells x d) embedding over the batch columns
    ``vars_use`` of ``meta_data`` (column name -> 1-D array). Returns a
    :class:`HarmonyResult` of numpy arrays; ``Z_corr`` is d x n (harmonypy
    orientation). ``init_centers`` ((K, d)) replaces the k-means init's
    centres."""
    dev = resolve_device(device)
    f32 = torch.float32
    Z_host = np.asarray(data_mat, dtype=np.float32).T               # d x n
    d, n = Z_host.shape
    phi_host = _one_hot_design(meta_data, vars_use)                 # B x n
    B = phi_host.shape[0]
    K, n_blocks, _ = harmony_program_shapes(n, nclust, block_size)

    theta_vec = torch.full((B,), float(theta), dtype=f32, device=dev)
    lamb_diag = np.concatenate([[0.0], np.full(B, float(lamb))]).astype(
        np.float32)
    sigma_vec = torch.full((K,), float(sigma), dtype=f32, device=dev)
    Pr_b = torch.as_tensor((phi_host.sum(axis=1) / n).astype(np.float32)
                           ).to(dev)
    Phi_moe_host = np.concatenate([np.ones((1, n), np.float32), phi_host],
                                  axis=0)

    Z = torch.as_tensor(Z_host).to(dev)
    phi = torch.as_tensor(phi_host).to(dev)
    Phi_moe = torch.as_tensor(Phi_moe_host).to(dev)
    Z_cos = _normalize_cols(Z)

    # init: hard k-means on the cosine embedding, then soft assignments
    if init_centers is None:
        _, init_centers, _ = kmeans(Z_cos.T.cpu().numpy(), K, n_init=10,
                                    max_iter=25, seed=random_state,
                                    device=dev)
    Y = _normalize_cols(torch.as_tensor(np.array(init_centers, np.float32)
                                        ).to(dev).T)                # d x K
    R = _assign_R(Y, Z_cos, sigma_vec)                              # K x n
    E = torch.outer(R.sum(1), Pr_b)
    O = R @ phi.T

    rng = np.random.default_rng(random_state)
    lamb_mat = torch.diag(torch.as_tensor(lamb_diag).to(dev))
    objectives: list[float] = []
    Z_corr = Z
    for _ in range(max_iter_harmony):
        # every round's permutation drawn up front, as the JAX package
        # draws them (the tail of an early exit goes unused)
        perms = np.stack([rng.permutation(n) for _ in range(max_iter_kmeans)])
        perms = torch.as_tensor(perms.astype(np.int64)).to(dev)
        R, E, O, obj_prev, obj, _ = _cluster_phase(
            _normalize_cols(Z_corr), R, phi, E, O, perms, n_blocks, Pr_b,
            sigma_vec, theta_vec, epsilon_cluster, int(max_iter_kmeans))
        # the objective before the break on convergence, the last one on
        # exhaustion
        converged = abs(obj_prev - obj) < epsilon_cluster * abs(obj_prev)
        objectives.append(obj_prev if converged else obj)

        Z_corr = _moe_ridge(Z, R, Phi_moe, lamb_mat)

        if len(objectives) >= 3:
            o = objectives
            if abs(o[-2] - o[-1]) < epsilon_harmony * abs(o[-2]):
                break

    return HarmonyResult(
        Z_corr=Z_corr.cpu().numpy(),
        Z_cos=_normalize_cols(Z_corr).cpu().numpy(),
        R=R.cpu().numpy(),
        Phi_moe=Phi_moe_host,
        lamb=np.diag(lamb_diag),
        K=K,
        objectives=objectives,
    )
