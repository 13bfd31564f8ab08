"""The CUDA ELL KL kernels against their plain torch versions, on the card
(the three of the MU solvers and the two of the batch dna recipe).

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one. Run them on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``
(``--noconftest`` because ``tests/conftest.py`` imports JAX, which the GPU
machine does not have). This file imports torch and the port only.

Tolerances: f32 at ``rtol 2e-5`` (the kernels sum in another order than
the plain versions), bf16 at ``rtol 2e-2`` (the bf16 band of
``tests/test_pallas.py``); the kernels themselves are deterministic, so
two launches on the same inputs must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from cnmf_torch_tpu_torch.ops import sparse
from cnmf_torch_tpu_torch.ops.kernels import kl_ell
from cnmf_torch_tpu_torch.ops.kernels.edge_cases import (EDGE_SHAPES,
                                                         edge_inputs)

pytestmark = pytest.mark.cuda

# the designated solver tests that CNMF_TPU_SANITIZE=1 runs under
# utils/sanitize.py:sync_guard, fixture set-up included (the counterpart of
# tests/conftest.py's sanitize subset): written guard-clean, their inputs
# staged and their results fetched inside host_read(). Torch has no switch
# like jax_debug_nans; they assert finite outputs instead.
SANITIZE_SUBSET = (
    "test_sync_guard_raises_on_an_implicit_sync",
    "test_nmf_fit_batch_no_implicit_syncs",
    "test_nmf_fit_online_kl_ell_no_implicit_syncs",
    "test_nmf_fit_online_bf16_lanes_no_implicit_syncs",
    "test_rowsharded_pass_no_implicit_syncs",
    "test_batched_project_no_implicit_syncs",
)


@pytest.fixture(autouse=True)
def _sanitize_guard(request):
    """Opt-in sanitizer wrapper of the designated subset (above)."""
    from cnmf_torch_tpu_torch.utils.sanitize import (sanitize_enabled,
                                                     sync_guard)

    if (request.node.originalname not in SANITIZE_SUBSET
            or not sanitize_enabled() or not torch.cuda.is_available()):
        yield
        return
    with sync_guard("cuda"):
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, rtol, atol=1e-6):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_h_stats_matches_plain(cuda_device, n, g, k, R, bf16):
    x, H, W = edge_inputs(n, g, k, R, 0.06, 1, cuda_device, zero_rows=3,
                          full_row=True)
    assert int((x.vals[-1] > 0).sum()) == x.vals.shape[1]
    vals = x.vals.to(torch.bfloat16) if bf16 else x.vals
    got = kl_ell.h_stats(vals, x.cols, H, W, bf16)
    again = kl_ell.h_stats(vals, x.cols, H, W, bf16)
    torch.cuda.synchronize()
    want = kl_ell.h_stats_plain(vals, x.cols, H, W, bf16)
    _close(got, want, 2e-2 if bf16 else 2e-5)
    assert torch.equal(got, again)
    assert torch.all(got[:, :3] == 0)
    assert not torch.signbit(got[:, :3]).any()


@pytest.mark.parametrize("bf16", [False, True])
def test_h_stats_table_placement(cuda_device, bf16):
    """The packed W table sits in shared memory at the pipeline's shapes
    and is read from device memory where it does not fit."""
    fits = kl_ell.h_stats_launch(20, 5000, 13, 2000, bf16, bf16)
    assert fits["table_in_smem"] == 1
    assert fits["table_bytes"] == 2000 * 16 * (2 if bf16 else 4)
    assert fits["blocks_per_sm"] >= 1
    assert fits["chunks_per_gene"] == (2 if bf16 else 4)
    big = kl_ell.h_stats_launch(2, 120, 64, 2000, bf16, bf16)
    assert big["table_in_smem"] == 0 and big["table_bytes"] == 0


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("zero_rows", [0, 3])
def test_w_numer_matches_plain(cuda_device, n, g, k, R, bf16, zero_rows):
    """The fused W numerator: gene 0 has no stored value (exact +0.0) and
    gene g-1 one in every row but the zero rows, filling the transpose
    width ``wt``; the other genes end in windows of padding that the
    kernel skips. With zero rows, H rows are packed that no slot gathers
    and whole rows of the row side are padding."""
    x, H, W = edge_inputs(n, g, k, R, 0.06, 2, cuda_device,
                          zero_rows=zero_rows, gene_edges=True)
    assert int((x.perm_t[-1] < x.vals.numel()).sum()) == x.perm_t.shape[1]
    for vals in ([x.vals, x.vals.to(torch.bfloat16)] if bf16 else [x.vals]):
        got = kl_ell.w_numer(vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)
        again = kl_ell.w_numer(vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)
        torch.cuda.synchronize()
        want = kl_ell.w_numer_plain(vals, x.cols, x.rows_t, x.perm_t, H,
                                    W, bf16)
        _close(got, want, 2e-2 if bf16 else 2e-5)
        assert torch.equal(got, again)
        assert torch.all(got[:, :, 0] == 0)
        assert not torch.signbit(got[:, :, 0]).any()


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
@pytest.mark.parametrize("case", ["zero_rows", "full_row", "tiny",
                                  "negative"])
def test_beta_err_matches_plain(cuda_device, n, g, k, R, case):
    """Each row's term against the plain version, beside three all-zero
    rows (exactly +0.0): alone, or with a row that fills a width that is
    no multiple of 4, three rows in the split-log regime (WH/X < 1e-6), or
    one stored negative value (which adds nothing). The k=20 and k=64
    shapes read W from device memory."""
    x, H, W = edge_inputs(n, g, k, R, 0.06, 3, cuda_device, zero_rows=3,
                          **({} if case == "zero_rows" else {case: True}))
    if case == "full_row":
        assert int((x.vals[-1] > 0).sum()) == x.vals.shape[1]
        assert x.vals.shape[1] % 4
    elif case == "tiny":
        stored = x.vals[3:6] > 0
        wh = kl_ell.wh_at_nz_plain(x.cols, H, W)[:, 3:6]
        assert bool(stored.any())
        assert bool((wh[:, stored] / x.vals[3:6][stored] < 1e-6).all())
    elif case == "negative":
        assert int((x.vals < 0).sum()) == 1
    rows = kl_ell.beta_err_partials(x.vals, x.cols, H, W)
    again = kl_ell.beta_err_partials(x.vals, x.cols, H, W)
    total = kl_ell.kl_beta_err(x, H, W)
    torch.cuda.synchronize()
    assert rows.shape == (R, n)
    _close(rows, kl_ell.beta_err_plain(x.vals, x.cols, H, W), 2e-5)
    _close(total, sparse.ell_beta_err(x, H, W), 2e-5)
    assert torch.equal(rows, again)
    assert torch.all(rows[:, :3] == 0)
    assert not torch.signbit(rows[:, :3]).any()


def test_beta_err_table_placement(cuda_device):
    """The f32 table sits in shared memory at the pipeline's shapes (one
    wave of persistent blocks) and is read from device memory where it
    does not fit."""
    fits = kl_ell.beta_err_launch(20, 5000, 13, 2000)
    assert fits["table_in_smem"] == 1 and fits["chunks_per_gene"] == 4
    assert fits["table_bytes"] == 2000 * 16 * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fits["grid"] == fits["blocks_per_sm"] * sms
    for args in [(2, 640, 20, 3000), (2, 120, 64, 2000)]:
        big = kl_ell.beta_err_launch(*args)
        assert big["table_in_smem"] == 0 and big["table_bytes"] == 0


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
@pytest.mark.parametrize("case", ["zero_rows", "full_row", "gene0"])
def test_h_newton_stats_matches_plain(cuda_device, n, g, k, R, case):
    """Three all-zero rows (exact +0.0 in both outputs), alone or beside a
    row that fills a width that is no multiple of 4 (its last window holds
    padding) or genes 0 and 1 stored in every other row (a stored slot at
    column 0 beside the padding). The k=20 and k=64 shapes read W from
    device memory."""
    x, H, W = edge_inputs(n, g, k, R, 0.06, 5, cuda_device, zero_rows=3,
                          **({} if case == "zero_rows" else {case: True}))
    if case == "full_row":
        assert int((x.vals[-1] > 0).sum()) == x.vals.shape[1]
    numer, hess = kl_ell.h_newton_stats(x.vals, x.cols, H, W)
    again = kl_ell.h_newton_stats(x.vals, x.cols, H, W)
    want = kl_ell.h_newton_stats_plain(x.vals, x.cols, H, W)
    torch.cuda.synchronize()
    _close(numer, want[0], 2e-5)
    _close(hess, want[1], 2e-5)
    assert torch.equal(numer, again[0]) and torch.equal(hess, again[1])
    # all-zero rows: exact +0.0 in both outputs
    for out in (numer, hess):
        assert torch.all(out[:, :3] == 0)
        assert not torch.signbit(out[:, :3]).any()


def test_h_newton_stats_where_wh_underflows(cuda_device):
    """``r2 ~ X / EPS^2`` may overflow the Hessian to inf; the kernel (no
    fast math) must put inf and finite values where the plain version
    does."""
    x, H, W = edge_inputs(200, 150, 6, 2, 0.08, 6, cuda_device)
    H[0, :20] = 1e-30
    numer, hess = kl_ell.h_newton_stats(x.vals, x.cols, H, W)
    want_n, want_h = kl_ell.h_newton_stats_plain(x.vals, x.cols, H, W)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(hess), torch.isinf(want_h))
    fin = torch.isfinite(want_h)
    _close(hess[fin], want_h[fin], 2e-5)
    _close(numer, want_n, 2e-5)


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
@pytest.mark.parametrize("case", ["gene0", "full_row"])
def test_wh_at_nz_matches_plain(cuda_device, n, g, k, R, case):
    """Every slot, padded ones included, beside three all-zero rows: with
    genes 0 and 1 stored in every other row (a width that is a multiple of
    4: four slots a lane), or with a row that fills the width (no multiple
    of 4: one slot a lane). Gene 1's W column is gene 0's, so every slot
    at column 0 (padded or stored) must hold the bits of the gathered gene
    1 slots of its row. The k=20 and k=64 shapes read W from device
    memory."""
    x, H, W = edge_inputs(n, g, k, R, 0.06, 7, cuda_device, zero_rows=3,
                          **{case: True})
    w = x.cols.shape[1]
    if case == "full_row":
        assert int((x.vals[-1] > 0).sum()) == w and w % 4
    else:
        assert w % 4 == 0 and bool(((x.cols == 0) & (x.vals > 0)).any())
    W[:, :, 1] = W[:, :, 0]
    got = kl_ell.wh_at_nz(x.cols, H, W)
    again = kl_ell.wh_at_nz(x.cols, H, W)
    want = kl_ell.wh_at_nz_plain(x.cols, H, W)
    torch.cuda.synchronize()
    _close(got, want, 2e-5)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    at = x.cols <= 1
    both = ((x.cols == 0).any(1) & (x.cols == 1).any(1)).sum()
    assert int(both) > 0
    ref = torch.where(at, got, torch.tensor(-np.inf, device=cuda_device))
    ref = ref.amax(-1, keepdim=True).expand_as(got)
    assert torch.equal(got[:, at], ref[:, at])


def test_wh_at_nz_table_placement(cuda_device):
    """The f32 table sits in shared memory at the batch path's shapes (one
    wave of persistent blocks) and is read from device memory where it
    does not fit."""
    fits = kl_ell.wh_at_nz_launch(20, 10_000, 13, 2000)
    assert fits["table_in_smem"] == 1 and fits["chunks_per_gene"] == 4
    assert fits["table_bytes"] == 2000 * 16 * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fits["grid"] == fits["blocks_per_sm"] * sms
    for args in [(2, 640, 20, 3000), (2, 120, 64, 2000)]:
        big = kl_ell.wh_at_nz_launch(*args)
        assert big["table_in_smem"] == 0 and big["table_bytes"] == 0


def test_h_newton_stats_table_placement(cuda_device):
    """The f32 table sits in shared memory at the batch path's shapes (one
    wave of persistent blocks) and is read from device memory where it
    does not fit."""
    fits = kl_ell.h_newton_stats_launch(20, 10_000, 13, 2000)
    assert fits["table_in_smem"] == 1 and fits["chunks_per_gene"] == 4
    assert fits["table_bytes"] == 2000 * 16 * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fits["grid"] == fits["blocks_per_sm"] * sms
    for args in [(2, 640, 20, 3000), (2, 120, 64, 2000)]:
        big = kl_ell.h_newton_stats_launch(*args)
        assert big["table_in_smem"] == 0 and big["table_bytes"] == 0


def test_launch_counts_and_no_fallback(cuda_device):
    x, H, W = edge_inputs(64, 50, 4, 2, 0.1, 4, cuda_device)
    kl_ell.reset_launches()
    kl_ell.kl_h_stats(x, H, W)
    kl_ell.kl_w_stats(x, H, W)
    kl_ell.kl_beta_err(x, H, W)
    kl_ell.kl_h_newton_stats(x, H, W)
    kl_ell.kl_wh_at_nz(x, H, W)
    assert kl_ell.launches == {"h_stats": 1, "w_numer": 1,
                               "beta_err_partials": 1, "h_newton_stats": 1,
                               "wh_at_nz": 1}
    # a CUDA tensor launches the kernel or raises: a wrong dtype or a
    # tensor on another device is refused, never computed on the CPU
    with pytest.raises(TypeError):
        kl_ell.h_stats(x.vals.double(), x.cols, H, W)
    with pytest.raises(ValueError):
        kl_ell.h_stats(x.vals, x.cols, H.cpu(), W)
    with pytest.raises(TypeError):
        kl_ell.h_newton_stats(x.vals.to(torch.bfloat16), x.cols, H, W)
    with pytest.raises(ValueError):
        kl_ell.wh_at_nz(x.cols, H, W.cpu())
    with pytest.raises(ValueError):
        kl_ell.w_numer(x.vals, x.cols, x.rows_t.cpu(), x.perm_t, H, W)
    assert sum(kl_ell.launches.values()) == 5


def test_batch_dna_solve_on_the_card_matches_the_cpu(cuda_device):
    """A small batch solve under the dna recipe, a fixed 40 iterations,
    on the card (kernels) and on the CPU (plain versions)."""
    from cnmf_torch_tpu_torch.ops import nmf

    x, H, W = edge_inputs(300, 200, 5, 3, 0.08, 8, cuda_device)
    errs = []
    for dev in (cuda_device, torch.device("cpu")):
        trace = []
        _, _, err = nmf.nmf_fit_batch(x.to(dev), H.to(dev), W.to(dev),
                                      beta=1.0, tol=0.0, max_iter=40,
                                      kl_newton=True, trace=trace)
        errs.append(err.cpu().numpy())
        assert ((trace[0].dna_fallback > 0)
                & (trace[0].dna_fallback < 1)).all()
    np.testing.assert_allclose(errs[0], errs[1], rtol=1e-4)


def _lowrank(n, g, k=4, R=2, seed=0, density=0.08):
    """Poisson counts of a low-rank model (dense numpy) and stacked inits:
    the card tests' input for the dense and IS solvers."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(k, g)) * 40.0 / g
    lam = usage @ spectra
    X = rng.poisson(lam * -np.log(1.0 - density) / lam.mean()).astype(
        np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    H = torch.as_tensor(rng.random((R, n, k), np.float32) + 0.1)
    W = torch.as_tensor(rng.random((R, k, g), np.float32) + 0.1)
    return X, H, W


def _solve_both(cuda_device, solve):
    """``solve(device)`` on the card and on the CPU; no CUDA kernel of
    ``kl_ell`` may launch on these plain-torch paths."""
    kl_ell.reset_launches()
    out = [solve(cuda_device), solve(torch.device("cpu"))]
    assert sum(kl_ell.launches.values()) == 0, kl_ell.launches
    return out


def test_bundled_solve_on_the_card_matches_the_cpu(cuda_device):
    """The beta=2 bundled batch solver, a fixed 60 iterations (tol 0), at
    ``rtol 1e-4``; R=7 at k=5 is no bundle multiple."""
    from cnmf_torch_tpu_torch.ops import nmf

    X, H, W = _lowrank(400, 300, k=5, R=7, density=0.3)

    def solve(dev):
        trace = []
        _, W_o, err = nmf.nmf_fit_batch_bundled(
            torch.as_tensor(X).to(dev), H.to(dev), W.to(dev), tol=0.0,
            max_iter=60, trace=trace)
        return err.cpu().numpy(), W_o.cpu().numpy()

    card, cpu = _solve_both(cuda_device, solve)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("mode", ["batch", "online"])
def test_hals_solve_on_the_card_matches_the_cpu(cuda_device, mode):
    """Batch HALS a fixed 40 sweeps (tol 0), and online HALS, at ``rtol
    1e-4`` in the objective."""
    from cnmf_torch_tpu_torch.ops import nmf

    X, H, W = _lowrank(256, 200, density=0.3)

    def solve(dev):
        x = torch.as_tensor(X).to(dev)
        if mode == "batch":
            _, _, err = nmf.nmf_fit_batch_hals(x, H.to(dev), W.to(dev),
                                               tol=0.0, max_iter=40)
        else:
            _, _, err = nmf.nmf_fit_online(
                x.reshape(2, 128, 200), H.reshape(2, 2, 128, 4).to(dev),
                W.to(dev), beta=2.0, h_tol=3e-3, chunk_max_iter=200,
                n_passes=20, algo="halsvar")
        return err.cpu().numpy()

    card, cpu = _solve_both(cuda_device, solve)
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


@pytest.mark.parametrize("ell", [False, True])
@pytest.mark.parametrize("mode", ["batch", "online"])
def test_is_solve_on_the_card_matches_the_cpu(cuda_device, ell, mode):
    """Itakura-Saito on the dense lane and on the ELL hybrid (plain torch on
    the card, no kernel launch): a batch ``amu`` solve of a fixed 40
    iterations (tol 0) at ``rtol 1e-4``, an online solve of one chunk under
    the bf16 ratio chain within 5%."""
    from cnmf_torch_tpu_torch.ops import nmf

    X, H, W = _lowrank(240, 400, density=0.05)
    x_host = (sparse.csr_to_ell(X) if ell else torch.as_tensor(X))

    def solve(dev):
        x = x_host.to(dev)
        if mode == "batch":
            _, _, err = nmf.nmf_fit_batch(x, H.to(dev), W.to(dev), beta=0.0,
                                          tol=0.0, max_iter=40,
                                          inner_repeats=3)
        else:
            x = (sparse.EllMatrix(x.vals[None], x.cols[None], x.g,
                                  x.rows_t[None], x.perm_t[None])
                 if ell else x[None])
            h_tol, n_passes, h0 = nmf.resolve_online_schedule(0.0)
            _, _, err = nmf.nmf_fit_online(
                x, H[:, None].to(dev), W.to(dev), beta=0.0, h_tol=h_tol,
                chunk_max_iter=200, n_passes=n_passes, h_tol_start=h0,
                bf16_ratio=True)
        return err.cpu().numpy()

    card, cpu = _solve_both(cuda_device, solve)
    assert np.isfinite(card).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-4 if mode == "batch"
                               else 5e-2)


@pytest.mark.parametrize("n,g,k,R", EDGE_SHAPES)
def test_sketched_w_stats_match_the_cpu(cuda_device, n, g, k, R):
    """The sketch recipe's sampled-row W statistics: the rows' own
    transpose index set built on the card (a stable sort, no atomics) and
    the ``w_numer`` kernel, against the plain version on the CPU, with
    repeated rows; two launches bit-identical."""
    x, H, W = edge_inputs(n, g, k, R, 0.06, 9, cuda_device, zero_rows=3)
    gen = torch.Generator().manual_seed(n)
    idx = torch.randint(0, n, (max(8, n // 4),), generator=gen)
    idx[:3] = idx[3]
    kl_ell.reset_launches()
    got = kl_ell.kl_w_stats_rows(x, H, W, idx)
    again = kl_ell.kl_w_stats_rows(x, H, W, idx)
    torch.cuda.synchronize()
    assert kl_ell.launches["w_numer"] == 2
    xc = x.to("cpu")
    want = sparse.ell_kl_w_stats_rows(xc, H.cpu(), W.cpu(), idx)
    _close(got[0], want[0], 2e-5)
    _close(got[1], want[1], 2e-5)
    assert torch.equal(got[0], again[0])
    sub = sparse.ell_take_rows(x, idx)
    sub_cpu = sparse.ell_take_rows(xc, idx)
    assert torch.equal(sub.perm_t.cpu(), sub_cpu.perm_t)
    assert torch.equal(sub.rows_t.cpu(), sub_cpu.rows_t)


def test_sketched_solves_on_the_card_are_bit_identical(cuda_device):
    """Two sketched batch solves and two sketched online solves on the card
    from the same draws end bit for bit alike; the batch objective is
    within ``rtol 1e-4`` of the same solve on the CPU, the online one
    within ``rtol 1e-3`` (its usage solves stop on a relative-change
    tolerance, so a last-bit difference can move a stop)."""
    from cnmf_torch_tpu_torch.ops import nmf

    x, H, W = edge_inputs(600, 300, 6, 3, 0.06, 10, cuda_device)
    X, Ho, Wo = _lowrank(240, 400, k=4, R=3, density=0.06)
    xo, _ = sparse.ell_chunk_rows(X, 120)
    h_tol, _, h0 = nmf.resolve_online_schedule(1.0)
    out = {}
    for dev in (cuda_device, cuda_device, torch.device("cpu")):
        _, W_o, err = nmf.nmf_fit_batch(
            x.to(dev), H.to(dev), W.to(dev), beta=1.0, tol=0.0, max_iter=40,
            sketch_dim=128, sketch_exact_every=4)
        _, Wo_o, err_o = nmf.nmf_fit_online(
            xo.to(dev), Ho.reshape(3, 2, 120, 4).to(dev), Wo.to(dev),
            beta=1.0, tol=-1.0, h_tol=h_tol, chunk_max_iter=50, n_passes=7,
            h_tol_start=h0, sketch_dim=40, sketch_exact_every=3)
        out.setdefault(dev.type, []).append(
            (W_o.cpu(), err.cpu(), Wo_o.cpu(), err_o.cpu()))
    (b_w, b_err, o_w, o_err), again, cpu = (*out["cuda"], out["cpu"][0])
    assert torch.equal(b_w, again[0]) and torch.equal(o_w, again[2])
    assert torch.equal(o_err, again[3])
    np.testing.assert_allclose(b_err.numpy(), cpu[1].numpy(), rtol=1e-4)
    np.testing.assert_allclose(o_err.numpy(), cpu[3].numpy(), rtol=1e-3)


@pytest.mark.parametrize("beta", [2.0, 1.0])
def test_double_solve_on_the_card_matches_the_cpu(cuda_device, beta):
    """``fp_precision="double"``'s solver on the card: f64 throughout, the
    same solve as on the CPU at ``rtol 1e-9`` (no CUDA kernel of ours: the
    f64 solve is dense)."""
    from cnmf_torch_tpu_torch.ops import nmf

    X, H, W = _lowrank(300, 200, k=5, R=1, density=0.3)

    def solve(dev):
        _, W_o, err = nmf.nmf_fit_batch(
            torch.as_tensor(X).double().to(dev), H.double().to(dev),
            W.double().to(dev), beta=beta, tol=0.0, max_iter=50)
        assert W_o.dtype == torch.float64
        return err.cpu().numpy(), W_o.cpu().numpy()

    card, cpu = _solve_both(cuda_device, solve)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-9)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-7, atol=1e-12)


# ---------------------------------------------------------------------------
# the telemetry base on the card
# ---------------------------------------------------------------------------

def test_memory_events_read_the_card(cuda_device, tmp_path, monkeypatch):
    """``memory`` events and the manifest describe the card: the caching
    allocator's current and peak bytes, the card's total memory and its
    name."""
    from cnmf_torch_tpu_torch.utils import telemetry

    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    torch.cuda.reset_peak_memory_stats()
    buf = torch.ones(1 << 20, device=cuda_device)
    log = telemetry.EventLog(str(tmp_path / "e.jsonl"), device=cuda_device)
    log.emit_memory("x")
    man, mem = telemetry.read_events(str(tmp_path / "e.jsonl"))
    assert man["backend"] == "cuda"
    assert man["devices"][0]["kind"] == torch.cuda.get_device_name(0)
    (ent,) = [d for d in mem["devices"] if d["id"] == 0]
    assert ent["peak_bytes_in_use"] >= buf.numel() * 4
    assert ent["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    assert telemetry.device_memory_peak_bytes(cuda_device) >= (
        buf.numel() * 4)


def test_stage_trace_names_the_kernel(cuda_device, tmp_path, monkeypatch):
    """A stage traced under ``CNMF_TPU_PROFILE_DIR`` writes a Chrome trace
    in which the kernel it launched appears by name."""
    import json
    import os

    from cnmf_torch_tpu_torch.utils.profiling import trace

    x, H, W = edge_inputs(400, 300, 9, 4, 0.06, 3, cuda_device)
    kl_ell.h_stats(x.vals, x.cols, H, W, False)
    torch.cuda.synchronize()
    monkeypatch.setenv("CNMF_TPU_PROFILE_DIR", str(tmp_path))
    with trace("stage"):
        kl_ell.h_stats(x.vals, x.cols, H, W, False)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path / "stage")
    with open(tmp_path / "stage" / name) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any("h_stats_kernel" in n for n in names)


def test_prepare_sums_are_the_same_on_every_run(cuda_device):
    """prepare's sparse row totals and column moments (ordered segment
    sums, no atomics) give the same bits on every run on the card, within
    1e-13 of the CPU's."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch.ops import stats

    rng = np.random.default_rng(12)
    X = sp.random(20_000, 2_000, density=0.06, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(1.0, 3.0, s))
    runs = []
    for device in (cuda_device, cuda_device, "cpu"):
        totals = stats.row_sums(X, device=device)
        (m, v), (sm, sv) = stats.column_moments_staged(
            X, row_scale=1e6 / totals, device=device)
        runs.append(np.concatenate([totals, m, v, sm, sv]))
    assert np.array_equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0], runs[2], rtol=1e-13, atol=0)


# ---------------------------------------------------------------------------
# the atlas path: the row kernels at R=1 and the row-sharded solver
# ---------------------------------------------------------------------------

def _atlas_ell(n, g, density, seed, device):
    """An ELL encoding of ``n`` rows with the transpose index set, at the
    row-sharded solver's shapes (R=1, one encoding for the whole matrix)."""
    import scipy.sparse as sp

    X = sp.random(n, g, density=density, format="csr", random_state=seed,
                  dtype=np.float32)
    X.data = np.random.default_rng(seed).gamma(1.0, 1.0, X.nnz).astype(
        np.float32) + 0.1
    return X, sparse.csr_to_ell(X).to(device)


@pytest.mark.parametrize("n,k", [(100_000, 9), (120_000, 13)])
def test_the_three_path_kernels_at_r1_match_plain(cuda_device, n, k):
    """``h_stats``, ``w_numer`` and ``beta_err_partials`` at R=1 on
    100,000+ rows (the row-sharded solver launches them on the whole
    shard): ``rtol 2e-5``, two launches bit-identical."""
    _, x = _atlas_ell(n, 2000, 0.06, 21, cuda_device)
    gen = torch.Generator().manual_seed(5)
    H = (torch.rand((1, n, k), generator=gen) + 0.1).to(cuda_device)
    W = (torch.rand((1, k, 2000), generator=gen) + 0.1).to(cuda_device)
    got = kl_ell.h_stats(x.vals, x.cols, H, W)
    assert torch.equal(got, kl_ell.h_stats(x.vals, x.cols, H, W))
    _close(got, kl_ell.h_stats_plain(x.vals, x.cols, H, W), 2e-5)
    got = kl_ell.w_numer(x.vals, x.cols, x.rows_t, x.perm_t, H, W)
    assert torch.equal(got, kl_ell.w_numer(x.vals, x.cols, x.rows_t,
                                           x.perm_t, H, W))
    _close(got, kl_ell.w_numer_plain(x.vals, x.cols, x.rows_t, x.perm_t, H,
                                     W), 2e-5)
    got = kl_ell.beta_err_partials(x.vals, x.cols, H, W)
    assert torch.equal(got, kl_ell.beta_err_partials(x.vals, x.cols, H, W))
    _close(got, kl_ell.beta_err_plain(x.vals, x.cols, H, W), 2e-5)


def test_a_row_sharded_ell_solve_on_the_card_matches_the_cpu(cuda_device):
    """One replicate of ``nmf_fit_rowsharded`` on the ELL lane, from the
    same init on the card (the kernels) and on the CPU (the plain
    versions): objective and W within ``rtol 1e-4`` after 8 passes."""
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    X, _ = _atlas_ell(20_000, 400, 0.05, 22, "cpu")
    init = tuple(t.numpy() for t in random_init(
        3, 20_000, 400, 6, float(X.sum()) / (20_000 * 400)))
    kl_ell.reset_launches()
    out = [nmf_fit_rowsharded(X, 6, beta_loss="kullback-leibler",
                              n_passes=8, init_factors=init, device=dev)
           for dev in (cuda_device, "cpu")]
    assert all(kl_ell.launches[name] > 0 for name in
               ("h_stats", "w_numer", "beta_err_partials"))
    (_, W_card, e_card), (_, W_cpu, e_cpu) = out
    assert abs(e_card - e_cpu) / e_cpu < 1e-4
    assert (np.abs(W_card - W_cpu).max() / np.abs(W_cpu).max()) < 1e-4


def test_the_dense_pass_in_row_blocks_on_the_card_matches_the_cpu(
        cuda_device, monkeypatch):
    """The dense row-sharded KL pass in row blocks (2,000 rows a block,
    10 blocks) on the card against the same solve on the CPU in one block:
    objective and W within ``rtol 1e-4`` after 6 passes."""
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel import rowshard

    X, _ = _atlas_ell(20_000, 400, 0.05, 24, "cpu")
    X = X.toarray()
    init = tuple(t.numpy() for t in random_init(
        4, 20_000, 400, 6, float(X.sum()) / (20_000 * 400)))
    kw = dict(beta_loss="kullback-leibler", n_passes=6, init_factors=init)
    _, W_cpu, e_cpu = rowshard.nmf_fit_rowsharded(X, 6, device="cpu", **kw)
    monkeypatch.setattr(rowshard, "DENSE_BLOCK_ELEMS", 2_000 * 400)
    _, W_card, e_card = rowshard.nmf_fit_rowsharded(X, 6, device=cuda_device,
                                                    **kw)
    assert abs(e_card - e_cpu) / e_cpu < 1e-4
    assert (np.abs(W_card - W_cpu).max() / np.abs(W_cpu).max()) < 1e-4


def test_a_store_staged_on_the_card_is_the_matrix(cuda_device, tmp_path):
    """Store slabs cross through pinned buffers on a side stream and
    densify with ``index_put_``: the staged tensor is the matrix, bit for
    bit, on every run."""
    from cnmf_torch_tpu_torch.parallel.rowshard import stream_rows_to_mesh
    from cnmf_torch_tpu_torch.utils import shardstore

    X, _ = _atlas_ell(30_000, 500, 0.05, 23, "cpu")
    shardstore.write_shard_store(tmp_path / "st", X, slab_rows=7_000)
    store = shardstore.open_shard_store(tmp_path / "st")
    a, _ = stream_rows_to_mesh(store, cuda_device)
    b, _ = stream_rows_to_mesh(X, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert np.array_equal(a.cpu().numpy(), X.toarray())


# ---------------------------------------------------------------------------
# the remote object store and the cost model on the card
# ---------------------------------------------------------------------------

def test_a_remote_store_staged_on_the_card_is_the_local_one(
        cuda_device, tmp_path, monkeypatch):
    """A store read over HTTP from the fixture server stages on the card to
    the same bits as the same store on local disk, dense and as the ELL
    encoding."""
    from cnmf_torch_tpu_torch.parallel.rowshard import (stream_ell_to_mesh,
                                                        stream_rows_to_mesh)
    from cnmf_torch_tpu_torch.utils import shardstore
    from cnmf_torch_tpu_torch.utils.netstore import ObjectStoreServer

    X, _ = _atlas_ell(30_000, 500, 0.05, 29, "cpu")
    monkeypatch.delenv("CNMF_TPU_STORE_URI", raising=False)
    shardstore.write_shard_store(tmp_path / "local", X, slab_rows=7_000)
    local = shardstore.open_shard_store(tmp_path / "local")
    with ObjectStoreServer() as srv:
        monkeypatch.setenv("CNMF_TPU_STORE_URI", srv.url + "/card")
        shardstore.write_shard_store(tmp_path / "remote", X, slab_rows=7_000)
        remote = shardstore.open_shard_store(tmp_path / "remote")
        assert remote.backend.kind == "remote"
        a, _ = stream_rows_to_mesh(remote, cuda_device)
        ea, _ = stream_ell_to_mesh(remote, cuda_device)
    b, _ = stream_rows_to_mesh(local, cuda_device)
    eb, _ = stream_ell_to_mesh(local, cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    for leaf in ("vals", "cols", "rows_t", "perm_t"):
        assert torch.equal(getattr(ea, leaf), getattr(eb, leaf))


def test_a_perf_model_event_on_the_kernels_lane(cuda_device, tmp_path,
                                                monkeypatch):
    """A KL factorize on the card under the telemetry and
    ``CNMF_TPU_PERF_MODEL``: one ``perf_model`` event on ``ell-cuda``
    with the card's data-sheet peaks, not exempt, its fractions in
    (0, 1.05]."""
    import os

    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
    from cnmf_torch_tpu_torch.obs import costmodel
    from cnmf_torch_tpu_torch.utils import telemetry

    monkeypatch.setenv("CNMF_TPU_TELEMETRY", "1")
    monkeypatch.setenv("CNMF_TPU_PERF_MODEL", "1")
    rng = np.random.default_rng(3)
    usage = rng.dirichlet(np.ones(5) * 0.2, size=3000)
    spectra = rng.gamma(0.25, 1.0, size=(5, 1500)) * 40.0 / 1500
    counts = rng.poisson(usage @ spectra * 6.0).astype(np.float64)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(counts, np.asarray([f"c{i}" for i in range(3000)]),
                         np.asarray([f"g{j}" for j in range(1500)])), fn)
    obj = cNMF(str(tmp_path), "pm", device=cuda_device)
    obj.prepare(fn, components=[5, 7], n_iter=4, seed=2,
                num_highvar_genes=800, beta_loss="kullback-leibler",
                batch_size=1000)
    obj.factorize()
    assert obj.factorize_info["kernel"] == "ell-cuda"
    events_fn = os.path.join(str(tmp_path), "pm", "cnmf_tmp",
                             "pm.events.jsonl")
    telemetry.validate_events_file(events_fn)
    (pm,) = [e for e in telemetry.read_events(events_fn)
             if e["t"] == "perf_model"]
    roof = pm["roofline"]
    assert (pm["stage"], pm["lane"]) == ("factorize", "ell-cuda")
    assert roof["peak_source"] == "datasheet" and not roof["perf_exempt"]
    assert costmodel.device_peaks(cuda_device)["source"] == "datasheet"
    assert 0 < roof["mfu"] <= 1.05 and 0 < roof["bw_frac"] <= 1.05


def test_a_two_shard_mesh_on_the_card_matches_the_cpu_mesh(cuda_device):
    """The row-sharded ELL solve over a 2-shard cells mesh on the card (the
    kernels launched on every shard: ``w_numer`` and ``beta_err_partials``
    once a shard and pass) against the same 2-shard mesh of CPU entries
    (the plain versions): objective and W within ``rtol 1e-4`` after 8
    passes."""
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    X, _ = _atlas_ell(20_000, 400, 0.05, 23, "cpu")
    init = tuple(t.numpy() for t in random_init(
        4, 20_000, 400, 6, float(X.sum()) / (20_000 * 400)))
    kl_ell.reset_launches()
    payloads = []
    card = nmf_fit_rowsharded(X, 6, beta_loss="kullback-leibler", n_passes=8,
                              init_factors=init,
                              mesh=Mesh([cuda_device] * 2, ("cells",)),
                              telemetry_sink=payloads.append)
    passes = int(payloads[0]["iters"][0])
    assert kl_ell.launches["w_numer"] == 2 * passes
    assert kl_ell.launches["beta_err_partials"] == 2 * passes
    assert kl_ell.launches["h_stats"] >= 2 * passes
    cpu = nmf_fit_rowsharded(X, 6, beta_loss="kullback-leibler", n_passes=8,
                             init_factors=init,
                             mesh=Mesh(["cpu"] * 2, ("cells",)))
    assert abs(card[2] - cpu[2]) / cpu[2] < 1e-4
    assert (np.abs(card[1] - cpu[1]).max() / np.abs(cpu[1]).max()) < 1e-4


def test_a_shard_on_the_second_card_stays_there(cuda_device):
    """The kernel binding launches on the tensors' card, whatever card is
    current: a shard on ``cuda:1`` with ``cuda:0`` current gives the plain
    version's result on ``cuda:1``. Needs two cards; skips on one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (a launch on cuda:1 with cuda:0 "
                    "current)")
    x, H, W = edge_inputs(300, 200, 9, 1, 0.06, 1, "cpu")
    second = torch.device("cuda", 1)
    xs = x.to(second)
    with torch.cuda.device(0):
        got = kl_ell.h_stats(xs.vals, xs.cols, H.to(second), W.to(second))
        numer = kl_ell.w_numer(xs.vals, xs.cols, xs.rows_t, xs.perm_t,
                               H.to(second), W.to(second))
        torch.cuda.synchronize(second)
    assert got.device == second and numer.device == second
    _close(got, kl_ell.h_stats_plain(x.vals, x.cols, H, W), 2e-5)
    _close(numer, kl_ell.w_numer_plain(x.vals, x.cols, x.rows_t, x.perm_t,
                                       H, W), 2e-5)


def _serve_reference(beta, k=9, g=2000, seed=0):
    from cnmf_torch_tpu_torch.serving import ResidentReference

    rng = np.random.default_rng(seed)
    W = rng.gamma(0.3, 1.0, size=(k, g)).astype(np.float32)
    return ResidentReference(W, beta=beta, chunk_size=5000,
                             chunk_max_iter=1000, h_tol=0.05)


def _serve_query(ref, n, seed):
    rng = np.random.default_rng(seed)
    u = rng.dirichlet(np.ones(ref.k) * 0.3, size=n)
    X = rng.poisson(u @ ref.W * 2.0).astype(np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    return X


@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_served_requests_on_the_card_match_solo(cuda_device, beta):
    """Concurrent requests of 33 to 7,500 rows (two lanes) served from the
    card, each within ``rtol 1e-5`` of the port's solo ``fit_h`` on the
    card from the same default init; the serve path launches no CUDA
    kernel of ours."""
    import threading

    from cnmf_torch_tpu_torch.ops.nmf import fit_h
    from cnmf_torch_tpu_torch.serving import ProjectionService

    ref = _serve_reference(beta)
    sizes = (33, 256, 1000, 5000, 7500, 100)
    queries = [_serve_query(ref, n, i) for i, n in enumerate(sizes)]
    kl_ell.reset_launches()
    results = [None] * len(queries)
    with ProjectionService(ref, device="cuda", max_batch=8, linger_ms=50.0,
                           warm_start=False) as svc:
        assert ref.Wd.is_cuda and ref.h_tol_dev.is_cuda

        def go(i):
            results[i] = svc.project(queries[i], tenant=f"t{i}")

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = svc.stats()
    assert sum(kl_ell.launches.values()) == 0
    assert stats["ok"] == len(queries)
    assert stats["cold_dispatches_after_warmup"] == 0
    identical = 0
    for X, (H, meta) in zip(queries, results):
        want = fit_h(X, ref.W, chunk_size=5000, chunk_max_iter=1000,
                     h_tol=0.05, beta=beta, device="cuda")
        np.testing.assert_allclose(H, want, rtol=1e-5, atol=1e-6)
        identical += int(np.array_equal(H, want))
    print(f"beta={beta}: {identical}/{len(queries)} replies bit-identical "
          f"to solo fit_h on the card")


@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_the_batched_program_on_the_card_matches_the_cpu(cuda_device, beta):
    from cnmf_torch_tpu_torch.serving.batcher import batched_project

    ref_c = _serve_reference(beta, g=800).stage("cuda")
    ref_h = _serve_reference(beta, g=800).stage("cpu")
    rng = np.random.default_rng(3)
    Xb = np.zeros((4, 256, 800), np.float32)
    Hb = np.zeros((4, 256, 9), np.float32)
    for i, m in enumerate((256, 100, 33, 0)):
        if m:
            Xb[i, :m] = _serve_query(ref_h, m, 10 + i)
            Hb[i, :m] = rng.random((m, 9), dtype=np.float32)
    outs = []
    for ref in (ref_c, ref_h):
        dev = ref.device
        H, rel = batched_project(
            torch.from_numpy(Xb).to(dev), torch.from_numpy(Hb).to(dev),
            ref.Wd, ref.WWT, ref.w_colsum, ref.h_tol_dev, beta=beta,
            max_iter=1000, l1=0.0, l2=0.0)
        outs.append((H.cpu().numpy(), rel.cpu().numpy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-6)
    assert not outs[0][0][1, 100:].any() and not outs[0][0][3].any()
    assert (outs[0][1][:3] < 0.05).all() and outs[0][1][3] == 0.0


# ---------------------------------------------------------------------------
# the autotuner and the execution planner on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def private_autotune(tmp_path, monkeypatch):
    """A private autotune cache, the dispatch knobs cleared, and the whole
    environment restored afterwards (a replay pins knobs)."""
    import os

    from cnmf_torch_tpu_torch.runtime.planner import DISPATCH_KNOBS
    from cnmf_torch_tpu_torch.utils import autotune

    env0 = dict(os.environ)
    for knob in DISPATCH_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    prev = autotune.set_cache_dir(str(tmp_path / "autotune"))
    monkeypatch.setattr(autotune, "_active_device", None)
    yield autotune
    autotune.set_cache_dir(prev)
    os.environ.clear()
    os.environ.update(env0)


def test_autotune_on_the_card_launches_the_path_kernels(cuda_device,
                                                        private_autotune,
                                                        monkeypatch):
    """``CNMF_TPU_AUTOTUNE=1`` measures on the card: the ELL lane of the
    microbench launches ``h_stats`` and ``w_numer``; the cache's
    fingerprint names the card; every scale and plan point is finite."""
    import json
    import math

    autotune = private_autotune
    monkeypatch.setenv("CNMF_TPU_AUTOTUNE", "1")
    kl_ell.reset_launches()
    rho = autotune.maybe_autotune_rho(beta=1.0, device="cuda")
    plan = autotune.maybe_autotune_plan(device="cuda")
    assert kl_ell.launches["h_stats"] > 0 and kl_ell.launches["w_numer"] > 0
    name = torch.cuda.get_device_name(0).replace(" ", "_")
    path = autotune.cache_path(device="cuda")
    assert name in path
    with open(path) as f:
        payload = json.load(f)
    assert payload["fingerprint"] == autotune.device_fingerprint("cuda")
    assert f"-cuda-{name}-x{torch.cuda.device_count()}" in \
        payload["fingerprint"]
    assert set(payload["scales"]) == {"b2", "dense", "ell"}
    assert set(payload["plan_points"]) == {
        "ell_density_crossover", "grid_blocks", "stream_threads",
        "sketch_dim"}
    for v in list(payload["scales"].values()) + list(
            payload["plan_points"].values()):
        assert math.isfinite(v) and v > 0
    assert rho["scales"] == payload["scales"]
    assert plan["plan_points"] == payload["plan_points"]
    print(f"autotune on {torch.cuda.get_device_name(0)}: {payload}")


def _replay_counts(n=2000, g=3000, seed=14):
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(6) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(6, g)) * 40.0 / g
    X = rng.poisson(usage @ spectra * 25.0).astype(np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    return X


def test_a_plan_replay_on_the_card_is_byte_identical(cuda_device,
                                                     private_autotune,
                                                     tmp_path):
    """An autotuned online KL factorize on the card, its plan dumped with
    ``plan --out``, then ``factorize --plan`` into a fresh run: one plan
    event each, the same signature, the ``ell-cuda`` kernel, the iter
    spectra and the consensus usages byte for byte, and the tuned groups'
    sources ``pin`` after the replay."""
    import os

    from cnmf_torch_tpu_torch import Frame, save_df_to_npz
    from cnmf_torch_tpu_torch.cli import main
    from cnmf_torch_tpu_torch.utils.telemetry import read_events

    autotune = private_autotune
    os.environ["CNMF_TPU_AUTOTUNE"] = "1"
    autotune.maybe_autotune_plan(device="cuda")
    os.environ["CNMF_TPU_AUTOTUNE"] = "auto"
    os.environ["CNMF_TPU_TELEMETRY"] = "1"
    X = _replay_counts()
    fn = str(tmp_path / "counts.df.npz")
    save_df_to_npz(Frame(X, np.asarray([f"c{i}" for i in range(len(X))]),
                         np.asarray([f"g{j}" for j in range(X.shape[1])])),
                   fn)
    out = str(tmp_path / "out")
    plan_fn = str(tmp_path / "p.json")

    def run(name, *extra):
        common = ["--output-dir", out, "--name", name, "--device", "cuda"]
        main(["prepare", "-c", fn, "-k", "5", "7", "-n", "6", "--seed", "3",
              "--numgenes", "1000", "--beta-loss", "kullback-leibler",
              "--batch_size", "1000"] + common)
        env0 = dict(os.environ)
        main(["factorize"] + common + list(extra))
        os.environ.clear()
        os.environ.update(env0)
        main(["combine"] + common)
        main(["consensus", "-k", "5", "--local-density-threshold", "2.0",
              "--no-build-reference"] + common)

    run("a")
    main(["plan", os.path.join(out, "a"), "--out", plan_fn])
    run("b", "--plan", plan_fn)
    plans = {}
    for name in ("a", "b"):
        evs = [e for e in read_events(os.path.join(
            out, name, "cnmf_tmp", f"{name}.events.jsonl"))
            if e["t"] == "plan"]
        assert len(evs) == 1
        plans[name] = evs[0]
    assert plans["a"]["signature"] == plans["b"]["signature"]
    assert plans["a"]["plan"]["kernel"] == "ell-cuda"
    assert plans["a"]["plan"]["sources"]["encoding"] == "autotuned"
    assert plans["a"]["plan"]["sources"]["streaming"] == "autotuned"
    assert plans["b"]["plan"]["sources"]["encoding"] == "pin"
    assert plans["b"]["plan"]["sources"]["streaming"] == "pin"

    def files(name, pattern):
        d = os.path.join(out, name, "cnmf_tmp")
        got = {}
        for f in sorted(os.listdir(d)):
            if pattern in f:
                with open(os.path.join(d, f), "rb") as fh:
                    got[f[len(name):]] = fh.read()
        return got

    assert len(files("a", ".iter_")) == 12
    assert files("a", ".iter_") == files("b", ".iter_")
    assert files("a", ".usages.") == files("b", ".usages.")


def _donor_counts(n=300, g=400, seed=17):
    """Low-rank Poisson counts of three donors with a multiplicative donor
    effect per gene, as CSR with the donor column in ``obs``."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch.utils.io import Counts

    rng = np.random.default_rng(seed)
    batch = np.arange(n) % 3
    usage = rng.dirichlet(np.ones(4) * 0.4, size=n)
    spectra = rng.gamma(0.4, 1.0, size=(4, g)) * 40.0 / g
    effect = rng.lognormal(0.0, 0.5, size=(3, g))
    X = rng.poisson(usage @ spectra * 400.0 * effect[batch]).astype(float)
    X[X.sum(axis=1) == 0, 0] = 1.0
    return Counts(sp.csr_matrix(X), np.asarray([f"c{i}" for i in range(n)]),
                  np.asarray([f"g{j}" for j in range(g)]),
                  obs={"batch": np.asarray([f"d{b}" for b in batch],
                                           dtype=object)})


def test_preprocess_on_the_card_matches_the_cpu(cuda_device):
    """``filter_adata`` and ``preprocess_for_cnmf`` with Harmony on the
    card against the CPU from the same seed: the same cells, genes and
    HVGs, the TP10K at rtol 1e-6, the corrected matrix within 1e-3 of its
    largest value (f32 soft k-means over 5 iterations in another
    summation order) and non-negative."""
    from cnmf_torch_tpu_torch import Preprocess

    out = {}
    for dev in ("cuda", "cpu"):
        pp = Preprocess(0, device=dev)
        filt = pp.filter_adata(_donor_counts(), min_cells_per_gene=5,
                               min_counts_per_cell=50)
        out[dev] = (filt,) + pp.preprocess_for_cnmf(
            filt, harmony_vars="batch", n_top_rna_genes=100,
            max_iter_harmony=5)
    (fc, rc, tc, hc), (fp, rp, tp, hp) = out["cuda"], out["cpu"]
    assert list(fc.var_names) == list(fp.var_names) and hc == hp
    np.testing.assert_allclose(tc.X.toarray(), tp.X.toarray(), rtol=1e-6)
    assert (rc.X >= 0).all() and rc.X.shape == (fc.shape[0], 100)
    np.testing.assert_allclose(rc.X, rp.X, rtol=0,
                               atol=1e-3 * np.abs(rp.X).max())


def test_mutual_info_on_the_card_matches_plain(cuda_device):
    """The sorted-window neighbour search on the card against the plain
    brute-force version: the same counts, MI within 1e-10 (digamma on
    the card)."""
    from cnmf_torch_tpu_torch.ops.mutual_info import (
        mutual_info_classif, mutual_info_classif_plain)

    rng = np.random.default_rng(18)
    cluster = rng.integers(0, 4, size=400)
    X = rng.poisson(5.0, size=(400, 60)).astype(float)
    for c in range(4):
        X[np.ix_(cluster == c, range(6))] += 8 * c
    got = mutual_info_classif(X, cluster, 3, 0, device="cuda")
    np.testing.assert_allclose(got, mutual_info_classif_plain(X, cluster, 3,
                                                              0),
                               rtol=0, atol=1e-10)


def test_run_harmony_is_repeatable_on_the_card(cuda_device):
    """Two card runs from one seed give the same bits, and the CPU run
    the same iterations with the embedding within 1e-3."""
    from cnmf_torch_tpu_torch.ops import run_harmony

    rng = np.random.default_rng(19)
    batch = np.arange(600) % 3
    Z = rng.normal(size=(600, 20)).astype(np.float32)
    Z[batch == 1, 1] += 4.0
    Z[batch == 2, 2] += 3.0
    meta = {"batch": batch}
    runs = [run_harmony(Z, meta, "batch", theta=2.0, max_iter_harmony=10,
                        random_state=1, device=dev)
            for dev in ("cuda", "cuda", "cpu")]
    np.testing.assert_array_equal(runs[0].Z_corr, runs[1].Z_corr)
    np.testing.assert_array_equal(runs[0].R, runs[1].R)
    assert len(runs[0].objective_harmony) == len(runs[2].objective_harmony)
    np.testing.assert_allclose(runs[0].Z_corr, runs[2].Z_corr, rtol=0,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the sanitizer: the solver paths under sync_guard (the counterparts of
# tests/test_sanitize.py and test_serving.py::
# test_serve_program_no_implicit_transfers)
# ---------------------------------------------------------------------------

def _stage(a, device):
    """Host data onto the card as a chosen transfer (the guarded tests'
    ``jax.device_put``)."""
    from cnmf_torch_tpu_torch.utils.sanitize import host_read

    with host_read():
        if isinstance(a, sparse.EllMatrix):
            return a.to(device)
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _fetch(*tensors):
    """Results to the host as a chosen read (``jax.device_get``)."""
    from cnmf_torch_tpu_torch.utils.sanitize import host_read

    with host_read():
        return [t.cpu().numpy() for t in tensors]


def _guard_inputs(n=600, g=300, k=5, R=3, seed=30, density=0.08):
    X, H, W = _lowrank(n, g, k=k, R=R, seed=seed, density=density)
    return X, H.numpy(), W.numpy()


def test_sync_guard_raises_on_an_implicit_sync(cuda_device):
    """The negative control: a bare ``.item()`` under the guard raises, the
    same read inside ``host_read()`` passes and is counted, and the mode
    is restored on exit, after an exception too."""
    from cnmf_torch_tpu_torch.utils.sanitize import host_read, sync_guard

    x = torch.ones(4, device=cuda_device)
    prev = torch.cuda.get_sync_debug_mode()
    with sync_guard(cuda_device) as guard:
        assert guard.active
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.sum().item()
        with host_read():
            assert x.sum().item() == 4.0
        assert torch.cuda.get_sync_debug_mode() == 2
    assert guard.reads == 1
    assert torch.cuda.get_sync_debug_mode() == prev
    with pytest.raises(ValueError):
        with sync_guard(cuda_device):
            raise ValueError("inside the guard")
    assert torch.cuda.get_sync_debug_mode() == prev


@pytest.mark.parametrize("recipe", ["beta2", "dna"])
def test_nmf_fit_batch_no_implicit_syncs(cuda_device, recipe):
    """The batch solver under ``sync_guard``: beta=2 on a dense matrix,
    and the dna recipe on the ELL lane (``h_newton_stats`` and
    ``wh_at_nz``); the solver's own reads are the objective evaluations'
    lane mask and the telemetry copy."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.utils.sanitize import sync_guard

    X, H0, W0 = _guard_inputs()
    Xd = _stage(sparse.csr_to_ell(X) if recipe == "dna" else X, cuda_device)
    Hd, Wd = _stage(H0, cuda_device), _stage(W0, cuda_device)
    kw = (dict(beta=1.0, kl_newton=True) if recipe == "dna"
          else dict(beta=2.0))
    kl_ell.reset_launches()
    trace = []
    with sync_guard(cuda_device) as guard:
        H, W, err = nmf.nmf_fit_batch(Xd, Hd, Wd, tol=1e-4, max_iter=40,
                                      trace=trace, **kw)
        out = _fetch(H, W, err)
    assert all(np.isfinite(o).all() for o in out)
    assert guard.reads >= 2 and len(trace) == 1
    if recipe == "dna":
        assert kl_ell.launches["h_newton_stats"] > 0
        assert kl_ell.launches["wh_at_nz"] > 0


def test_nmf_fit_online_kl_ell_no_implicit_syncs(cuda_device):
    """Online KL on the ELL lane under the bf16 chain, 4 passes in two
    chunks, under ``sync_guard``: ``h_stats``, ``w_numer`` and
    ``beta_err_partials`` launch, and the reads a pass are the lane masks
    and the pass's trace."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.utils.sanitize import sync_guard

    X, H0, W0 = _guard_inputs(n=640)
    xc, _ = sparse.ell_chunk_rows(X, 320)
    xcd = _stage(xc, cuda_device)
    Hc = _stage(H0.reshape(3, 2, 320, 5), cuda_device)
    Wd = _stage(W0, cuda_device)
    kl_ell.reset_launches()
    trace = []
    with sync_guard(cuda_device) as guard:
        Hc, W, err = nmf.nmf_fit_online(xcd, Hc, Wd, beta=1.0, tol=0.0,
                                        h_tol=1e-2, h_tol_start=0.1,
                                        chunk_max_iter=200, n_passes=4,
                                        bf16_ratio=True, trace=trace)
        out = _fetch(Hc, W, err)
    assert all(np.isfinite(o).all() for o in out)
    assert len(trace) == 4 and guard.reads >= 2 * len(trace)
    for name in ("h_stats", "w_numer", "beta_err_partials"):
        assert kl_ell.launches[name] > 0, name


@pytest.mark.parametrize("lane,beta", [("dense", 1.0), ("dense", 0.0),
                                       ("ell", 0.0)])
def test_nmf_fit_online_bf16_lanes_no_implicit_syncs(cuda_device, lane,
                                                     beta):
    """The bf16 ratio chain's other lanes under ``sync_guard``: dense KL
    and IS, and the IS hybrid on the ELL lane, whose floors (``EPS`` on
    the card) are fills, not scalars copied from the host each step."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.utils.sanitize import sync_guard

    X, H0, W0 = _guard_inputs(n=640)
    Xc = (sparse.ell_chunk_rows(X, 320)[0] if lane == "ell"
          else X.reshape(2, 320, X.shape[1]))
    xcd = _stage(Xc, cuda_device)
    Hc = _stage(H0.reshape(3, 2, 320, 5), cuda_device)
    Wd = _stage(W0, cuda_device)
    with sync_guard(cuda_device):
        Hc, W, err = nmf.nmf_fit_online(xcd, Hc, Wd, beta=beta, tol=0.0,
                                        h_tol=1e-2, chunk_max_iter=100,
                                        n_passes=3, bf16_ratio=True)
        out = _fetch(Hc, W, err)
    assert all(np.isfinite(o).all() for o in out)


def test_rowsharded_pass_no_implicit_syncs(cuda_device):
    """One block-coordinate pass of the row-sharded solver on one shard,
    the ELL lane (KL), under ``sync_guard``."""
    from cnmf_torch_tpu_torch.parallel.rowshard import _rowsharded_pass
    from cnmf_torch_tpu_torch.utils.sanitize import sync_guard

    X, H0, W0 = _guard_inputs(R=1)
    x = _stage(sparse.csr_to_ell(X), cuda_device)
    H, W = _stage(H0, cuda_device), _stage(W0, cuda_device)
    kl_ell.reset_launches()
    with sync_guard(cuda_device):
        Hs, W, err, A, B = _rowsharded_pass([x], [H], W, 1.0, 0.05, 50,
                                            0.0, 0.0, 0.0, 0.0)
        out = _fetch(Hs[0], W, err)
    assert A is None and B is None
    assert all(np.isfinite(o).all() for o in out)
    assert out[0].shape == (1, 600, 5) and out[1].shape == (1, 5, 300)
    for name in ("h_stats", "w_numer", "beta_err_partials"):
        assert kl_ell.launches[name] > 0, name


@pytest.mark.parametrize("beta", [1.0, 2.0])
def test_batched_project_no_implicit_syncs(cuda_device, beta):
    """The serving tier's batched program on a staged reference under
    ``sync_guard``: the daemon's device work needs no read of its own
    beyond the loop's lane mask."""
    from cnmf_torch_tpu_torch.serving.batcher import batched_project
    from cnmf_torch_tpu_torch.utils.sanitize import host_read, sync_guard

    ref = _serve_reference(beta, g=800)
    with host_read():
        ref.stage(cuda_device)
    rng = np.random.default_rng(31)
    Xb = np.stack([_serve_query(ref, 256, 40 + i) for i in range(4)])
    Xd = _stage(Xb, cuda_device)
    Hd = _stage(rng.random((4, 256, 9), dtype=np.float32), cuda_device)
    with sync_guard(cuda_device):
        H, rel = batched_project(Xd, Hd, ref.Wd, ref.WWT, ref.w_colsum,
                                 ref.h_tol_dev, beta=beta, max_iter=1000,
                                 l1=0.0, l2=0.0)
        H, rel = _fetch(H, rel)
    assert np.isfinite(H).all() and (rel < 0.05).all()


# the JAX package's one-replicate call of each ELL statistic on the card ->
# the kernel it launches
ONE_REPLICATE_CALLS = {
    "kl_h_stats": ("h_stats",), "kl_w_numer": ("w_numer",),
    "kl_w_stats": ("w_numer",), "kl_beta_err": ("beta_err_partials",),
    "kl_h_newton_stats": ("h_newton_stats",), "kl_wh_at_nz": ("wh_at_nz",),
}


@pytest.mark.parametrize("name", sorted(ONE_REPLICATE_CALLS))
@pytest.mark.parametrize("n,g,k", [(997, 611, 13), (257, 300, 1)])
def test_one_replicate_call_is_the_batched_lane(cuda_device, name, n, g, k):
    """``fn(x, H (n, k), W (k, g))`` on the card launches each of its
    kernels once and equals ``fn(x, H[None], W[None])``'s lane bit for
    bit, in the JAX package's unbatched shapes."""
    x, H, W = edge_inputs(n, g, k, 1, 0.06, 7, cuda_device, zero_rows=3)
    fn = getattr(kl_ell, name)
    kl_ell.reset_launches()
    one = fn(x, H[0], W[0])
    torch.cuda.synchronize()
    assert kl_ell.launches == {
        kern: int(kern in ONE_REPLICATE_CALLS[name])
        for kern in kl_ell.KERNELS}
    batched = fn(x, H, W)
    torch.cuda.synchronize()
    one = one if isinstance(one, tuple) else (one,)
    batched = batched if isinstance(batched, tuple) else (batched,)
    for a, b in zip(one, batched):
        assert a.is_cuda and tuple(a.shape) == tuple(b.shape[1:])
        assert torch.equal(a, b[0])


def test_one_replicate_beta_divergence_on_the_card(cuda_device):
    """The objective's one-replicate call: a 0-d tensor, the batched
    call's bits, one ``beta_err_partials`` launch."""
    from cnmf_torch_tpu_torch.ops.nmf import beta_divergence

    x, H, W = edge_inputs(1001, 2000, 13, 1, 0.06, 8, cuda_device)
    kl_ell.reset_launches()
    one = beta_divergence(x, H[0], W[0], beta=1.0)
    torch.cuda.synchronize()
    assert kl_ell.launches["beta_err_partials"] == 1
    assert one.shape == ()
    assert torch.equal(one, beta_divergence(x, H, W, beta=1.0)[0])
