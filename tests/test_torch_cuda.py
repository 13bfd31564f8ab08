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
