#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which ends the run with a nonzero exit when it fails:

1. Setup: torch version, the card's name and power limit, and the build of
   ``cnmf_torch_tpu_torch/csrc/kl_ell.cu`` with ``nvcc`` for ``sm_90a``
   (build time and the ``-Xptxas -v`` registers and spill of every kernel
   instance, one ``KMAX`` each, also under ``ptxas`` in the report).
2. Kernels: each CUDA kernel against its plain torch version on the card,
   at the shapes its path gives it, with 20 replicates and k in {9, 13}:
   the online path's kernels at one 5,000-row chunk of the pipeline's
   data (f32 at ``rtol 2e-5``, bf16 at ``rtol 2e-2``), and the batch
   path's at the whole 10,000-row matrix (``h_newton_stats``,
   ``wh_at_nz``, and the f32 ``w_numer`` on the whole-matrix transpose
   set, at ``rtol 2e-5``); two launches bit-identical; then each kernel's
   time (CUDA events, warmed, median of many launches) beside its bound,
   its plain version's time and, where one PyTorch call computes the same
   function, that call's time, and for the four kernels on the row walk
   (``h_stats``, ``beta_err_partials``, ``h_newton_stats``, ``wh_at_nz``)
   their launch (threads per block, W table bytes, resident blocks per
   SM); ``h_stats`` also at the pipeline's other K (5, 7, 11) on the chunk.
   ``wh_at_nz`` must hold one value at every slot of a row whose column is
   0 (the padding); ``h_newton_stats`` must give exact +0.0 at an
   all-zero row and +inf in the Hessian exactly where its plain version
   does; ``beta_err_partials`` is held row by row and in total, an
   all-zero row's term exactly +0.0. Then a sweep of all five kernels over
   the card tests' edge shapes (k from 1 to 64, R=1 and 20, tables too
   large for shared memory, all-zero and full-width rows, a gene with no
   stored value and one that fills the transpose width, gene 0 stored
   beside the padding, rows in the KL term's split-log regime, a stored
   negative value) against their plain versions. The sketch recipe's
   sampled-row W statistics (``kl_ell.kl_w_stats_rows``: the rows'
   transpose index set built on the card by ``sparse.ell_take_rows``, then
   the ``w_numer`` kernel) at its shapes, 1,250 rows drawn as the recipe
   draws them from the chunk (online) and from the whole matrix (batch),
   k in {9, 13}, 20 replicates: the index set equal to the one built on
   the CPU, two launches bit-identical, and the statistics against
   ``sparse.ell_kl_w_stats_rows`` on the CPU at ``rtol 2e-5`` (the
   report's ``sketch_rows_check``). Small solves on the
   card (an online KL solve, a usage refit, a batch dna solve, the
   bundled beta=2 solver, batch and online HALS, IS on the dense lane and
   on the ELL hybrid) are held against the same solves on the CPU.
3. Online pipeline: 10,000 cells x 5,000 genes of synthetic counts from
   the low-rank Poisson model of ``bench.py`` at ~600 UMI per cell, then
   prepare (Kullback-Leibler, 2,000 HVGs, chunks of 5,000 cells),
   factorize over K in {5, 7, 9, 11, 13} x 20 replicates, combine,
   consensus (k=9) and the K-selection statistics, with the kernels'
   launch counts set to 0 just before and read just after. It checks that
   the ELL lane ran the CUDA kernels, that every kernel of the path
   launched, that the consensus refit launched ``h_stats`` again, that the
   objectives are finite and fall from pass to pass, and that every
   artifact has its shape. Then one ``torch.profiler`` window over an
   online sweep at k=13 prints each CUDA kernel's share of the device time
   and the device's idle share of the same sweep's unprofiled wall, with
   the profiler's overhead ("not measured" where the profiler fails or
   records no device time; no check; a failure of the sweep itself fails
   the run).
4. Batch pipeline: a second run directory on the same counts whose
   run-parameters file says ``"mode": "batch"`` (edited after prepare, as
   a user would), then factorize, combine, consensus (k=9) and the
   K-selection statistics, with the launch counts set to 0 just before
   and read just after. It checks the ``dna`` recipe and the ``ell-cuda``
   kernel label, that ``h_newton_stats`` and ``wh_at_nz`` launched with
   two ``wh_at_nz`` per ``h_newton_stats`` in factorize, that every
   evaluated objective is finite and non-increasing, that every
   replicate's MU-fallback fraction lies strictly between 0 and 1, and
   the artifacts' shapes. Then a second profiler window, over a batch dna
   sweep at k=13.
5. The default loss (Frobenius, beta=2; the dense lane, plain torch): a
   run prepared without a loss (which must write Frobenius; 2,000 HVGs of
   the same counts, K in {5, 7, 9, 11, 13} x 20 replicates), factorize
   online (one sweep per K; the packed rule takes this ledger, which the
   provenance must record as ``batched-packed``), combine, consensus
   (k=9) and the K-selection statistics; then the same prepared run in
   batch mode (the bundled solver, 128 // k replicates a bundle). It
   checks that no CUDA kernel launched, that the online objectives fall
   and the batch ones never rise (1e-6 relative), and the artifacts'
   shapes; then profiler windows over an online and a batch beta=2 sweep
   at k=13, and the bundled solver's wall against the per-replicate
   ``nmf_fit_batch`` at beta=2 on the same inits at k in {5, 9, 13, 21,
   32, 64} (objectives held equal to 1e-3).
6. The other solvers: HALS (``"algo": "halsvar"`` in the run-parameters
   file) online and in batch at K in {5, 9, 13}, factorize and combine;
   then Itakura-Saito (``prepare`` with ``beta_loss="itakura-saito"``: the
   ELL hybrid, plain torch, labelled ``ell-torch``) online under the bf16
   ratio chain and in batch under the ``amu`` recipe at K in {5, 9, 13},
   each with combine and consensus (k=9). It checks the recipes and labels,
   that no CUDA kernel launched, finite spectra and the artifacts' shapes.
   Phases 5 and 6 print each stage's wall and peak memory beside the
   card's name and power limit. A HALS run must need no retry; an IS
   replicate that ends NaN is retried at a derived seed and quarantined
   when its retries fail too (the report's ``phase6_retries``).
7. Resilience and the rest of factorize, on the same counts (KL online on
   the ELL lane unless named), the launch counts set to 0 before each
   sub-phase: (a) ``CNMF_TPU_FAULT_SPEC="nonfinite:k=9,iter=3"`` at K=9:
   iter 3 is retried once at ``seed ^ 1`` and written, the resilience
   ledger records it, and the retry wave launches ``h_stats``,
   ``w_numer`` and ``beta_err_partials``; (b) iter 4 poisoned at all
   three attempts: it is quarantined, combine without
   ``skip_missing_files`` skips it and consensus runs on 19 replicates;
   with ``CNMF_TPU_MIN_HEALTHY_FRAC=1.0`` factorize must raise
   ``UnhealthySweepError``; (c) at K in {9, 13}, one iter file torn
   (``torn:artifact=iter_``): ``factorize(skip_completed_runs=True)``
   reruns only its K group and every iter file is then bit for bit the
   run without a fault's, and a resume with nothing torn launches no
   kernel; (d) the sequential lane (``batched=False``) at K in {9, 13}, 5
   replicates each, under strict f32 (``CNMF_TPU_BF16_RATIO=0``) and
   under the default bf16 ratio chain: the kernels launch, the provenance
   reads ``sequential``, and under strict f32 each objective is within
   ``rtol 1e-4`` of the batched lane's at the same seed (same init); the
   gaps under the bf16 chain, and to the batched lane at one replicate a
   batch, are logged; (e) a dense Frobenius batch factorize
   from ``init="nndsvd"`` at K in {5, 9, 13} (distinct, finite
   replicates) beside the random init's, and the SVD's wall; (f)
   ``run_nmf(fp_precision="double")`` at k=9 for beta 2 and 1 (f64
   outputs, objective within 1e-3 of the f32 plain-MU solve from the
   same seed); (g) ``CNMF_TPU_SKETCH=1``, batch and online at K in {9,
   13}: the kernels launch on the exact steps, two runs are
   bit-identical, each objective within 5% of plain MU's (strict f32)
   from the same inits; then consensus at k=9 and the K-selection
   statistics with the sketch engaged (dim 256), the decisions read from
   ``consensus_info``. Phase 7 prints its stage walls and peaks.
8. The telemetry base: phase 3's main path again in a run of its own
   (``build/chip_smoke/telemetry``) with ``CNMF_TPU_TELEMETRY``,
   ``CNMF_TPU_METRICS`` and ``CNMF_TPU_TRACE_SAMPLE`` on, K-selection
   through ``k_selection_plot``, the launch counts set to 0 just before.
   It checks that the events file passes ``validate_events_file`` with
   the manifest first (backend ``cuda``, the card's name); one
   ``replicates`` event a K with 20 records of finite traces, one value a
   pass, and the ``ell-cuda`` kernel label; ``memory`` events after the
   five stages with a peak above 0; the worker span and a metrics
   snapshot; that ``report`` and ``trace`` render the run; that every
   kernel launched as often as in phase 3; that every iter spectra file,
   consensus artifact, the K-selection statistics and prepare's f64 TPM
   moments hold phase 3's stored arrays byte for byte (and the text
   files phase 3's bytes); and
   that each stage event's wall is within 10% + 50 ms of this script's
   synchronized wall of the same call. Then the same factorize with the
   knobs off and on in turns (off, on, on, off, three times; logged, no
   gate), and
   one factorize at K=9 under
   ``CNMF_TPU_PROFILE_DIR``, whose Chrome trace must name
   ``h_stats_kernel``. It logs the telemetry-on factorize wall against
   phase 3's, the events file's bytes and the stage walls.

The last three lines of standard output are the kernels' JSON record
(launches of both pipelines), the ``nvidia-smi`` name and power-limit
line, and the run's JSON verdict. Everything the run writes goes under
``build/chip_smoke/`` beside this script. There is no CPU mode: without a
card the script exits 2.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "chip_smoke")

N_CELLS, N_GENES, N_HVG = 10_000, 5_000, 2_000
KS = [5, 7, 9, 11, 13]
REPLICATES = 20
CHUNK = 5_000
CONSENSUS_K = 9
SEED = 14
CARD = "cuda"

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and f32
# operations/s outside the tensor cores (the ELL kernels use no tensor core)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# bf16 operations/s outside the tensor cores: bf16x2 instructions, twice
# the f32 rate (NVIDIA H100 architecture white paper, non-tensor BF16)
PEAK_BF16 = 2 * PEAK_F32

# the TPU kernels the CUDA kernels replace (kernel bodies)
REPLACES = {
    "h_stats": "cnmf_torch_tpu/ops/pallas_kl.py:123",
    # both passes (_ratio_body :154, _w_numer_body :182) in one kernel
    "w_numer": "cnmf_torch_tpu/ops/pallas_kl.py:259",
    "beta_err_partials": "cnmf_torch_tpu/ops/pallas_kl.py:165",
    "h_newton_stats": "cnmf_torch_tpu/ops/pallas_kl.py:138",
    "wh_at_nz": "cnmf_torch_tpu/ops/pallas_kl.py:116",
}
# the batch pipeline's objectives may rise by f32 rounding only
MONOTONE_RTOL = 1e-6
EVAL_EVERY = 10     # the batch solver evaluates its objective this often
OTHER_KS = [5, 9, 13]      # phase 6 runs these Ks
# phase 5 times the bundled beta=2 batch solver against the per-replicate
# one at these Ks (bundle widths 25, 14, 9, 6, 4 and 2)
BUNDLE_KS = [5, 9, 13, 21, 32, 64]
ONLINE_KERNELS = ("h_stats", "w_numer", "beta_err_partials")
BATCH_KERNELS = ("h_newton_stats", "wh_at_nz")
SOURCE = "cnmf_torch_tpu_torch/csrc/kl_ell.cu"


def check(cond, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def ptxas_summary(text: str):
    """One line per compiled kernel: its registers, shared memory and
    spills from ``-Xptxas -v``."""
    lines, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(h_stats|w_numer_prep|w_numer|beta_err"
                              r"|h_newton|wh_at_nz)_kernel"
                              r"I?(.*?)EEv", name)
            name = (short.group(1) + "<" + short.group(2) + ">") if short \
                else name
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            lines.append(f"  {name}: {m.group(1)} registers{m.group(2)}; "
                         f"{spill}")
            name = None
    return lines


def synthetic_counts(n, g, k_true=14, scale=60.0, seed=SEED):
    """The low-rank Poisson GEP model of ``bench.py`` (Dirichlet usages,
    gamma spectra) at ``scale`` counts per unit of usage."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k_true) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(k_true, g)) * 40.0 / g
    counts = rng.poisson(usage @ spectra * scale).astype(np.float32)
    counts[counts.sum(axis=1) == 0, 0] = 1.0
    return counts


def prepared_counts(out: str):
    """The pipeline's synthetic counts, written under ``out``, and the
    normalized HVG matrix that ``prepare`` makes of them (a throwaway
    prepare in its own run directory; it launches no kernel): the matrix
    whose shapes the kernels get on the main path."""
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
    from cnmf_torch_tpu_torch.utils.io import load_matrix

    t0 = time.perf_counter()
    counts = synthetic_counts(N_CELLS, N_GENES)
    counts_fn = os.path.join(out, "counts.df.npz")
    save_df_to_npz(Frame(counts,
                         np.asarray([f"c{i}" for i in range(N_CELLS)]),
                         np.asarray([f"g{j}" for j in range(N_GENES)])),
                   counts_fn, compress=False)
    log(f"synthetic counts {counts.shape}, {counts.sum() / N_CELLS:.1f} "
        f"UMI per cell, written in {time.perf_counter() - t0:.2f} s")
    del counts
    probe = cNMF(out, "shapes", device=CARD)
    probe.prepare(counts_fn, components=[CONSENSUS_K], n_iter=1, seed=SEED,
                  beta_loss="kullback-leibler", num_highvar_genes=N_HVG,
                  batch_size=CHUNK)
    return counts_fn, load_matrix(probe.paths["normalized_counts"]).X


def cuda_ms(fn, iters=40, warmup=5) -> float:
    """Median time of one call in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(statistics.median(s.elapsed_time(e) for s, e in pairs))


def max_abs_err(got, want, rtol, atol=1e-6) -> float:
    """Max |got - want|; fails when any element is outside
    ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    check(not bool(bad.any()),
          f"{int(bad.sum())} elements outside rtol {rtol}: max diff "
          f"{float(diff.max())}")
    return float(diff.max())


def kernel_phase(x, nnz: int, log_rows: list):
    """Every kernel against its plain version at the main path's shapes;
    returns the JSON records (k=13, the mode the pipeline runs it in)."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    dev = x.vals.device
    n, w = x.vals.shape
    g, wt = x.rows_t.shape
    R = REPLICATES
    gen = torch.Generator().manual_seed(SEED)
    records = {}
    for k in (9, 13):
        H = (torch.rand((R, n, k), generator=gen) + 0.1).to(dev)
        W = (torch.rand((R, k, g), generator=gen) + 0.1).to(dev)
        vb = x.vals.to(torch.bfloat16)
        for bf16 in (False, True):
            tag = f"k={k} {'bf16' if bf16 else 'f32'}"
            rtol = 2e-2 if bf16 else 2e-5
            vals = vb if bf16 else x.vals
            errs = {}
            # h_stats
            got = kl_ell.h_stats(vals, x.cols, H, W, bf16)
            again = kl_ell.h_stats(vals, x.cols, H, W, bf16)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"h_stats {tag} not repeatable")
            errs["h_stats"] = max_abs_err(
                got, kl_ell.h_stats_plain(vals, x.cols, H, W, bf16), rtol)
            # the W step passes the f32 values in both modes
            errs["w_numer"] = w_numer_check(kl_ell, x, H, W, bf16, tag)
            if not bf16:
                errs["beta_err_partials"], total_err = beta_err_check(
                    kl_ell, x, H, W, tag)

            # the pipeline runs the W side and the H solve in bf16, the
            # objective (and the consensus refit's h_stats) in f32
            timed = (["h_stats", "w_numer"] if bf16
                     else ["h_stats", "beta_err_partials"])
            for name in timed:
                rec = _time_kernel(kl_ell, name, x,
                                   x.vals if name == "w_numer" else vals,
                                   H, W, bf16, nnz)
                rec["max_abs_err"] = errs[name]
                launch = (h_stats_launch_note(kl_ell, R, n, k, g, bf16)
                          if name == "h_stats" else
                          beta_err_launch_note(kl_ell, R, n, k, g,
                                               total_err)
                          if name == "beta_err_partials" else "")
                log_rows.append(
                    f"  {name:18s} {tag:9s} kernel {rec['ms']:.4f} ms  "
                    f"plain {rec['plain_ms']:.4f} ms  library "
                    f"{rec['library_ms']} ms  bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})  max_abs_err {errs[name]:.3g}"
                    + launch)
                if k == 13 and (bf16 or name == "beta_err_partials"):
                    rec["variant"] = (
                        f"{tag}, R={R}, rows={n}, genes={g}, w={w}, "
                        f"wt={wt}, nnz={nnz}" + launch)
                    records[name] = rec
    return records


def w_numer_check(kl_ell, x, H, W, bf16, tag, vals=None) -> float:
    """The fused W numerator against its plain version: two launches
    bit-identical, a gene with no stored value exactly +0.0; returns the
    max abs error."""
    vals = x.vals if vals is None else vals
    got = kl_ell.w_numer(vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)
    again = kl_ell.w_numer(vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"w_numer {tag} not repeatable")
    empty = (x.perm_t >= x.vals.numel()).all(1)
    check(bool((got[:, :, empty] == 0).all())
          and not bool(torch.signbit(got[:, :, empty]).any()),
          f"w_numer {tag}: a gene with no stored value is not +0.0")
    return max_abs_err(got, kl_ell.w_numer_plain(vals, x.cols, x.rows_t,
                                                 x.perm_t, H, W, bf16),
                       2e-2 if bf16 else 2e-5)


def sketch_rows_check(x, m: int, step: int, stream: int,
                      log_rows: list) -> dict:
    """The sketch recipe's sampled-row W statistics at one of its shapes:
    ``m`` rows of the encoding ``x`` drawn as the recipe draws its sketched
    step ``step`` of ``stream`` (0 batch, 1 online; repeats allowed), 20
    replicates, k in {9, 13}. The rows' transpose index set built on the
    card must equal the one built on the CPU, two launches must agree bit
    for bit, and numerator and denominator must hold against the plain
    version on the CPU at ``rtol 2e-5``; returns the max abs error per
    k."""
    from cnmf_torch_tpu_torch.ops import sparse
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.nmf import _sketch_rows

    dev = x.vals.device
    n = x.vals.shape[0]
    g = x.rows_t.shape[0]
    R = REPLICATES
    gen = torch.Generator().manual_seed(SEED + 2)
    idx = _sketch_rows(step, m, n, stream, None, dev)
    xc = x.to("cpu")
    sub = sparse.ell_take_rows(x, idx)
    sub_cpu = sparse.ell_take_rows(xc, idx.cpu())
    check(torch.equal(sub.rows_t.cpu(), sub_cpu.rows_t)
          and torch.equal(sub.perm_t.cpu(), sub_cpu.perm_t),
          f"ell_take_rows: the transpose set of {m} of {n} rows built on "
          "the card differs from the CPU's")
    errs = {}
    for k in (9, 13):
        H = (torch.rand((R, n, k), generator=gen) + 0.1).to(dev)
        W = (torch.rand((R, k, g), generator=gen) + 0.1).to(dev)
        tag = f"k={k}, {m} of {n} rows"
        got = kl_ell.kl_w_stats_rows(x, H, W, idx)
        again = kl_ell.kl_w_stats_rows(x, H, W, idx)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]),
              f"kl_w_stats_rows {tag} not repeatable")
        want = sparse.ell_kl_w_stats_rows(xc, H.cpu(), W.cpu(), idx.cpu())
        errs[k] = max(max_abs_err(got[0].cpu(), want[0], 2e-5),
                      max_abs_err(got[1].cpu(), want[1], 2e-5))
        log_rows.append(f"  kl_w_stats_rows    {tag} (w_numer on the "
                        f"sampled rows' transpose set of width "
                        f"{sub.rows_t.shape[1]}): max_abs_err "
                        f"{errs[k]:.3g}, two launches bit-identical")
        del H, W, got, again
    return {"rows": m, "of": n, "step": step, "stream": stream,
            "t_width": int(sub.rows_t.shape[1]), "max_abs_err": errs}


def launch_note(L: dict) -> str:
    """A launch of a kernel on the row walk (``kl_ell.h_stats_launch``,
    ``beta_err_launch``, ``h_newton_stats_launch``, ``wh_at_nz_launch``):
    threads per block, the
    packed W table's bytes (0: read from device memory), resident blocks
    per SM, grid."""
    return (f"; launch {L['threads']} threads, table {L['table_bytes']} B"
            f"{'' if L['table_in_smem'] else ' (device memory)'}, "
            f"{L['blocks_per_sm']} blocks/SM, grid {L['grid']}")


def h_stats_launch_note(kl_ell, R, n, k, g, bf16) -> str:
    return launch_note(kl_ell.h_stats_launch(R, n, k, g, bf16, bf16))


def beta_err_launch_note(kl_ell, R, n, k, g, total_err) -> str:
    return (f"; total's max_abs_err {total_err:.3g}"
            + launch_note(kl_ell.beta_err_launch(R, n, k, g)))


def beta_err_check(kl_ell, x, H, W, tag):
    """``beta_err_partials`` against its plain version, each row's term and
    the objective per replicate (``kl_beta_err`` against ``ell_beta_err``)
    at ``rtol 2e-5``: two launches bit-identical, every all-zero row's term
    exactly +0.0. Returns the rows' and the totals' max abs errors."""
    from cnmf_torch_tpu_torch.ops.sparse import ell_beta_err

    rows = kl_ell.beta_err_partials(x.vals, x.cols, H, W)
    again = kl_ell.beta_err_partials(x.vals, x.cols, H, W)
    torch.cuda.synchronize()
    check(torch.equal(rows, again), f"beta_err {tag} not repeatable")
    empty = (x.vals == 0).all(1)
    check(bool((rows[:, empty] == 0).all())
          and not bool(torch.signbit(rows[:, empty]).any()),
          f"beta_err {tag}: an all-zero row is not +0.0")
    return (max_abs_err(rows, kl_ell.beta_err_plain(x.vals, x.cols, H, W),
                        2e-5),
            max_abs_err(kl_ell.kl_beta_err(x, H, W), ell_beta_err(x, H, W),
                        2e-5))


def h_newton_check(kl_ell, x, H, W, tag) -> float:
    """``h_newton_stats`` against its plain version: two launches
    bit-identical, every all-zero row exactly +0.0 in both outputs, +inf in
    the Hessian exactly where the plain version has it and the finite
    values within ``rtol 2e-5``. Returns the max abs error."""
    numer, hess = kl_ell.h_newton_stats(x.vals, x.cols, H, W)
    again = kl_ell.h_newton_stats(x.vals, x.cols, H, W)
    torch.cuda.synchronize()
    check(torch.equal(numer, again[0]) and torch.equal(hess, again[1]),
          f"h_newton_stats {tag} not repeatable")
    empty = (x.vals == 0).all(1)
    for out in (numer, hess):
        check(bool((out[:, empty] == 0).all())
              and not bool(torch.signbit(out[:, empty]).any()),
              f"h_newton_stats {tag}: an all-zero row is not +0.0")
    want_n, want_h = kl_ell.h_newton_stats_plain(x.vals, x.cols, H, W)
    check(torch.equal(torch.isinf(hess), torch.isinf(want_h)),
          f"h_newton_stats {tag}: +inf where the plain Hessian has none")
    fin = torch.isfinite(want_h)
    return max(max_abs_err(numer, want_n, 2e-5),
               max_abs_err(hess[fin], want_h[fin], 2e-5))


def wh_at_nz_check(kl_ell, x, H, W, tag, twin=False) -> float:
    """``wh_at_nz`` against its plain version at every slot, padded ones
    included: two launches bit-identical, every value finite, and every
    slot of a row whose column is 0 holding the row's one column-0 value.
    ``twin``: gene 1's W column is gene 0's, and the gathered gene-1 slots
    must hold those bits too. Returns the max abs error."""
    got = kl_ell.wh_at_nz(x.cols, H, W)
    again = kl_ell.wh_at_nz(x.cols, H, W)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"wh_at_nz {tag} not repeatable")
    check(bool(torch.isfinite(got).all()), f"wh_at_nz {tag}: not finite")
    at = x.cols <= (1 if twin else 0)
    first = torch.where(at, got, torch.tensor(np.inf, device=got.device))
    first = first.amin(-1, keepdim=True).expand_as(got)
    check(torch.equal(got[:, at], first[:, at]),
          f"wh_at_nz {tag}: the column-0 slots of a row differ"
          + (" from the gathered slots of an equal column" if twin else ""))
    return max_abs_err(got, kl_ell.wh_at_nz_plain(x.cols, H, W), 2e-5)


def edge_sweep(log_rows: list):
    """The five kernels at the edge shapes of the card tests, against their
    plain versions, two launches bit-identical: for ``beta_err_partials``
    three all-zero rows (exact +0.0), alone and, in turn, beside a row that
    fills the whole ELL width, three rows in the split-log regime or one
    stored negative value; for ``h_stats`` (both modes) and
    ``h_newton_stats`` three all-zero rows (exact +0.0) and one row that
    fills the whole ELL width, and for ``h_newton_stats`` also the inputs
    of ``wh_at_nz`` below; for ``w_numer`` (both modes) three
    all-zero rows, a gene with no stored value (exact +0.0) and one stored
    in every other row, filling the transpose width; for ``wh_at_nz``
    three all-zero rows and, in turn, genes 0 and 1 stored in every other
    row (a width that is a multiple of 4) or a row that fills the width
    (one that is not), gene 1's W column set to gene 0's, so that every
    column-0 slot must hold the bits of the gathered gene-1 slots of its
    row."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.kernels.edge_cases import (EDGE_SHAPES,
                                                             edge_inputs)

    for n, g, k, R in EDGE_SHAPES:
        for case in ("zero_rows", "full_row", "tiny", "negative"):
            x, H, W = edge_inputs(
                n, g, k, R, 0.06, 3, CARD, zero_rows=3,
                **({} if case == "zero_rows" else {case: True}))
            tag = f"n={n} g={g} k={k} R={R} {case}"
            err, total_err = beta_err_check(kl_ell, x, H, W, tag)
            log_rows.append(f"  beta_err edge {tag:31s} max_abs_err "
                            f"{err:.3g} (w {x.cols.shape[1]})"
                            + beta_err_launch_note(kl_ell, R, n, k, g,
                                                   total_err))
        x, H, W = edge_inputs(n, g, k, R, 0.06, 1, CARD, zero_rows=3,
                              full_row=True)
        check(bool((x.vals[-1] > 0).all()), "edge sweep: no full-width row")
        for bf16 in (False, True):
            tag = f"n={n} g={g} k={k} R={R} {'bf16' if bf16 else 'f32'}"
            vals = x.vals.to(torch.bfloat16) if bf16 else x.vals
            got = kl_ell.h_stats(vals, x.cols, H, W, bf16)
            again = kl_ell.h_stats(vals, x.cols, H, W, bf16)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"h_stats {tag} not repeatable")
            check(bool((got[:, :3] == 0).all())
                  and not bool(torch.signbit(got[:, :3]).any()),
                  f"h_stats {tag}: an all-zero row is not +0.0")
            err = max_abs_err(got, kl_ell.h_stats_plain(vals, x.cols, H, W,
                                                        bf16),
                              2e-2 if bf16 else 2e-5)
            log_rows.append(f"  h_stats edge {tag:28s} max_abs_err "
                            f"{err:.3g}"
                            + h_stats_launch_note(kl_ell, R, n, k, g, bf16))
        newton_launch = launch_note(kl_ell.h_newton_stats_launch(R, n, k, g))
        tag = f"n={n} g={g} k={k} R={R} full_row"
        err = h_newton_check(kl_ell, x, H, W, tag)
        log_rows.append(f"  h_newton_stats edge {tag:31s} max_abs_err "
                        f"{err:.3g} (w {x.cols.shape[1]})" + newton_launch)
        x, H, W = edge_inputs(n, g, k, R, 0.06, 2, CARD, zero_rows=3,
                              gene_edges=True)
        check(bool((x.perm_t[-1] < x.vals.numel()).all()),
              "edge sweep: no gene fills the transpose width")
        for bf16 in (False, True):
            tag = f"n={n} g={g} k={k} R={R} {'bf16' if bf16 else 'f32'}"
            err = max(w_numer_check(kl_ell, x, H, W, bf16, tag, vals)
                      for vals in ([x.vals, x.vals.to(torch.bfloat16)]
                                   if bf16 else [x.vals]))
            log_rows.append(f"  w_numer edge {tag:28s} max_abs_err "
                            f"{err:.3g} (wt {x.rows_t.shape[1]})")
        for case in ("gene0", "full_row"):
            x, H, W = edge_inputs(n, g, k, R, 0.06, 7, CARD, zero_rows=3,
                                  **{case: True})
            W[:, :, 1] = W[:, :, 0]
            tag = f"n={n} g={g} k={k} R={R} {case}"
            check(bool(((x.cols == 0).any(1) & (x.cols == 1).any(1)).any()),
                  f"wh_at_nz edge {tag}: no row with both genes")
            err = wh_at_nz_check(kl_ell, x, H, W, tag, twin=True)
            log_rows.append(f"  wh_at_nz edge {tag:31s} max_abs_err "
                            f"{err:.3g} (w {x.cols.shape[1]})"
                            + launch_note(kl_ell.wh_at_nz_launch(R, n, k, g)))
            if case == "gene0":
                err = h_newton_check(kl_ell, x, H, W, tag)
                log_rows.append(f"  h_newton_stats edge {tag:31s} "
                                f"max_abs_err {err:.3g} (w "
                                f"{x.cols.shape[1]})" + newton_launch)


def h_stats_k_sweep(x, nnz: int, log_rows: list):
    """``h_stats`` at the pipeline's other K (phase 2 times k=9 and 13) on
    the chunk, both modes: checked against its plain version and timed
    beside its bound. Returns the records."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    n, g = x.vals.shape[0], x.rows_t.shape[0]
    R = REPLICATES
    gen = torch.Generator().manual_seed(SEED + 2)
    out = []
    for k in (k for k in KS if k not in (9, 13)):
        H = (torch.rand((R, n, k), generator=gen) + 0.1).to(CARD)
        W = (torch.rand((R, k, g), generator=gen) + 0.1).to(CARD)
        for bf16 in (False, True):
            tag = f"k={k} {'bf16' if bf16 else 'f32'}"
            vals = x.vals.to(torch.bfloat16) if bf16 else x.vals
            err = max_abs_err(kl_ell.h_stats(vals, x.cols, H, W, bf16),
                              kl_ell.h_stats_plain(vals, x.cols, H, W, bf16),
                              2e-2 if bf16 else 2e-5)
            rec = _time_kernel(kl_ell, "h_stats", x, vals, H, W, bf16, nnz)
            rec.update(k=k, mode="bf16" if bf16 else "f32", max_abs_err=err)
            out.append(rec)
            log_rows.append(
                f"  h_stats            {tag:9s} kernel {rec['ms']:.4f} ms  "
                f"plain {rec['plain_ms']:.4f} ms  bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})  max_abs_err "
                f"{err:.3g}" + h_stats_launch_note(kl_ell, R, n, k, g, bf16))
    return out


# the port's CUDA kernels as the profiler names them
PORT_KERNELS = ("h_stats", "w_numer_prep", "w_numer", "beta_err",
                "h_newton", "wh_at_nz")


def profile_window(label: str, sweep, log_rows: list):
    """One ``torch.profiler`` window over ``sweep()``: each CUDA kernel's
    share of the device time and the device's idle share (one stream, so
    the kernels' device times do not overlap and their sum is the busy
    time). The idle share is taken against the same sweep's wall without
    the profiler, whose overhead is printed beside it. A failure of the
    sweep fails the run; where the profiler itself fails or records no
    device time, both shares read "not measured", which is no failure."""

    def not_measured(e):
        log_rows.append(f"  profiler window ({label}): not measured "
                        f"({type(e).__name__}: "
                        f"{str(e).splitlines()[0][:120] if str(e) else ''})")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    out = {"sweep_seconds": plain_wall}
    try:    # the profiler is untried on this machine
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:
        not_measured(e)
        return out
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    except BaseException:
        with contextlib.suppress(Exception):
            prof.stop()
        raise
    try:
        prof.stop()
        dev_us = {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(evt, "self_device_time_total", None)
            if t is None:
                t = getattr(evt, "self_cuda_time_total", 0.0)
            dev_us[evt.key] = dev_us.get(evt.key, 0.0) + float(t)
    except Exception as e:
        not_measured(e)
        return out
    busy = sum(dev_us.values()) / 1e6
    out["profiled_seconds"] = wall
    if busy <= 0:
        log_rows.append(f"  profiler window ({label}): device time not "
                        "measured (no device events recorded)")
        return out
    kernels = {name: sum(t for key, t in dev_us.items()
                         if f"{name}_kernel" in key) / 1e6
               for name in PORT_KERNELS}
    idle = 1.0 - busy / plain_wall
    out.update(device_busy_seconds=busy, kernel_seconds=kernels,
               kernel_shares={n: t / busy for n, t in kernels.items()},
               idle_share=idle, profiler_overhead_seconds=wall - plain_wall,
               top={key: t / 1e6 for key, t in sorted(
                   dev_us.items(), key=lambda kv: -kv[1])[:8]})
    other = busy - sum(kernels.values())
    log_rows.append(
        f"  profiler window ({label}): wall {plain_wall:.3f} s unprofiled, "
        f"{wall:.3f} s profiled (profiler overhead {wall - plain_wall:.3f} "
        f"s); device busy {busy:.3f} s; device idle {idle:.1%} of the "
        "unprofiled wall")
    log_rows.append("    device time: " + "".join(
        f"{n} {t:.3f} s = {t / busy:.1%}, " for n, t in kernels.items()
        if t > 0) + f"other (torch) {other:.3f} s = {other / busy:.1%}")
    for key, t in out["top"].items():
        log_rows.append(f"    {t * 1e3:9.3f} ms  {key[:100]}")
    return out


def sweep_at_13(Xn, mode: str, beta_loss="kullback-leibler"):
    """A replicate sweep of the pipeline's 20 replicates at k=13."""
    from cnmf_torch_tpu_torch.parallel.replicates import replicate_sweep

    return lambda: replicate_sweep(
        Xn, list(range(REPLICATES)), 13, beta_loss=beta_loss,
        mode=mode, online_chunk_size=CHUNK, device=CARD)


def batch_kernel_phase(x, nnz: int, log_rows: list):
    """The batch path's kernels against their plain versions at its
    shapes: the whole matrix (unchunked ELL with the whole-matrix
    transpose set), 20 replicates, k in {9, 13}, strict f32. Returns the
    JSON records of ``h_newton_stats`` and ``wh_at_nz`` at k=13 and every
    other kernel row timed at these shapes (k=9 and 13)."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    dev = x.vals.device
    n, w = x.vals.shape
    g, wt = x.rows_t.shape
    R = REPLICATES
    gen = torch.Generator().manual_seed(SEED + 1)
    records, extra = {}, []
    for k in (9, 13):
        H = (torch.rand((R, n, k), generator=gen) + 0.1).to(dev)
        W = (torch.rand((R, k, g), generator=gen) + 0.1).to(dev)
        tag = f"k={k} f32 batch"
        errs = {}
        errs["h_newton_stats"] = h_newton_check(kl_ell, x, H, W, tag)
        errs["wh_at_nz"] = wh_at_nz_check(kl_ell, x, H, W, tag)
        errs["w_numer"] = w_numer_check(kl_ell, x, H, W, False, tag)
        got = kl_ell.h_stats(x.vals, x.cols, H, W, False)
        errs["h_stats"] = max_abs_err(
            got, kl_ell.h_stats_plain(x.vals, x.cols, H, W, False), 2e-5)
        errs["beta_err_partials"], total_err = beta_err_check(kl_ell, x, H,
                                                              W, tag)
        for name in ("h_newton_stats", "wh_at_nz", "w_numer", "h_stats",
                     "beta_err_partials"):
            rec = _time_kernel(kl_ell, name, x, x.vals, H, W, False, nnz)
            rec["max_abs_err"] = errs[name]
            launch = (h_stats_launch_note(kl_ell, R, n, k, g, False)
                      if name == "h_stats" else
                      launch_note(kl_ell.h_newton_stats_launch(R, n, k, g))
                      if name == "h_newton_stats" else
                      launch_note(kl_ell.wh_at_nz_launch(R, n, k, g))
                      if name == "wh_at_nz" else
                      beta_err_launch_note(kl_ell, R, n, k, g, total_err)
                      if name == "beta_err_partials" else "")
            log_rows.append(
                f"  {name:18s} {tag:15s} kernel {rec['ms']:.4f} ms  "
                f"plain {rec['plain_ms']:.4f} ms  library "
                f"{rec['library_ms']} ms  bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']})  max_abs_err {errs[name]:.3g}"
                + launch)
            rec["variant"] = (
                f"{tag}, R={R}, rows={n}, genes={g}, w={w}, wt={wt}, "
                f"nnz={nnz}" + rec.pop("library_note", "") + launch)
            if k == 13 and name in ("h_newton_stats", "wh_at_nz"):
                records[name] = rec
            else:
                extra.append(rec)
        del H, W
        torch.cuda.empty_cache()
    return records, extra


def _time_kernel(kl_ell, name, x, vals, H, W, bf16, nnz):
    R, n, k = H.shape
    g = W.shape[-1]
    vb = vals.element_size()
    hw_bytes = R * n * k * 4 + R * k * g * 4
    library_ms = None
    note = ""
    ops_bf16 = 0
    if name == "h_newton_stats":
        fn = lambda: kl_ell.h_newton_stats(  # noqa: E731
            vals, x.cols, H, W)
        plain = lambda: kl_ell.h_newton_stats_plain(  # noqa: E731
            vals, x.cols, H, W)
        nbytes = nnz * 8 + hw_bytes + 2 * R * n * k * 4
        ops = R * nnz * (7 * k + 3)
    elif name == "wh_at_nz":
        fn = lambda: kl_ell.wh_at_nz(x.cols, H, W)  # noqa: E731
        plain = lambda: kl_ell.wh_at_nz_plain(x.cols, H, W)  # noqa: E731
        # cols read once (every slot, since every slot is written), H and
        # W once, the (R, n, w) output written once
        w = x.cols.shape[-1]
        nbytes = n * w * 4 + hw_bytes + R * n * w * 4
        ops = R * nnz * 2 * k
        # one PyTorch call for the same function: the SDDMM on the CSR
        # pattern of the stored nonzeros
        library_ms, note = _sampled_addmm_ms(x, H, W)
    elif name == "h_stats":
        fn = lambda: kl_ell.h_stats(vals, x.cols, H, W, bf16)  # noqa: E731
        plain = lambda: kl_ell.h_stats_plain(  # noqa: E731
            vals, x.cols, H, W, bf16)
        nbytes = nnz * (vb + 4) + hw_bytes + R * n * k * 4
        ops = R * nnz * (4 * k + 1)
        if bf16:
            # the kernel runs the k h*w products, the WH sum and the k
            # ratio*W products in bf16; the k f32 sums and the division
            # stay f32
            ops_bf16 = R * nnz * 3 * k
            ops -= ops_bf16
    elif name == "w_numer":
        fn = lambda: kl_ell.w_numer(  # noqa: E731
            vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)
        plain = lambda: kl_ell.w_numer_plain(  # noqa: E731
            vals, x.cols, x.rows_t, x.perm_t, H, W, bf16)
        # the stored slots' value, rows_t and perm_t; H and W read once;
        # the (R, k, g) numerator written once
        nbytes = nnz * (vb + 8) + hw_bytes + R * k * g * 4
        ops = R * nnz * (4 * k + 1)
        if bf16:
            # the k h*w products, the WH sum and the k ratio*h products in
            # bf16; the k f32 sums and the division stay f32
            ops_bf16 = R * nnz * 3 * k
            ops -= ops_bf16
    else:
        fn = lambda: kl_ell.beta_err_partials(  # noqa: E731
            x.vals, x.cols, H, W)
        plain = lambda: kl_ell.beta_err_plain(  # noqa: E731
            x.vals, x.cols, H, W)
        # the stored slots' value and column, H and W once, the (R, n) row
        # terms written once; a log1p counted as one operation
        nbytes = nnz * 8 + hw_bytes + R * n * 4
        ops = R * nnz * (2 * k + 8)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + ops_bf16 / PEAK_BF16) * 1e3
    rec = {"name": name, "route": "cuda", "source": SOURCE,
           "replaces": REPLACES[name], "launches": 0,
           "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, iters=10,
                                                  warmup=2),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    if note:
        rec["library_note"] = note
    return rec


def _sampled_addmm_ms(x, H, W):
    """``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM) of H @ W on the
    CSR pattern of the stored nonzeros: batched over the replicates when
    the installed PyTorch takes the batch, else one call per replicate
    (summed). Returns ``(ms, note)``."""
    R, n, k = H.shape
    g = W.shape[-1]
    keep = x.vals > 0
    counts = keep.sum(1)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=H.device)
    crow[1:] = torch.cumsum(counts, 0)
    col = x.cols[keep].long()
    nz = int(col.numel())
    vals = torch.ones(nz, dtype=torch.float32, device=H.device)
    try:
        A = torch.sparse_csr_tensor(crow.expand(R, n + 1).contiguous(),
                                    col.expand(R, nz).contiguous(),
                                    vals.expand(R, nz).contiguous(),
                                    (R, n, g))
        torch.sparse.sampled_addmm(A, H, W, beta=0.0)
        torch.cuda.synchronize()
        return (cuda_ms(lambda: torch.sparse.sampled_addmm(A, H, W,
                                                           beta=0.0),
                        iters=10, warmup=2),
                "; library: batched sampled_addmm")
    except (RuntimeError, NotImplementedError) as e:
        A = torch.sparse_csr_tensor(crow, col, vals, (n, g))

        def per_rep():
            for r in range(R):
                torch.sparse.sampled_addmm(A, H[r], W[r], beta=0.0)

        return (cuda_ms(per_rep, iters=5, warmup=1),
                f"; library: sampled_addmm per replicate x {R} (the "
                f"batched call refused: {str(e).splitlines()[0][:80]})")


def small_solve_check(log_rows):
    """A small online KL solve and a fixed-iteration usage refit on the card
    (CUDA kernels) against the same solves on the CPU (plain versions)."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.ops.sparse import csr_to_ell, ell_chunk_rows

    rng = np.random.default_rng(SEED)
    X = sp.random(600, 300, density=0.06, format="csr",
                  random_state=int(rng.integers(1 << 31)),
                  data_rvs=lambda s: rng.gamma(2.0, 1.0, s) + 0.1)
    X = X.astype(np.float32)
    e, pad = ell_chunk_rows(X, 256)
    k, R = 6, 3
    H0 = torch.as_tensor(rng.random((R, 600 + pad, k), np.float32) + 0.1)
    H0[:, 600:] = 0
    W0 = torch.as_tensor(rng.random((R, k, 300), np.float32) + 0.1)
    h_tol, n_passes, h_tol_start = nmf.resolve_online_schedule(1.0)
    errs = {}
    for dev in (CARD, "cpu"):
        _, _, err = nmf.nmf_fit_online(
            e.to(dev), H0.reshape(R, -1, 256, k).to(dev), W0.to(dev),
            beta=1.0, h_tol=h_tol, chunk_max_iter=200, n_passes=n_passes,
            h_tol_start=h_tol_start, bf16_ratio=True)
        errs[dev] = err.cpu().numpy()
    rel = np.abs(errs[CARD] - errs["cpu"]) / errs["cpu"]
    check(np.isfinite(errs[CARD]).all() and rel.max() < 5e-2,
          f"online bf16 solve on the card vs the CPU: rel {rel}")
    # h_tol 0: both run exactly 50 inner steps
    xe = csr_to_ell(X, transpose=False)
    outs = [nmf.fit_h(xe, W0[0].numpy(), H_init=H0[0, :600].numpy(),
                      chunk_size=256, chunk_max_iter=50, h_tol=0.0,
                      beta=1.0, device=dev) for dev in (CARD, "cpu")]
    check(np.allclose(outs[0], outs[1], rtol=1e-4, atol=1e-6),
          "fit_h on the card vs the CPU beyond rtol 1e-4: max diff "
          f"{np.abs(outs[0] - outs[1]).max()}")
    log_rows.append(f"  small online KL solve (bf16), card vs CPU: max rel "
                    f"objective diff {rel.max():.3g} (band 5e-2)")
    log_rows.append(f"  fit_h f32 50 steps, card vs CPU: max abs diff "
                    f"{np.abs(outs[0] - outs[1]).max():.3g} (rtol 1e-4)")
    # a batch dna solve of a fixed 60 iterations (tol 0), strict f32
    xb = csr_to_ell(X)
    final, fb = {}, {}
    for dev in (CARD, "cpu"):
        trace = []
        _, _, err = nmf.nmf_fit_batch(
            xb.to(dev), H0[:, :600].contiguous().to(dev), W0.to(dev),
            beta=1.0, tol=0.0, max_iter=60, kl_newton=True, trace=trace)
        final[dev] = err.cpu().numpy()
        fb[dev] = trace[0].dna_fallback
    rel = np.abs(final[CARD] - final["cpu"]) / final["cpu"]
    check(np.isfinite(final[CARD]).all() and rel.max() < 1e-4,
          f"batch dna solve on the card vs the CPU: rel {rel}")
    check(((fb[CARD] > 0) & (fb[CARD] < 1)).all(),
          f"batch dna fallback fraction on the card {fb[CARD]}")
    log_rows.append(f"  batch dna solve f32 60 iterations, card vs CPU: "
                    f"max rel objective diff {rel.max():.3g} (rtol 1e-4); "
                    f"fallback fraction card {np.round(fb[CARD], 4)} "
                    f"CPU {np.round(fb['cpu'], 4)}")
    plain_solve_check(log_rows)


def lowrank_counts(n, g, k=4, seed=SEED, density=0.08):
    """Poisson counts of a low-rank model at about ``density`` nonzeros
    (dense numpy): the small solves' input for the plain-torch solvers."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k) * 0.3, size=n)
    spectra = rng.gamma(0.3, 1.0, size=(k, g)) * 40.0 / g
    lam = usage @ spectra
    X = rng.poisson(lam * -np.log(1.0 - density) / lam.mean()).astype(
        np.float32)
    X[X.sum(axis=1) == 0, 0] = 1.0
    return X


def plain_solve_check(log_rows):
    """The solvers of phases 5 and 6 (plain torch, no CUDA kernel of ours)
    on the card against the same solves on the CPU: the bundled beta=2
    batch solver (R=7 at k=5, no bundle multiple) and batch HALS, each a
    fixed 60 or 40 iterations (tol 0), online HALS, and Itakura-Saito on
    the dense lane and on the ELL hybrid, in batch under ``amu`` (40
    iterations, tol 0) and online under the bf16 ratio chain (one chunk).
    f32 solves at ``rtol 1e-4`` in the objective, bf16 within 5%; no kernel
    may launch."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.sparse import EllMatrix, csr_to_ell

    rng = np.random.default_rng(SEED + 3)
    Xd = lowrank_counts(600, 300, density=0.3)
    Xs = lowrank_counts(480, 400, density=0.05)
    ell = csr_to_ell(Xs)
    h_tol, n_passes, h0 = nmf.resolve_online_schedule(0.0)

    def inits(R, n, g, k):
        return (torch.as_tensor(rng.random((R, n, k), np.float32) + 0.1),
                torch.as_tensor(rng.random((R, k, g), np.float32) + 0.1))

    H7, W7 = inits(7, 600, 300, 5)
    H3, W3 = inits(3, 600, 300, 4)
    Hs, Ws = inits(3, 480, 400, 4)

    def one_chunk(x):
        if isinstance(x, EllMatrix):
            return EllMatrix(x.vals[None], x.cols[None], x.g, x.rows_t[None],
                             x.perm_t[None])
        return x[None]

    cases = {
        "bundled beta=2 batch, 60 iterations": (1e-4, lambda d: (
            nmf.nmf_fit_batch_bundled(
                torch.as_tensor(Xd).to(d), H7.to(d), W7.to(d), tol=0.0,
                max_iter=60)[2])),
        "HALS batch, 40 sweeps": (1e-4, lambda d: nmf.nmf_fit_batch_hals(
            torch.as_tensor(Xd).to(d), H3.to(d), W3.to(d), tol=0.0,
            max_iter=40)[2]),
        "HALS online, 2 chunks": (1e-4, lambda d: nmf.nmf_fit_online(
            torch.as_tensor(Xd).to(d).reshape(2, 300, 300),
            H3.reshape(3, 2, 300, 4).to(d), W3.to(d), beta=2.0, h_tol=3e-3,
            chunk_max_iter=200, n_passes=20, algo="halsvar")[2]),
    }
    for lane, x in (("dense", torch.as_tensor(Xs)), ("ELL hybrid", ell)):
        cases[f"IS {lane} batch amu, 40 iterations"] = (
            1e-4, lambda d, x=x: nmf.nmf_fit_batch(
                x.to(d), Hs.to(d), Ws.to(d), beta=0.0, tol=0.0,
                max_iter=40, inner_repeats=3)[2])
        cases[f"IS {lane} online bf16, 1 chunk"] = (
            5e-2, lambda d, x=x: nmf.nmf_fit_online(
                one_chunk(x.to(d)), Hs[:, None].to(d), Ws.to(d), beta=0.0,
                h_tol=h_tol, chunk_max_iter=200, n_passes=n_passes,
                h_tol_start=h0, bf16_ratio=True)[2])
    kl_ell.reset_launches()
    for name, (rtol, solve) in cases.items():
        card, cpu = (solve(d).cpu().numpy() for d in (CARD, "cpu"))
        rel = np.abs(card - cpu) / np.abs(cpu)
        check(np.isfinite(card).all() and rel.max() < rtol,
              f"{name} on the card vs the CPU: rel {rel}")
        log_rows.append(f"  {name}, card vs CPU: max rel objective diff "
                        f"{rel.max():.3g} (band {rtol:g})")
    check(sum(kl_ell.launches.values()) == 0,
          f"the plain-torch solves launched a kernel: {kl_ell.launches}")


def check_artifacts(obj, stats, ks=KS, written=None, dt="0_5"):
    """Every artifact of a pipeline run has its shape and finite values
    (``stats`` None: the run took no K-selection statistics; ``written``:
    the replicates factorize wrote per K, all of them by default; ``dt``:
    the consensus density threshold's file tag)."""
    from cnmf_torch_tpu_torch.utils.io import load_df_from_npz

    g_hv = N_HVG
    for k in ks:
        m = load_df_from_npz(obj.paths["merged_spectra"] % k)
        reps = REPLICATES if written is None else written[k]
        check(m.shape == (reps * k, g_hv), f"merged k={k} {m.shape}")
        check(np.isfinite(m.values).all(), f"merged k={k} not finite")
    for key, shape in {"consensus_spectra": (CONSENSUS_K, g_hv),
                       "consensus_usages": (N_CELLS, CONSENSUS_K),
                       "gene_spectra_tpm": (CONSENSUS_K, N_GENES),
                       "gene_spectra_score": (CONSENSUS_K, N_GENES),
                       "starcat_spectra": (CONSENSUS_K, g_hv)}.items():
        df = load_df_from_npz(obj.paths[key] % (CONSENSUS_K, dt))
        check(df.shape[1] == shape[1] and df.shape[0] <= shape[0],
              f"{key} shape {df.shape}")
        check(np.isfinite(np.asarray(df.values, np.float64)).all(),
              f"{key} not finite")
    if stats is None:
        return
    check(stats.shape == (len(KS), 4) and np.isfinite(stats.values).all(),
          "k-selection statistics")
    log(f"{obj.name}: k-selection statistics [k, threshold, silhouette, "
        "error]:")
    for row in stats.values:
        log("  " + " ".join(f"{v:.6g}" for v in row))


def prepared_run(name, counts_fn, ks, beta_loss=None, stages=None,
                 n_iter=REPLICATES, **params):
    """A run directory prepared on the pipeline's counts (``prepare`` timed
    as a stage when ``stages`` is given; without ``beta_loss`` prepare
    takes its default, which must write Frobenius; ``n_iter`` replicates
    a K), its run-parameters file then edited as a user would
    (``params``, e.g. ``mode="batch"``, ``algo="halsvar"``,
    ``init="nndsvd"``)."""
    from cnmf_torch_tpu_torch import cNMF

    obj = cNMF(OUT, name, device=CARD)
    loss = {} if beta_loss is None else {"beta_loss": beta_loss}

    def prepare():
        obj.prepare(counts_fn, components=ks, n_iter=n_iter, seed=SEED,
                    num_highvar_genes=N_HVG, batch_size=CHUNK, **loss)

    if stages is None:
        prepare()
    else:
        stages.run(f"{name} prepare", prepare)
    params_fn = obj.paths["nmf_run_parameters"]
    with open(params_fn) as f:
        run_params = json.load(f)
    check((run_params["mode"], run_params["algo"]) == ("online", "mu"),
          f"prepare wrote {run_params['mode']}/{run_params['algo']}")
    check(run_params["beta_loss"] == (beta_loss or "frobenius"),
          f"prepare wrote beta_loss {run_params['beta_loss']!r}")
    run_params.update(params)
    with open(params_fn, "w") as f:
        json.dump(run_params, f, indent=1, sort_keys=True)
    return obj


def check_online_traces(info, ks, label, first=0) -> int:
    """Every online objective finite, the last pass's below pass
    ``first``'s in every lane; returns the count of pass-to-pass rises
    from pass ``first`` on."""
    rises = 0
    for k in ks:
        for trace in info["trace"][k]:
            check(np.isfinite(trace).all(), f"{label} k={k}: nonfinite "
                  "objective")
            check((trace[-1] < trace[first]).all(),
                  f"{label} k={k}: objective did not fall")
            rises += int((np.diff(trace[first:], axis=0) > 0).sum())
        check(np.isfinite(info["errs"][k]).all(),
              f"{label} k={k}: nonfinite error")
        log(f"{label} k={k}: passes {[t.shape[0] for t in info['trace'][k]]}"
            f", final objective {np.round(info['errs'][k], 1).tolist()}")
    return rises


def batch_rises(info, ks, label, strict=True) -> int:
    """The count of evaluated batch objectives that rose by more than
    ``MONOTONE_RTOL``; ``strict``: every evaluated objective and final
    error finite, and none rose."""
    rises = 0
    for k in ks:
        check(not strict or np.isfinite(info["errs"][k]).all(),
              f"{label} k={k}: nonfinite error")
        for tm in info["trace"][k]:
            for r in range(tm.iters.shape[0]):
                tr = tm.trace[r, :int(tm.iters[r]) // EVAL_EVERY]
                check(not strict or (np.isfinite(tr).all()
                                     and not tm.nonfinite[r]),
                      f"{label} k={k} lane {r}: nonfinite objective")
                rise = np.diff(tr) - MONOTONE_RTOL * np.abs(tr[:-1])
                rises += int((rise > 0).sum())
                check(not strict or (rise <= 0).all(),
                      f"{label} k={k} lane {r}: objective rose by "
                      f"{float(np.diff(tr).max())} (trace {tr.tolist()})")
        iters = np.concatenate([tm.iters for tm in info["trace"][k]])
        log(f"{label} k={k}: iterations {int(iters.min())}-"
            f"{int(iters.max())}, final objective "
            f"{np.round(info['errs'][k], 1).tolist()}")
    return rises


def bundle_vs_batch(Xn, log_rows) -> dict:
    """The beta=2 batch solve of the pipeline's 20 replicates at each k of
    ``BUNDLE_KS`` on the dense HVG matrix, by ``nmf_fit_batch_bundled``
    (``128 // k`` replicates a bundle) and by the per-replicate
    ``nmf_fit_batch``, from the same inits at the sweep's tol (1e-4) and
    iteration cap (500): each solve's wall (host clock after a
    synchronize; runs in the order bundled, per-replicate, per-replicate,
    bundled, the faster of each pair kept), the iterations, and the
    objectives, which must agree to 1e-3 relative. The sweep's choice of
    the bundled solver (``BUNDLE_MIN_WIDTH``) stands on these times."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.parallel.replicates import stacked_inits

    X = nmf.dense_on_device(Xn, CARD)
    n, g = X.shape
    x_mean = float(X.mean())
    out = {}
    for k in BUNDLE_KS:
        H0, W0 = stacked_inits(x_mean, n, g, k, range(REPLICATES), CARD)
        solvers = {
            "bundled": lambda tr: nmf.nmf_fit_batch_bundled(
                X, H0, W0, tol=1e-4, max_iter=500, trace=tr),
            "per_replicate": lambda tr: nmf.nmf_fit_batch(
                X, H0, W0, beta=2.0, tol=1e-4, max_iter=500, trace=tr)}
        walls = {name: [] for name in solvers}
        res = {}
        for name in ("bundled", "per_replicate", "per_replicate",
                     "bundled"):
            tr = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            err = solvers[name](tr)[2]
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            res[name] = (err.cpu().numpy(), tr[0].iters)
        (eb, ib), (ep, ip) = res["bundled"], res["per_replicate"]
        rel = float(np.max(np.abs(eb - ep) / np.abs(ep)))
        check(np.isfinite(eb).all() and rel < 1e-3,
              f"k={k}: bundled and per-replicate objectives differ by {rel}")
        tb, tp = min(walls["bundled"]), min(walls["per_replicate"])
        out[k] = {"bundled_s": walls["bundled"],
                  "per_replicate_s": walls["per_replicate"],
                  "iters_bundled": [int(ib.min()), int(ib.max())],
                  "iters_per_replicate": [int(ip.min()), int(ip.max())],
                  "max_rel_objective_diff": rel,
                  "bundle_width": nmf.bundle_width(k)}
        log_rows.append(
            f"  beta=2 batch solve k={k}, {REPLICATES} replicates: bundled "
            f"({nmf.bundle_width(k)} a bundle) {tb:.3f} s "
            f"({', '.join(f'{w:.3f}' for w in walls['bundled'])}), "
            f"per-replicate {tp:.3f} s "
            f"({', '.join(f'{w:.3f}' for w in walls['per_replicate'])}), "
            f"per-replicate / bundled {tp / tb:.2f}x; iterations "
            f"{int(ib.min())}-{int(ib.max())} / {int(ip.min())}-"
            f"{int(ip.max())}; max rel objective diff {rel:.3g}")
        del H0, W0
    return out


def frobenius_phase(counts_fn, Xn, stages, log_rows) -> dict:
    """Phase 5: the default loss online, then batch (the bundled solver),
    then the bundled solver against the per-replicate one; returns the
    launch counts, the profiles and the solver times."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.parallel import replicates

    kl_ell.reset_launches()
    obj = prepared_run("frobenius", counts_fn, KS, stages=stages)
    stages.run("frobenius factorize", obj.factorize)
    info = obj.factorize_info
    check((info["lane"], info["kernel"], info["solver_recipe"])
          == ("dense", "dense", "mu"),
          f"frobenius factorize ran {info['lane']}/{info['kernel']}/"
          f"{info['solver_recipe']}")
    # this ledger (5 Ks x 20 replicates, one worker) is the packed rule's;
    # the port records it and runs the per-K sweeps
    with open(obj.paths["factorize_provenance"] % 0) as f:
        path = json.load(f)["engaged_path"]
    check(info["packed"] and path == "batched-packed",
          f"packed rule: packed={info['packed']}, provenance {path}")
    rises = check_online_traces(info, KS, "frobenius")
    log(f"frobenius: pass-to-pass objective rises {rises}")
    stages.run("frobenius combine", obj.combine)
    stages.run("frobenius consensus", lambda: obj.consensus(
        CONSENSUS_K, density_threshold=0.5))
    stats = stages.run("frobenius k_selection", obj.k_selection_stats)
    check_artifacts(obj, stats)
    online = dict(kl_ell.launches)

    kl_ell.reset_launches()
    bobj = prepared_run("frobenius_batch", counts_fn, KS, mode="batch")
    bundled = []
    real = replicates.nmf_fit_batch_bundled

    def spy(*a, **kw):
        bundled.append(tuple(a[1].shape))
        return real(*a, **kw)

    replicates.nmf_fit_batch_bundled = spy
    try:
        stages.run("frobenius batch factorize", bobj.factorize)
    finally:
        replicates.nmf_fit_batch_bundled = real
    binfo = bobj.factorize_info
    check((binfo["mode"], binfo["kernel"], binfo["solver_recipe"])
          == ("batch", "dense", "mu"),
          f"frobenius batch ran {binfo['mode']}/{binfo['kernel']}/"
          f"{binfo['solver_recipe']}")
    check(sorted(s[-1] for s in bundled) == sorted(KS),
          f"the bundled solver ran for {bundled}")
    batch_rises(binfo, KS, "frobenius batch")
    stages.run("frobenius batch combine", bobj.combine)
    stages.run("frobenius batch consensus", lambda: bobj.consensus(
        CONSENSUS_K, density_threshold=0.5))
    b_stats = stages.run("frobenius batch k_selection",
                         bobj.k_selection_stats)
    check_artifacts(bobj, b_stats)
    batch = dict(kl_ell.launches)
    for label, counts in (("online", online), ("batch", batch)):
        check(sum(counts.values()) == 0,
              f"the frobenius {label} path launched a kernel: {counts}")
    log(f"frobenius kernel launches: online {online}; batch {batch}")
    profile = {}
    for mode in ("online", "batch"):
        profile["frobenius_" + mode] = profile_window(
            f"frobenius {mode} sweep, k=13, {REPLICATES} replicates"
            + (f", {replicates.bundle_width(13)} a bundle"
               if mode == "batch" else ""),
            sweep_at_13(Xn, mode, "frobenius"), log_rows)
    solver_times = bundle_vs_batch(Xn, log_rows)
    return {"launches": {"online": online, "batch": batch},
            "profile": profile, "bundles": bundled,
            "bundle_vs_batch": solver_times}


def other_solvers_phase(counts_fn, stages) -> dict:
    """Phase 6: HALS online and batch, then Itakura-Saito online (bf16
    chain) and batch (amu) on the ELL hybrid; returns the launch counts."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    launches, retries = {}, {}
    runs = [("hals", "frobenius", {"algo": "halsvar"},
             ("online", "dense", "dense", "hals")),
            ("hals_batch", "frobenius", {"algo": "halsvar", "mode": "batch"},
             ("batch", "dense", "dense", "hals")),
            ("is", "itakura-saito", {}, ("online", "ell", "ell-torch", "mu")),
            ("is_batch", "itakura-saito", {"mode": "batch"},
             ("batch", "ell", "ell-torch", "amu"))]
    for name, beta_loss, params, want in runs:
        kl_ell.reset_launches()
        obj = prepared_run(name, counts_fn, OTHER_KS, beta_loss,
                           stages=stages if name == "is" else None, **params)
        stages.run(f"{name} factorize", obj.factorize)
        info = obj.factorize_info
        got = (info["mode"], info["lane"], info["kernel"],
               info["solver_recipe"].split("(")[0])
        check(got == want and not info["packed"],
              f"{name} factorize ran {got}, packed={info['packed']}")
        # IS inherits the JAX solvers' collapse on zero-heavy data (online
        # most of all): an update floors WH at stored counts (objectives
        # near 1e17) or overflows to NaN; a NaN replicate is retried at a
        # derived seed and quarantined when its retries fail too, and
        # consensus keeps every spectrum (threshold 2). A HALS replicate
        # must need no retry.
        lenient = beta_loss == "itakura-saito"
        written = {k: int(info["written"].get(k, 0)) for k in OTHER_KS}
        retries[name] = {"retries": info["retries"],
                         "quarantined": info["quarantined"]}
        log(f"{name}: retries {info['retries']}; quarantined "
            f"{info['quarantined']}")
        check(lenient or (info["retries"] == []
                          and info["quarantined"] == []),
              f"{name}: a replicate went nonfinite: retries "
              f"{info['retries']}, quarantined {info['quarantined']}")
        for k in OTHER_KS:
            check(written[k] == REPLICATES or (lenient and written[k] > 0),
                  f"{name} k={k}: {REPLICATES - written[k]} nonfinite "
                  "objectives")
        collapsed = sum(int((info["errs"][k] > 1e12).sum()) for k in OTHER_KS)
        log(f"{name}: {collapsed} replicates end above 1e12")
        if info["mode"] == "batch":
            rises = batch_rises(info, OTHER_KS, name, strict=not lenient)
        elif not lenient:
            rises = check_online_traces(info, OTHER_KS, name)
        else:
            rises = sum(int((np.diff(t, axis=0) > 0).sum())
                        for k in OTHER_KS for t in info["trace"][k])
            for k in OTHER_KS:
                passes = [t.shape[0] for t in info["trace"][k]]
                log(f"{name} k={k}: passes {passes}, final objective "
                    f"{np.round(info['errs'][k], 1).tolist()}")
        log(f"{name}: objective rises {rises}")
        stages.run(f"{name} combine", lambda: obj.combine(
            skip_missing_files=lenient))
        threshold = 2.0 if lenient else 0.5
        stages.run(f"{name} consensus", lambda: obj.consensus(
            CONSENSUS_K, density_threshold=threshold))
        check_artifacts(obj, None, OTHER_KS, written,
                        dt=str(threshold).replace(".", "_"))
        log(f"{name}: replicates written per K {written}")
        launches[name] = dict(kl_ell.launches)
        check(sum(launches[name].values()) == 0,
              f"the {name} path launched a kernel: {launches[name]}")
    log(f"phase 6 kernel launches: {launches}")
    return launches, retries


# -- phase 7: retries, quarantine and resume, the sequential lane, nndsvd,
#    double and the sketch ---------------------------------------------------

RESUME_KS = [9, 13]
SEQ_KS = [9, 13]
SEQ_REPLICATES = 5
NNDSVD_KS = [5, 9, 13]
SKETCH_KS = [9, 13]
# 7b poisons iter 4 at its first attempt and both retries
QUARANTINE_SPEC = ("nonfinite:k=9,iter=4;nonfinite:k=9,iter=4,attempt=1;"
                   "nonfinite:k=9,iter=4,attempt=2")


@contextlib.contextmanager
def knobs(**env):
    """The env knobs ``env`` set for the block, the old values restored
    after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def iter_bytes(obj, ks, n_iter=REPLICATES) -> dict:
    """Every iter spectra file's values as bytes, by ``(k, iter)``."""
    out = {}
    for k in ks:
        for it in range(n_iter):
            with np.load(obj.paths["iter_spectra"] % (k, it),
                         allow_pickle=True) as f:
                out[(k, it)] = f["data"].tobytes()
    return out


def read_ledger(obj) -> dict:
    with open(obj.paths["resilience_ledger"] % 0) as f:
        return json.load(f)


def ledger_seed(obj, k, it) -> int:
    from cnmf_torch_tpu_torch.utils.io import load_df_from_npz

    led = load_df_from_npz(obj.paths["nmf_replicate_parameters"])
    ks = np.asarray(led.column("n_components"), np.int64)
    its = np.asarray(led.column("iter"), np.int64)
    return int(np.asarray(led.column("nmf_seed"),
                          np.int64)[(ks == k) & (its == it)][0])


def retry_phase(counts_fn, stages) -> dict:
    """7a and 7b: a retried lane, then a quarantined one and the floor."""
    import warnings

    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.runtime import resilience

    out = {}
    # 7a: iter 3 is poisoned at its first attempt and retried once
    obj = prepared_run("retry", counts_fn, [9], "kullback-leibler")
    wave = {}
    real = obj._finish_resilience

    def spy(*a, **kw):
        before = dict(kl_ell.launches)
        try:
            return real(*a, **kw)
        finally:
            wave.update({n: kl_ell.launches[n] - before[n]
                         for n in kl_ell.KERNELS})

    obj._finish_resilience = spy
    kl_ell.reset_launches()
    with knobs(CNMF_TPU_FAULT_SPEC="nonfinite:k=9,iter=3"):
        stages.run("7a retry factorize (k=9)", obj.factorize)
    out["retry_launches"] = dict(kl_ell.launches)
    out["retry_wave_launches"] = wave
    seed = ledger_seed(obj, 9, 3)
    ledger = read_ledger(obj)
    want = [{"k": 9, "iter": 3, "seed": seed, "attempt": 1,
             "derived_seed": (seed ^ 1) & 0x7FFFFFFF, "healthy": True}]
    check(ledger["retries"] == want and ledger["quarantined"] == [],
          f"7a ledger {ledger}")
    check(resilience.probe_spectra_file(obj.paths["iter_spectra"] % (9, 3),
                                        k=9, n_genes=N_HVG) is None,
          "7a: the retried replicate was not written")
    check(obj.factorize_info["written"] == {9: REPLICATES},
          f"7a written {obj.factorize_info['written']}")
    for name in ONLINE_KERNELS:
        check(wave[name] > 0, f"7a: the retry wave launched no {name}")
    out["retry_ledger"] = ledger
    log(f"7a retry: ledger {ledger['retries']}; retry wave launches {wave}")

    # 7b: iter 4 fails all three attempts and is quarantined
    qobj = prepared_run("quarantine", counts_fn, [9], "kullback-leibler")
    kl_ell.reset_launches()
    with knobs(CNMF_TPU_FAULT_SPEC=QUARANTINE_SPEC), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stages.run("7b quarantine factorize (k=9)", qobj.factorize)
    check(any("quarantined" in str(w.message) for w in caught),
          "7b: no quarantine warning")
    ledger = read_ledger(qobj)
    seed = ledger_seed(qobj, 9, 4)
    check([(q["k"], q["iter"], q["seed"], q["attempts"])
           for q in ledger["quarantined"]] == [(9, 4, seed, 2)],
          f"7b quarantine {ledger['quarantined']}")
    check([(r["attempt"], r["derived_seed"], r["healthy"])
           for r in ledger["retries"]]
          == [(1, (seed ^ 1) & 0x7FFFFFFF, False),
              (2, (seed ^ 2) & 0x7FFFFFFF, False)],
          f"7b retries {ledger['retries']}")
    check(not os.path.exists(qobj.paths["iter_spectra"] % (9, 4)),
          "7b: the quarantined replicate was written")
    stages.run("7b combine (no skip flag)", qobj.combine)
    stages.run("7b consensus (k=9, 19 replicates)", lambda: qobj.consensus(
        CONSENSUS_K, density_threshold=0.5))
    check_artifacts(qobj, None, [9], {9: REPLICATES - 1})
    out["quarantine_launches"] = dict(kl_ell.launches)
    out["quarantine_ledger"] = ledger
    log(f"7b quarantine: {ledger['quarantined']}; consensus on "
        f"{REPLICATES - 1} replicates")
    kl_ell.reset_launches()
    raised = None
    with knobs(CNMF_TPU_FAULT_SPEC=QUARANTINE_SPEC,
               CNMF_TPU_MIN_HEALTHY_FRAC="1.0"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        try:
            qobj.factorize()
        except resilience.UnhealthySweepError as exc:
            raised = str(exc)
        torch.cuda.synchronize()
    check(raised is not None, "7b: the healthy-fraction floor did not raise")
    out["floor_launches"] = dict(kl_ell.launches)
    out["floor_error"] = raised
    log(f"7b floor (CNMF_TPU_MIN_HEALTHY_FRAC=1.0) raised in "
        f"{time.perf_counter() - t0:.3f} s: {raised[:160]}")
    return out


def resume_phase(counts_fn, stages) -> dict:
    """7c: a torn iter file, a resume that reruns its K group only, bit for
    bit the run without a fault; then a resume with nothing to do."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.runtime import resilience

    out = {}
    obj = prepared_run("resume", counts_fn, RESUME_KS, "kullback-leibler")
    kl_ell.reset_launches()
    stages.run("7c factorize (no fault)", obj.factorize)
    clean = iter_bytes(obj, RESUME_KS)
    with knobs(CNMF_TPU_FAULT_SPEC="torn:artifact=iter_"):
        stages.run("7c factorize (one file torn)", obj.factorize)
    torn = [key for key in clean if resilience.probe_spectra_file(
        obj.paths["iter_spectra"] % key, k=key[0], n_genes=N_HVG)]
    check(len(torn) == 1, f"7c: torn files {torn}")
    kl_ell.reset_launches()
    stages.run("7c resume", lambda: obj.factorize(skip_completed_runs=True))
    out["resume_launches"] = dict(kl_ell.launches)
    info = obj.factorize_info
    check(info["jobs"] == REPLICATES and sorted(info["trace"]) == [torn[0][0]],
          f"7c: the resume solved {info['jobs']} replicates at K "
          f"{sorted(info['trace'])}, torn {torn}")
    check(iter_bytes(obj, RESUME_KS) == clean,
          "7c: the resumed iter files differ from the run without a fault")
    for name in ONLINE_KERNELS:
        check(out["resume_launches"][name] > 0,
              f"7c: the resume launched no {name}")
    kl_ell.reset_launches()
    stages.run("7c resume (nothing torn)",
               lambda: obj.factorize(skip_completed_runs=True))
    out["noop_launches"] = dict(kl_ell.launches)
    check(obj.factorize_info["jobs"] == 0
          and sum(out["noop_launches"].values()) == 0,
          f"7c: a resume with nothing torn launched {out['noop_launches']}")
    out["torn"] = [list(t) for t in torn]
    log(f"7c resume: torn {torn}, reran K={torn[0][0]} "
        f"({REPLICATES} replicates), {len(clean)} iter files bit for bit "
        "the run without a fault; a resume with nothing torn launched "
        "no kernel")
    return out


def sequential_phase(counts_fn, Xn, stages) -> dict:
    """7d: the sequential lane against the batched lane at the same seeds
    (the same init), under strict f32 (gated at ``rtol 1e-4``) and under
    the default bf16 ratio chain (logged), and against the batched lane at
    one replicate a batch (logged): a lane's reductions batched over 5
    replicates round otherwise than over 1, and a bf16 rounding can turn
    that last-bit difference into a relative 2**-8 in one ratio. Also
    logs how far the init scale that both lanes take (the f32 sum of the
    staged encoding on the card) lies from the host mean that the JAX
    package's sequential lane takes."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.nmf import sweep_x_mean
    from cnmf_torch_tpu_torch.ops.sparse import ell_chunk_rows

    n, g = Xn.shape
    host = float(Xn.sum()) / (n * g)
    staged = sweep_x_mean(ell_chunk_rows(Xn, CHUNK)[0].to(CARD), n, g)
    out = {"launches": {}, "init_scale": {
        "host_mean": host, "staged_sum": staged,
        "rel_gap": abs(staged - host) / host}}
    log(f"7d init scale: host mean {host!r}, the staged encoding's f32 sum "
        f"{staged!r}, relative gap {out['init_scale']['rel_gap']:.3g}")
    obj = prepared_run("sequential", counts_fn, SEQ_KS, "kullback-leibler",
                       n_iter=SEQ_REPLICATES)
    errs = {}
    for chain, env in (("f32", {"CNMF_TPU_BF16_RATIO": "0"}),
                       ("bf16", {})):
        with knobs(**env):
            kl_ell.reset_launches()
            stages.run(f"7d sequential factorize, {chain} (2 Ks x 5)",
                       lambda: obj.factorize(batched=False))
            launches = dict(kl_ell.launches)
            for name in ONLINE_KERNELS:
                check(launches[name] > 0, f"7d {chain}: the sequential "
                      f"lane launched no {name}")
                out["launches"][name] = (out["launches"].get(name, 0)
                                         + launches[name])
            with open(obj.paths["factorize_provenance"] % 0) as f:
                prov = json.load(f)
            info = obj.factorize_info
            check(prov["engaged_path"] == "sequential"
                  and info["kernel"] == "ell-cuda"
                  and info["bf16_ratio"] == (chain == "bf16"),
                  f"7d {chain}: provenance {prov['engaged_path']}, kernel "
                  f"{info['kernel']}, bf16 {info['bf16_ratio']}")
            errs[chain, "sequential"] = info["errs"]
            stages.run(f"7d batched factorize, {chain} (2 Ks x 5)",
                       obj.factorize)
            errs[chain, "batched"] = obj.factorize_info["errs"]
            stages.run(f"7d batched factorize, {chain}, 1 replicate a "
                       "batch", lambda: obj.factorize(replicates_per_batch=1))
            errs[chain, "batched_r1"] = obj.factorize_info["errs"]
    gaps, equal = {}, {}
    for chain in ("f32", "bf16"):
        seq = errs[chain, "sequential"]
        for lane in ("batched", "batched_r1"):
            other = errs[chain, lane]
            gaps[f"{chain} vs {lane}"] = {k: float(np.max(
                np.abs(np.asarray(seq[k], np.float64) - other[k])
                / np.abs(np.asarray(other[k], np.float64))))
                for k in SEQ_KS}
            equal[f"{chain} vs {lane}"] = all(np.array_equal(
                np.asarray(seq[k], np.float32),
                np.asarray(other[k], np.float32)) for k in SEQ_KS)
    check(max(gaps["f32 vs batched"].values()) <= 1e-4,
          f"7d: under strict f32 the sequential and batched objectives "
          f"differ by {gaps['f32 vs batched']}")
    out.update(max_rel_gap=gaps, bit_equal=equal,
               objectives={f"{c} {lane}": {k: np.asarray(v[k]).tolist()
                                           for k in SEQ_KS}
                           for (c, lane), v in errs.items()})
    for key in gaps:
        log(f"7d sequential lane {key}: per K the largest relative "
            f"objective gap {gaps[key]}; bit-equal: {equal[key]}")
    return out


def nndsvd_phase(counts_fn, Xn, stages) -> dict:
    """7e: a dense Frobenius batch factorize from ``init="nndsvd"``, the
    same with the random init, and the SVD's wall."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    out = {}
    runs = {}
    for init in ("nndsvd", "random"):
        obj = prepared_run(f"init_{init}", counts_fn, NNDSVD_KS,
                           mode="batch", init=init)
        kl_ell.reset_launches()
        stages.run(f"7e factorize init={init} (3 Ks x 20, batch)",
                   obj.factorize)
        check(sum(kl_ell.launches.values()) == 0,
              f"7e: the dense lane launched {kl_ell.launches}")
        runs[init] = {k: np.asarray(v, np.float64)
                      for k, v in obj.factorize_info["errs"].items()}
        if init == "nndsvd":
            spectra = iter_bytes(obj, NNDSVD_KS)
    for k in NNDSVD_KS:
        e = runs["nndsvd"][k]
        distinct = len({spectra[(k, it)] for it in range(REPLICATES)})
        check(np.isfinite(e).all() and distinct == REPLICATES,
              f"7e k={k}: {distinct} distinct nndsvd replicates, "
              f"objectives {e}")
    X = nmf.dense_on_device(Xn, CARD)
    svd = {}
    for k in NNDSVD_KS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nmf.nndsvd_base(X, k)
        torch.cuda.synchronize()
        svd[k] = time.perf_counter() - t0
    del X
    out["svd_s"] = svd
    out["objective"] = {k: {"nndsvd_median": float(np.median(
        runs["nndsvd"][k])), "random_median": float(np.median(
            runs["random"][k]))} for k in NNDSVD_KS}
    log(f"7e nndsvd: torch.linalg.svd base of the 10,000 x 2,000 HVG "
        f"matrix {', '.join(f'k={k} {t:.3f} s' for k, t in svd.items())}; "
        "median objective nndsvd / random: " + ", ".join(
            f"k={k} {v['nndsvd_median']:.6g} / {v['random_median']:.6g}"
            for k, v in out["objective"].items()))
    return out


def double_phase(Xn, stages) -> dict:
    """7f: ``run_nmf(fp_precision="double")`` at k=9, one replicate per
    loss, against the f32 solve (plain MU) from the same seed."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.nmf import run_nmf
    from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe

    out = {}
    for loss in ("frobenius", "kullback-leibler"):
        kl_ell.reset_launches()
        H, W, e64 = stages.run(f"7f run_nmf double ({loss}, k=9)",
                               lambda: run_nmf(
                                   Xn, 9, beta_loss=loss, mode="batch",
                                   fp_precision="double",
                                   random_state=SEED, device=CARD))
        wall64 = stages.rows[-1][1]
        check(H.dtype == np.float64 and W.dtype == np.float64
              and sum(kl_ell.launches.values()) == 0,
              f"7f {loss}: outputs {H.dtype}/{W.dtype}, launches "
              f"{kl_ell.launches}")
        _, _, e32 = stages.run(f"7f run_nmf float ({loss}, k=9, mu)",
                               lambda: run_nmf(
                                   Xn, 9, beta_loss=loss, mode="batch",
                                   random_state=SEED, recipe=SolverRecipe(),
                                   device=CARD))
        wall32 = stages.rows[-1][1]
        rel = abs(e64 - e32) / abs(e64)
        check(np.isfinite(e64) and rel < 1e-3,
              f"7f {loss}: f64 objective {e64} vs f32 {e32} ({rel:.3g})")
        out[loss] = {"f64_s": wall64, "f32_s": wall32, "objective_f64": e64,
                     "objective_f32": e32, "rel_gap": rel}
        log(f"7f {loss}: f64 {wall64:.3f} s, objective {e64:.9g}; f32 "
            f"{wall32:.3f} s, objective {e32:.9g}; relative gap {rel:.3g}")
    return out


def sketch_phase(counts_fn, stages) -> dict:
    """7g: the sketch recipe, batch and online, against plain MU from the
    same inits; two runs bit-identical; consensus with the sketch."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    out = {}
    sketch_obj = None
    for mode in ("batch", "online"):
        obj = prepared_run(f"sketch_{mode}", counts_fn, SKETCH_KS,
                           "kullback-leibler", mode=mode)
        errs, files = [], []
        with knobs(CNMF_TPU_SKETCH="1"):
            for rep in range(2):
                kl_ell.reset_launches()
                stages.run(f"7g sketch {mode} factorize #{rep + 1}",
                           obj.factorize)
                launches = dict(kl_ell.launches)
                errs.append(obj.factorize_info["errs"])
                files.append(iter_bytes(obj, SKETCH_KS))
        info = obj.factorize_info
        check(info["solver_recipe"].startswith("sketch(")
              and info["kernel"] == "ell-cuda",
              f"7g {mode}: recipe {info['solver_recipe']}, kernel "
              f"{info['kernel']}")
        for name in ONLINE_KERNELS:
            check(launches[name] > 0, f"7g {mode}: no {name} launched")
        check(files[0] == files[1], f"7g {mode}: two runs differ")
        # the mu recipe as factorize runs it with the sketch off (online:
        # its default bf16 ratio chain), and strict f32, as the sketch
        # lane runs; the same seeds give the same inits
        mu_errs = {}
        for label, env in (("mu", {"CNMF_TPU_ACCEL": "0"}),
                           ("mu_f32", {"CNMF_TPU_ACCEL": "0",
                                       "CNMF_TPU_BF16_RATIO": "0"})):
            if mode == "batch" and label == "mu_f32":
                continue        # the batch solver is strict f32 already
            mobj = prepared_run(f"{label}_{mode}", counts_fn, SKETCH_KS,
                                "kullback-leibler", mode=mode)
            with knobs(**env):
                stages.run(f"7g {label} {mode} factorize", mobj.factorize)
            check(mobj.factorize_info["solver_recipe"] == "mu",
                  f"7g: the reference ran "
                  f"{mobj.factorize_info['solver_recipe']}")
            mu_errs[label] = mobj.factorize_info["errs"]
        gaps = {label: {k: float(np.max(
            np.abs(np.asarray(errs[0][k], np.float64) - np.asarray(e[k]))
            / np.asarray(e[k], np.float64))) for k in SKETCH_KS}
            for label, e in mu_errs.items()}
        check(max(gaps["mu"].values()) < 0.05,
              f"7g {mode}: sketch vs mu objectives differ by {gaps}")
        out[mode] = {"recipe": info["solver_recipe"], "launches": launches,
                     "max_rel_gap": gaps, "bit_identical": True,
                     "objective_median": {k: float(np.median(errs[0][k]))
                                          for k in SKETCH_KS}}
        log(f"7g sketch {mode}: recipe {info['solver_recipe']}, launches "
            f"{launches}, two runs bit-identical, largest relative "
            f"objective gap to the mu recipe {gaps}")
        if mode == "batch":
            sketch_obj = obj
    with knobs(CNMF_TPU_SKETCH="1"):
        stages.run("7g combine", sketch_obj.combine)
        stages.run("7g consensus (k=9, sketched)",
                   lambda: sketch_obj.consensus(CONSENSUS_K,
                                                density_threshold=0.5))
        rec = dict(sketch_obj.consensus_info[CONSENSUS_K])
        stages.run("7g k_selection (sketched)",
                   sketch_obj.k_selection_stats)
    check(rec["stage"] == "consensus" and rec["sketch"]
          and rec["sketch_dim"] == 256
          and rec["distance_width"] == 256,
          f"7g consensus decision {rec}")
    check(sketch_obj.consensus_info["k_selection"]["sketch"],
          f"7g k-selection decision "
          f"{sketch_obj.consensus_info['k_selection']}")
    check_artifacts(sketch_obj, None, SKETCH_KS)
    out["consensus"] = dict(sketch_obj.consensus_info, consensus_stage=rec)
    log(f"7g consensus decision {rec}; k-selection decisions "
        f"{sketch_obj.consensus_info}")
    return out


def phase7(counts_fn, Xn, stages) -> dict:
    """Phase 7, each sub-phase with the launch counts set to 0 just before
    its runs and read just after."""
    out = {"retry": retry_phase(counts_fn, stages)}
    out["resume"] = resume_phase(counts_fn, stages)
    out["sequential"] = sequential_phase(counts_fn, Xn, stages)
    out["nndsvd"] = nndsvd_phase(counts_fn, Xn, stages)
    out["double"] = double_phase(Xn, stages)
    out["sketch"] = sketch_phase(counts_fn, stages)
    return out


def phase7_launches(p7) -> dict:
    """The kernel launches of phase 7's paths, summed."""
    parts = [p7["retry"][key] for key in ("retry_launches",
                                          "quarantine_launches",
                                          "floor_launches")]
    parts += [p7["resume"]["resume_launches"],
              p7["sequential"]["launches"]]
    parts += [p7["sketch"][m]["launches"] for m in ("batch", "online")]
    return {name: sum(int(p.get(name, 0)) for p in parts)
            for name in parts[0]}


# -- phase 8: the telemetry base on the main path ---------------------------

TELEMETRY_KNOBS = {"CNMF_TPU_TELEMETRY": "1", "CNMF_TPU_METRICS": "1",
                   "CNMF_TPU_TRACE_SAMPLE": "1"}
# a stage event's host wall against this script's synchronized wall of the
# same call: within WALL_RTOL of it plus WALL_ATOL seconds
WALL_RTOL, WALL_ATOL = 0.10, 0.050
# phase 3's stage names -> the pipeline's stage events
PIPELINE_STAGES = {"prepare": "prepare", "factorize": "factorize",
                   "combine": "combine", "consensus": "consensus",
                   "k_selection": "k_selection_plot"}


def artifact_arrays(obj, ks=KS, n_iter=REPLICATES, dt="0_5") -> dict:
    """The stored arrays of every iter spectra file and consensus artifact
    of a run, its K-selection statistics and prepare's f64 TPM moments
    (and the consensus text files' bytes), by artifact name; the
    ``.npz`` zip container also holds its write time, so the arrays are
    what two runs can share byte for byte."""
    out = {}

    def arrays(path):
        with np.load(path, allow_pickle=True) as f:
            return tuple(np.asarray(f[key]).tobytes() for key in f.files)

    for k in ks:
        for it in range(n_iter):
            out[f"iter_spectra k={k} iter={it}"] = arrays(
                obj.paths["iter_spectra"] % (k, it))
    for key in ("consensus_spectra", "consensus_usages", "gene_spectra_tpm",
                "gene_spectra_score", "starcat_spectra"):
        out[key] = arrays(obj.paths[key] % (CONSENSUS_K, dt))
        with open(obj.paths[key + "__txt"] % (CONSENSUS_K, dt), "rb") as f:
            out[key + "__txt"] = f.read()
    out["k_selection_stats"] = arrays(obj.paths["k_selection_stats"])
    out["tpm_stats"] = arrays(obj.paths["tpm_stats"])
    return out


def cli_text(argv) -> str:
    """What the port's CLI prints for ``argv``."""
    import io

    from cnmf_torch_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def telemetry_phase(counts_fn, stages, ref, ref_launches) -> dict:
    """Phase 8: phase 3's main path again in a run of its own, with
    ``CNMF_TPU_TELEMETRY``, ``CNMF_TPU_METRICS`` and
    ``CNMF_TPU_TRACE_SAMPLE`` on and the launch counts set to 0 just
    before; ``ref`` is phase 3's run and ``ref_launches`` its launches.
    Then one factorize at K=9 under ``CNMF_TPU_PROFILE_DIR``."""
    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.utils import telemetry

    name = "telemetry"
    run_dir = os.path.join(OUT, name)
    obj = cNMF(OUT, name, device=CARD)
    first = len(stages.rows)
    with knobs(**TELEMETRY_KNOBS):
        kl_ell.reset_launches()
        stages.run(f"{name} prepare", lambda: obj.prepare(
            counts_fn, components=KS, n_iter=REPLICATES, seed=SEED,
            beta_loss="kullback-leibler", num_highvar_genes=N_HVG,
            batch_size=CHUNK))
        stages.run(f"{name} factorize", obj.factorize)
        stages.run(f"{name} combine", obj.combine)
        stages.run(f"{name} consensus", lambda: obj.consensus(
            CONSENSUS_K, density_threshold=0.5))
        stats = stages.run(f"{name} k_selection", obj.k_selection_plot)
        launches = dict(kl_ell.launches)
    log(f"phase 8 kernel launches {launches}; phase 3's {ref_launches}")
    check(launches == ref_launches,
          f"telemetry changed the launches: {launches} != {ref_launches}")
    check_artifacts(obj, stats)

    events_fn = os.path.join(run_dir, "cnmf_tmp", name + ".events.jsonl")
    n_events = telemetry.validate_events_file(events_fn)
    size = os.path.getsize(events_fn)
    events = telemetry.read_events(events_fn)
    check(events[0]["t"] == "manifest", "the manifest is not first")
    man = events[0]
    check(man["backend"] == "cuda"
          and man["devices"][0]["kind"] == torch.cuda.get_device_name(0),
          f"manifest backend/devices {man['backend']} {man['devices']}")
    reps = [e for e in events if e["t"] == "replicates"]
    check(sorted(int(e["k"]) for e in reps) == KS,
          f"replicates events for K {[e['k'] for e in reps]}")
    for e in reps:
        recs = e["records"]
        check(len(recs) == REPLICATES, f"k={e['k']}: {len(recs)} records")
        check(e["kernel"] == "ell-cuda", f"k={e['k']} kernel {e['kernel']}")
        check(all(r["trace"] and np.isfinite(r["trace"]).all()
                  and len(r["trace"]) == r["iters"] for r in recs),
              f"k={e['k']}: a trace is empty, nonfinite or not one a pass")
    mem = [e for e in events if e["t"] == "memory"]
    check([e["stage"] for e in mem] == list(PIPELINE_STAGES.values()),
          f"memory events at {[e['stage'] for e in mem]}")
    peaks = {e["stage"]: max(d.get("peak_bytes_in_use", 0)
                             for d in e["devices"]) for e in mem}
    check(all(v > 0 for v in peaks.values()), f"memory peaks {peaks}")
    check(any(e["t"] == "span" and e["name"] == "factorize.worker"
              for e in events), "no factorize.worker span")
    check(any(e["t"] == "metrics_snapshot" for e in events),
          "no metrics snapshot")

    # each stage event's wall against this script's synchronized wall
    ev_walls = {e["stage"]: float(e["wall_s"]) for e in events
                if e["t"] == "stage" and e["stage"] in peaks}
    smoke_walls = {row[0].split(" ", 1)[1]: row[1]
                   for row in stages.rows[first:]}
    walls = {}
    for smoke_name, stage in PIPELINE_STAGES.items():
        ev, sm = ev_walls[stage], smoke_walls[smoke_name]
        walls[stage] = {"event_s": ev, "synchronized_s": sm,
                        "peak_bytes": peaks[stage]}
        log(f"stage {stage}: event wall {ev:.4f} s, synchronized wall "
            f"{sm:.4f} s, peak {peaks[stage] / 2 ** 30:.3f} GiB")
        check(abs(ev - sm) <= WALL_RTOL * sm + WALL_ATOL,
              f"stage {stage}: event wall {ev:.4f} s vs synchronized "
              f"{sm:.4f} s")

    report = cli_text(["report", run_dir])
    for needle in ("Manifest", "Dispatch decisions", "Stage waterfall",
                   "Replicate convergence", "Trace spans", "Device memory",
                   "consensus.kmeans"):
        check(needle in report, f"report lacks {needle!r}")
    traces = cli_text(["trace", run_dir])
    check("factorize.worker" in traces, "trace renders no factorize span")
    with open(os.path.join(OUT, "phase8_report.txt"), "w") as f:
        f.write(report + "\n" + traces)

    mine, theirs = artifact_arrays(obj), artifact_arrays(ref)
    differ = sorted(key for key in theirs if mine.get(key) != theirs[key])
    check(not differ, f"artifacts differ from phase 3's: {differ[:6]}")
    log(f"phase 8: {len(theirs)} artifacts byte-identical to phase 3's")

    # the same factorize with the telemetry knobs off and on, in turns:
    # six pairs, each side first in three
    turns = {"off": [], "on": []}
    for state in ("off", "on", "on", "off") * 3:
        env = {key: ("1" if state == "on" else "0")
               for key in TELEMETRY_KNOBS}
        with knobs(**env):
            stages.run(f"factorize telemetry {state}", obj.factorize)
        turns[state].append(stages.rows[-1][1])
    log(f"phase 8: factorize with the telemetry knobs off {turns['off']} "
        f"s, on {turns['on']} s (turns off, on, on, off, three times); "
        f"medians off {statistics.median(turns['off']):.4f} s, on "
        f"{statistics.median(turns['on']):.4f} s")

    # one factorize at K=9 under CNMF_TPU_PROFILE_DIR
    prof_dir = os.path.join(OUT, "profile_dir")
    pobj = prepared_run("telemetry_profiled", counts_fn, [CONSENSUS_K],
                        "kullback-leibler")
    kl_ell.reset_launches()
    with knobs(CNMF_TPU_PROFILE_DIR=prof_dir):
        stages.run("profiled factorize k=9", pobj.factorize)
    prof_launches = dict(kl_ell.launches)
    (trace_name,) = os.listdir(os.path.join(prof_dir, "factorize"))
    trace_fn = os.path.join(prof_dir, "factorize", trace_name)
    with open(trace_fn) as f:
        names = set(re.findall(r'"name": "([^"]*_kernel[^"]*)"', f.read()))
    named = sorted(n for n in names
                   if "h_stats" in n or "w_numer" in n or "beta_err" in n)
    check(any("h_stats_kernel" in n for n in named),
          f"the profile dir's trace names no h_stats_kernel: {named[:4]}")
    log(f"profile dir trace {os.path.getsize(trace_fn)} bytes names "
        f"{len(named)} of our kernel instances")

    ref_fact = next(w for s, w, _ in stages.rows if s == "factorize")
    on_fact = walls["factorize"]["synchronized_s"]
    log(f"phase 8: telemetry-on factorize {on_fact:.3f} s against phase "
        f"3's {ref_fact:.3f} s; events file {size} bytes, {n_events} "
        "events")
    return {"launches": launches, "profiled_launches": prof_launches,
            "walls": walls, "factorize_on_s": on_fact,
            "factorize_off_s": ref_fact, "factorize_turns_s": turns,
            "events_bytes": size,
            "events": n_events, "trace_bytes": os.path.getsize(trace_fn),
            "kernel_names": named}


class Stages:
    """Wall time (host clock after a synchronize) and peak device memory of
    each pipeline stage."""

    def __init__(self):
        self.rows = []

    def run(self, name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        self.rows.append((name, wall, peak))
        log(f"stage {name}: {wall:.3f} s, peak device memory {peak:.3f} GiB")
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.recipe import auto_sketch_rows
    from cnmf_torch_tpu_torch.ops.sparse import csr_to_ell, ell_chunk_rows

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"python {sys.version.split()[0]}")
    log(f"card: {smi}; devices visible: {torch.cuda.device_count()}")

    # -- phase 1: build --------------------------------------------------
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    kl_ell.build()
    log(f"built {SOURCE} in {kl_ell.build_info['seconds']:.2f} s: "
        f"{kl_ell.build_info['command']}")
    ptxas = ptxas_summary(kl_ell.build_info["log"])
    for line in ptxas:
        log(line)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        f.write(kl_ell.build_info["log"])

    # -- data: the pipeline's counts --------------------------------------
    counts_fn, Xn = prepared_counts(OUT)

    # -- phase 2: kernels at the main path's shapes -----------------------
    xc, _ = ell_chunk_rows(Xn, CHUNK)
    x0 = xc.chunk(0).to(CARD)
    nnz = int((x0.vals > 0).sum())
    log(f"normalized counts {Xn.shape}: density "
        f"{Xn.nnz / (Xn.shape[0] * Xn.shape[1]):.4f}, ELL width {xc.width}, "
        f"per-chunk transpose width {xc.t_width}, chunk-0 nonzeros {nnz}")
    rows = []
    records = kernel_phase(x0, nnz, rows)
    h_stats_by_k = h_stats_k_sweep(x0, nnz, rows)
    # the sketch recipe's rows: m = n / 8 of the whole matrix, at most a
    # chunk; its first sketched online step is pass 1's chunk 0, its first
    # sketched batch step iteration 1
    m_sketch = auto_sketch_rows(Xn.shape[0])
    n_chunks = xc.vals.shape[0]
    sketch_rows = {"online": sketch_rows_check(
        x0, min(m_sketch, CHUNK), n_chunks, 1, rows)}
    del x0, xc
    xb = csr_to_ell(Xn).to(CARD)
    nnz_b = int((xb.vals > 0).sum())
    log(f"batch shapes: the whole matrix, ELL width {xb.width}, transpose "
        f"width {xb.t_width}, nonzeros {nnz_b}")
    batch_records, batch_extra = batch_kernel_phase(xb, nnz_b, rows)
    sketch_rows["batch"] = sketch_rows_check(xb, m_sketch, 1, 0, rows)
    records.update(batch_records)
    del xb
    torch.cuda.empty_cache()
    edge_sweep(rows)
    small_solve_check(rows)
    log("kernels (median of CUDA-event timed launches, L2-warm inputs):")
    for line in rows:
        log(line)

    # -- phase 3: the main path --------------------------------------------
    stages = Stages()
    obj = cNMF(OUT, "pipeline", device=CARD)
    kl_ell.reset_launches()
    stages.run("prepare", lambda: obj.prepare(
        counts_fn, components=KS, n_iter=REPLICATES, seed=SEED,
        beta_loss="kullback-leibler", num_highvar_genes=N_HVG,
        batch_size=CHUNK))
    stages.run("factorize", obj.factorize)
    after_factorize = dict(kl_ell.launches)
    stages.run("combine", obj.combine)
    stages.run("consensus", lambda: obj.consensus(CONSENSUS_K,
                                                  density_threshold=0.5))
    after_consensus = dict(kl_ell.launches)
    stats = stages.run("k_selection", obj.k_selection_stats)
    launches = dict(kl_ell.launches)
    log(f"kernel launches: after factorize {after_factorize}; after "
        f"consensus {after_consensus}; whole path {launches}")

    info = obj.factorize_info
    check(info["lane"] == "ell", f"factorize lane {info['lane']}")
    check(info["kernel"] == "ell-cuda", f"kernel label {info['kernel']}")
    check(info["solver_recipe"] == "mu",
          f"online recipe {info['solver_recipe']}")
    for name in ONLINE_KERNELS:
        check(after_factorize[name] > 0, f"{name} never launched")
    for name in BATCH_KERNELS:
        check(launches[name] == 0, f"the online path launched {name}")
    check(after_consensus["h_stats"] > after_factorize["h_stats"],
          "the consensus refit launched no h_stats")
    # from the second pass on (the first solves against the random init
    # and is no bound, in the JAX solver too)
    rises = check_online_traces(info, KS, "kl", first=1)
    log(f"pass-to-pass objective rises after the second pass: {rises}")
    check_artifacts(obj, stats)
    prof_rows = []
    profile = {"online": profile_window(
        f"online sweep, k=13, {REPLICATES} replicates",
        sweep_at_13(Xn, "online"), prof_rows)}
    log("device-time profile (after the online path; its launches are not "
        "counted):")
    for line in prof_rows:
        log(line)

    # -- phase 4: the batch path -------------------------------------------
    # prepare writes mode "online"; a user asks for the batch solver by
    # editing the run-parameters file
    bobj = prepared_run("batch", counts_fn, KS, "kullback-leibler",
                        mode="batch")
    kl_ell.reset_launches()
    stages.run("batch factorize", bobj.factorize)
    b_factorize = dict(kl_ell.launches)
    stages.run("batch combine", bobj.combine)
    stages.run("batch consensus", lambda: bobj.consensus(
        CONSENSUS_K, density_threshold=0.5))
    b_stats = stages.run("batch k_selection", bobj.k_selection_stats)
    b_launches = dict(kl_ell.launches)
    log(f"batch kernel launches: after factorize {b_factorize}; whole "
        f"path {b_launches}")
    binfo = bobj.factorize_info
    check((binfo["mode"], binfo["lane"], binfo["solver_recipe"],
           binfo["kernel"]) == ("batch", "ell", "dna", "ell-cuda"),
          f"batch factorize ran {binfo['mode']}/{binfo['lane']}/"
          f"{binfo['solver_recipe']}/{binfo['kernel']}")
    for name in BATCH_KERNELS + ("w_numer", "beta_err_partials"):
        check(b_factorize[name] > 0, f"batch path: {name} never launched")
    check(b_factorize["wh_at_nz"] == 2 * b_factorize["h_newton_stats"],
          "batch factorize: wh_at_nz launches "
          f"{b_factorize['wh_at_nz']} != 2 x h_newton_stats "
          f"{b_factorize['h_newton_stats']}")
    batch_rises(binfo, KS, "kl batch")
    for k in KS:
        fb = binfo["dna_fallback"][k]
        check(((fb > 0) & (fb < 1)).all(),
              f"batch k={k}: fallback fraction outside (0, 1): {fb}")
        log(f"kl batch k={k}: fallback fraction {float(fb.min()):.4f}-"
            f"{float(fb.max()):.4f}")
    check_artifacts(bobj, b_stats)
    prof_rows = []
    profile["batch"] = profile_window(
        f"batch dna sweep, k=13, {REPLICATES} replicates",
        sweep_at_13(Xn, "batch"), prof_rows)
    log("device-time profile (after the batch path; its launches are not "
        "counted):")
    for line in prof_rows:
        log(line)

    # -- phase 5: the default loss (dense lane, plain torch) ---------------
    n_stages = len(stages.rows)
    prof_rows = []
    frob = frobenius_phase(counts_fn, Xn, stages, prof_rows)
    profile.update(frob["profile"])
    log("device-time profile (after the default-loss paths; no kernel of "
        "ours runs there):")
    for line in prof_rows:
        log(line)

    # -- phase 6: HALS and Itakura-Saito ------------------------------------
    other, other_retries = other_solvers_phase(counts_fn, stages)
    log(f"phases 5-6 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:32s} {wall:8.3f} s  peak {peak:7.3f} GiB")

    # -- phase 7: retries, quarantine, resume, sequential, nndsvd, double,
    #    sketch -------------------------------------------------------------
    n_stages = len(stages.rows)
    p7 = phase7(counts_fn, Xn, stages)
    p7_launches = phase7_launches(p7)
    log(f"phase 7 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:40s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log(f"phase 7 kernel launches: {p7_launches}")

    # -- phase 8: the telemetry base on the main path ----------------------
    n_stages = len(stages.rows)
    p8 = telemetry_phase(counts_fn, stages, obj, launches)
    log(f"phase 8 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:40s} {wall:8.3f} s  peak {peak:7.3f} GiB")

    out = []
    for name in kl_ell.KERNELS:
        rec = dict(records[name])
        rec["launches"] = (int(launches[name]) + int(b_launches[name])
                           + int(p7_launches[name])
                           + int(p8["launches"][name])
                           + int(p8["profiled_launches"][name]))
        out.append(rec)
    report = {"kernels": out, "batch_shape_kernels": batch_extra,
              "launches": {"online": launches, "batch": b_launches,
                           "batch_factorize": b_factorize,
                           "frobenius": frob["launches"],
                           "other_solvers": other, "phase7": p7_launches,
                           "phase8": p8["launches"],
                           "phase8_profiled": p8["profiled_launches"]},
              "phase6_retries": other_retries, "phase7": p7, "phase8": p8,
              "bundles": frob["bundles"],
              "bundle_vs_batch": frob["bundle_vs_batch"],
              "stages": [{"stage": s, "seconds": w, "peak_gib": p}
                         for s, w, p in stages.rows],
              "h_stats_by_k": h_stats_by_k,
              "sketch_rows_check": sketch_rows,
              "profile": profile, "card": smi, "ptxas": ptxas,
              "seconds": time.perf_counter() - t_start}
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
