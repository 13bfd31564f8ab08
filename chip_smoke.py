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
   gaps under the bf16 chain are logged; (e) a dense Frobenius batch factorize
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
   ``CNMF_TPU_METRICS``, ``CNMF_TPU_TRACE_SAMPLE`` and
   ``CNMF_TPU_PERF_MODEL`` on, K-selection through ``k_selection_plot``,
   the launch counts set to 0 just before.
   It checks that the events file passes ``validate_events_file`` with
   the manifest first (backend ``cuda``, the card's name); one
   ``replicates`` event a K with 20 records of finite traces, one value a
   pass, and the ``ell-cuda`` kernel label; one ``factorize``
   ``perf_model`` event on ``ell-cuda`` priced against the card's
   data-sheet peaks, its ``mfu`` and ``bw_frac`` in (0, 1.05]; ``memory``
   events after the five stages with a peak above 0; the worker span and
   a metrics snapshot; that ``report`` (with its Roofline section) and
   ``trace`` render the run; that every
   kernel launched as often as in phase 3; that every iter spectra file,
   consensus artifact, the K-selection statistics and prepare's f64 TPM
   moments hold phase 3's stored arrays byte for byte (and the text
   files phase 3's bytes); and
   that each stage event's wall is within 10% + 50 ms of this script's
   synchronized wall of the same call. Then the same factorize with the
   knobs off and on in turns (off, on, on, off; logged, no gate), and
   one factorize at K=9 under
   ``CNMF_TPU_PROFILE_DIR``, whose Chrome trace must name
   ``h_stats_kernel``. It logs the telemetry-on factorize wall against
   phase 3's, the events file's bytes and the stage walls.

9. The atlas path (``parallel/rowshard.py``, the shard store, the
   staging stream, pass checkpoints). (a) 250,000 cells x 3,000 genes of
   the same low-rank Poisson model at ~300 UMI a cell (Poisson draws on
   the card in row blocks, written as the dense ``.df.npz``), prepare
   (KL, 2,000 HVGs: 6.7% nonzeros, the ELL lane), factorize with no
   row-shard argument (the 200,000-cell threshold engages the row-sharded
   solver: dense KL staged once, no kernel), K in {9, 13} x 4 replicates,
   combine, consensus (k=9, threshold 2.0) and ``k_selection_plot``
   under ``CNMF_TPU_TELEMETRY`` and ``CNMF_TPU_PERF_MODEL``. It checks
   the ``solver_recipe`` event's mode ``rowshard``, one
   ``factorize_rowshard`` ``perf_model`` event on the dense lane under the
   phase-8 bounds, that factorize launched no kernel and the consensus
   refit ``h_stats``, and that no objective rose past 1e-6 from pass to
   pass. Then the same run with ``CNMF_TPU_OOC=1`` (the store written, the
   matrix file skipped) and ``CNMF_TPU_CKPT_EVERY_PASSES=1``: every iter
   spectra file byte for byte the first run's, the streamed consensus
   within ``1e-5`` and K-selection errors within ``1e-8`` of the resident
   ones, the streamed host residency under the budget. (b)
   ``nmf_fit_rowsharded`` on 1,000,000 x 2,000 CSR (built on the card in
   blocks of 50,000 rows, 6.9% nonzeros): the entry's CSR dispatch stages
   it as ELL (its ``rowshard_staging`` stream's host time and bytes
   printed, and the staged encoding kept for the kernel timings below),
   and ``h_stats``, ``w_numer`` and
   ``beta_err_partials`` launch (counts printed); the three kernels at
   R=1 on the first 250,000 rows
   against their plain versions (``rtol 2e-5``, two launches
   bit-identical) and timed beside their bounds at 250,000 and 1,000,000
   rows (``t_w`` and the encoding's bytes printed); a 250,000-row solve
   under a pinned ``dna`` recipe launches ``h_newton_stats`` and
   ``wh_at_nz``. (c) On (a)'s store: the slab-looped tier
   (``CNMF_TPU_OOC_SHARD_BYTES`` 256 MiB) and the resident solve from the
   same init to convergence, the slab loop within ``2e-5`` of a plain
   group loop and within ``5e-3`` of the resident solve's refit objective,
   its host residency under the budget; a CLI factorize SIGKILLed after its fourth pass checkpoint
   (``kill:stage=pass``), resumed with ``--skip-completed-runs`` from
   pass 4 to the uninterrupted bytes; a torn checkpoint
   (``torn:artifact=ckpt``) discarded and its replicate restarted to the
   same bytes; a torn slab read (``shard_read``) detected, re-read and
   staged bit for bit.
10. The remote object store: ``utils/netstore.py``'s server in this
    process on ``127.0.0.1`` (a loopback that cannot bind fails the
    phase). (a) 9a's counts prepared with ``CNMF_TPU_OOC=1`` into
    ``http://127.0.0.1:<port>/atlas`` at K=9 with 9a's four replicates,
    factorized through it (the row-sharded solver, staged over HTTP
    through the read-through cache), combined, and brought to consensus
    (k=9, threshold 2.0) twice: on the matrix read back through the store
    (the resident refit, which launches ``h_stats``; the launch counts set
    to 0 before factorize and read after this consensus), then as a store-only run
    takes it, streamed through the store (dense, no kernel). It checks that
    the store lives only at the endpoint, every iter spectra file byte for
    byte 9a's store-backed run's, the resident consensus artifacts within
    ``1e-5`` of 9a's in-memory run's and the streamed ones within ``1e-5``
    of 9a's streamed run's, the staging ``stream`` event's remote counters
    and bytes, the ``consensus_stream`` event's (every slab read a cache
    hit), and the cache's entries and bytes. (b) On a store of phase
    3's normalized counts in 2,000-row slabs: ``netflake``, ``netslow``
    with the hedge at 0.1 s, ``nettorn``, and ``netdown`` against a warm
    cache each stage bit for bit the clean matrix, with their ``store_net``
    (or torn-read) events and counters, and ``report`` prints the
    ``store_net`` recovered and degraded counts. (c) With 10a's cache
    removed and slab reads down, factorize ends with ``RemoteStoreError``
    and the resilience ledger records ``remote_store``. It prints the
    phase's walls beside the card's name and power limit.
11. The multi-device layer, every mesh repeating the one card, each
    sub-phase with its own launch counts: (a) the replicate axis on a
    2-entry mesh within ``1e-4`` of no mesh, each entry launching the three
    KL kernels; (b) ``nmf_fit_rowsharded`` on 9a's 250,000 rows over 1, 2
    and 4 cells shards from one init, within ``1e-4`` (W) and ``1e-5``
    (objectives) of one shard, ``w_numer`` and ``beta_err_partials`` once a
    shard and pass, shard 0's kernels held to their plain versions at
    ``rtol 2e-5`` and timed; (c) the 2 x 2 (replicates x cells) mesh and
    (d) the 2 x 2 grid within the same bands of one shard, the grid with
    no launch, its ``collective`` bytes, one pass timed with the overlap on
    and off, and its ``perf_model`` gate; (e) a host loss re-meshing 4 ->
    3 shards; (f) ``run_parallel --engine multihost --rowshard`` with two
    processes on a gloo group, within ``1e-5`` of one process; (g)
    ``run_parallel --engine subprocess`` with two workers, within ``1e-4``
    of one.
12. Serving and the fleet (``serving/``, plain torch: the serve path
    launches no kernel of ours), each sub-phase with its own launch
    counts. (a) ``ServeDaemon`` over phase 3's k=9 consensus reference
    (KL, chunks of 5,000, the run's inner cap) on a unix socket,
    ``max_batch`` 8, linger 2 ms: 64 requests of 33, 256, 1,000, 5,000
    and 7,500 rows (two lanes) of phase 3's normalized HVG counts, dense
    f32 on the ``b64`` wire, from 8 client threads and 4 tenants, each
    reply within ``rtol 1e-5`` of the port's solo ``fit_h`` on the card
    from the same default init (the bit-identical replies counted); at
    least one batch of more than one request; no cold dispatch after the
    eager warmup; 8 repeats warm-started and within ``1e-5`` of a solo fit
    from the previous usage; a NaN request graded poison while the good
    requests sent with it match solo, its tenant quarantined (403) after
    the third strike; the events valid, ``report``'s serving section and
    the ``serve`` ``perf_model`` event (priced at the iteration cap,
    logged). It prints the warmup wall, the solve ms of every (lanes,
    rows) bucket (lanes 1-8 x rows 64-5,000), the client p50/p95/p99,
    requests and cells a second, mean lanes a batch and the peak memory.
    (b) Phase 5's Frobenius reference (``W W^T`` resident): 16 requests
    under the same gates. (c) ``python -m cnmf_torch_tpu_torch fleet``
    over phase 3's run, two ``serve`` subprocesses on the card, 4 tenants
    of load; a ``replicadeath`` clause kills replica 0, which respawns;
    then ``/rollover`` to phase 4's k=9 consensus spectra; then a poison
    tenant: no request fails outside it, every reply is within ``1e-5`` of
    the solo refit against the reference its generation names (and not
    the other's), the ``replica_death``, ``failover`` and ``rollover``
    events are there, the poison tenant is refused at the router (403),
    and a clean shutdown leaves no replica alive. It prints the failover
    gap, the respawn and rollover walls and the p99 before, during and
    after.

13. Formats and the planner (``native/``, ``utils/io.py:read_10x_mtx``,
    ``utils/autotune.py``, ``runtime/planner.py``), each sub-phase with its
    own launch counts. (a) Phase 3's raw counts written as a gzipped 10x
    directory by a vectorised writer, read by the native reader (which must
    have built) and by scipy, the two CSR matrices equal; then ``prepare``
    from the directory writes phase 3's normalized counts, HVG list and
    TPM statistics byte for byte. (b) ``CNMF_TPU_AUTOTUNE=1`` into the
    smoke's private cache (``build/chip_smoke/autotune``, which every phase
    reads from the start): ``h_stats`` and ``w_numer`` launch, the
    fingerprint names the card, the three rho scales and the four plan
    points are finite. (c) Phase 3's online KL factorize at k=9 under
    ``auto`` with that cache and the telemetry on: one ``plan`` event, the
    encoding and streaming groups ``autotuned``, ``ell-cuda``; ``plan
    <run_dir> --out``; ``factorize --plan`` into a fresh run: the same
    signature, the iter spectra and the consensus usages byte for byte,
    the sources ``pin``; a missing plan file exits non-zero naming it. The
    environment is restored after the replay. It prints the 10x write and
    the two read times, the autotune wall, scales and points, and the
    factorize and replay walls.

14. The preprocess sidecar (``models/preprocess.py``, ``ops/seurat_v3.py``,
    ``ops/pca.py``, ``ops/harmony.py``, ``ops/mutual_info.py``, plain
    torch) and the figures (``models/plots.py``). (a) Phase 3's model at
    full width, 10,000 cells x 5,000 genes, with four donors of 2,500
    cells whose rates carry a planted effect a gene (``lognormal(0,
    0.5)``), ten ``MT-`` and ten dotted gene names and a 50-feature
    "Antibody Capture" block: ``filter_adata`` and ``preprocess_for_cnmf``
    (the CITE-seq split, 2,000 seurat_v3 HVGs, PCA to 50, Harmony over
    the donors with theta 1 and 20 iterations: 100 clusters, then the
    gene-space MOE ridge), twice on the card. It checks a non-negative
    cells x 2,000 corrected matrix, TF32 off, each block of TP10K summing
    to 1e4 a cell, the mean donor centroid gap in PC space after Harmony
    below 0.35 of the one before, the two runs within 1e-6, and on 2,000
    cells the card within 1e-3 (of the largest value) of the port's own
    CPU run; it prints the walls of the HVGs, PCA, Harmony, its cluster
    phase and the MOE ridge, the Harmony iterations and cluster rounds
    and the peak. (b) The three files written as ``.df.npz`` and text
    (the card's machine has no h5py), then ``prepare`` (KL, K in {7, 9},
    10 replicates), factorize, combine, consensus (k=9, threshold 2.0,
    the default ``show_clustering=True``) and ``k_selection_plot``, for
    the Harmony output (the dense lane by the lane rule, no launch) and
    for ``harmony_vars=None`` (sparse; the lane rule's own choice logged,
    the ELL lane asked for with ``CNMF_TPU_SPARSE_BETA=1``, the three path
    kernels launched), the launch counts set to 0 before each; without
    matplotlib both figures skipped with the warning that names them and
    no PNG written, every artifact and statistic there. (c)
    ``select_features_MI`` on 2,000 cells against each cell's largest
    program of (b)'s sparse run, card against CPU: the same top 70 and
    MI within 1e-5.

15. Lint and the sanitizer (``analysis/``, ``utils/sanitize.py``). (a)
    ``python -m cnmf_torch_tpu_torch.analysis.gate`` over the port: its
    ``LINT_GATE:`` line and wall, every family at 0 with nothing
    baselined (a finding fails the run), and ``lint --knob-table`` equal
    to ``KNOBS.md``. (b) The negative control: a bare ``.item()`` under
    ``sync_guard`` must raise and the same read inside ``host_read()``
    pass. Then, the inputs staged and every path warmed outside the guard,
    at the main path's width (phase 3's normalized counts in chunks of
    5,000 rows, 2,000 genes, R=20, k=13) under ``sync_guard``: the online
    KL sweep on the ELL lane with the bf16 chain for 3 passes, batch
    ``dna`` and beta=2 for 20 iterations on the first chunk, one
    row-sharded pass (R=1) and ``batched_project`` at 4 lanes x 1,024
    rows. It prints each solve's wall, chosen host reads (a pass, for the
    online sweep) and launches; every output must be finite and every
    kernel launch under the guard. A sync error is not caught: it fails
    the run.

16. The four tutorials (``cnmf_torch_tpu_torch/examples/``), each called
    as a user calls it, ``main(dir, device="cuda")``, at the JAX package's
    defaults: the simulated tutorial (1,000 cells x 1,500 genes, K 4-8 x
    20), PBMC (2,700 x 3,000, K 5-11 x 20, K chosen at the stability
    peak), batch correction (4,000 x 2,500 + 12 ADTs, Harmony over 3
    batches, K 6 x 20) and the Seurat vignette (500 x 800, K 5 x 8). Each
    tutorial's own assertions (planted-program recovery, batch mixing, the
    exported trio's coherence) are the gates: a failure fails the run,
    nothing is caught. The launch counts are set to 0 before each and must
    stay 0 (the default Frobenius loss runs no kernel); each run's timings
    TSV must hold the consensus staging's ``stage_dense:tpm`` rows
    (``StreamStats.record_to``). The batch-correction tutorial returns the
    density threshold its consensus kept (2.0 only after the density
    filter's own ``DensityFilterError`` at 0.5; any other error fails the
    run): the phase logs it and checks that its spectra are on disk. Without h5py the PBMC counts go as a 10x
    directory and the sidecar's hand-off as ``.df.npz`` (D20), without
    matplotlib the figures are skipped (D17). It prints each tutorial's
    wall and peak device memory beside the card's name and power limit.

Every bound in the kernel records is the larger of the bytes over the
card's memory rate and the operations over its operation rate, both from
``cnmf_torch_tpu_torch/obs/costmodel.py:CHIP_PEAKS`` for the card the run
finds (a card with no entry fails the run).

The last three lines of standard output are the kernels' JSON record
(launches of every path), the ``nvidia-smi`` name and power-limit line,
and the run's JSON verdict. Everything the run writes goes under
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


def card_peaks():
    """The card's peaks from the cost model's table
    (``cnmf_torch_tpu_torch/obs/costmodel.py:CHIP_PEAKS``, the data sheet):
    HBM bytes/s, f32 operations/s outside the tensor cores (the ELL kernels
    use no tensor core) and bf16 operations/s at twice the f32 rate
    (bf16x2 instructions, NVIDIA H100 architecture white paper). A card
    with no entry fails the run: its bounds would be a guess."""
    from cnmf_torch_tpu_torch.obs.costmodel import device_peaks

    peaks = device_peaks(CARD)
    check(peaks["source"] == "datasheet",
          f"no data-sheet peaks for {torch.cuda.get_device_name(0)}")
    return peaks["bw"], peaks["flops"], 2 * peaks["flops"]


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


def synthetic_counts(n, g, k_true=14, scale=60.0, seed=SEED, donors=None):
    """The low-rank Poisson GEP model of ``bench.py`` (Dirichlet usages,
    gamma spectra) at ``scale`` counts per unit of usage. ``donors`` (one
    id a cell, 0 .. D-1) multiplies each donor's rates by a planted effect
    per gene, ``lognormal(0, DONOR_SIGMA)`` (median 1)."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(k_true) * 0.2, size=n)
    spectra = rng.gamma(0.25, 1.0, size=(k_true, g)) * 40.0 / g
    rate = usage @ spectra * scale
    if donors is not None:
        effect = rng.lognormal(0.0, DONOR_SIGMA,
                               size=(int(donors.max()) + 1, g))
        rate *= effect[donors]
    counts = rng.poisson(rate).astype(np.float32)
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


def _time_kernel(kl_ell, name, x, vals, H, W, bf16, nnz, with_plain=True):
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
    peak_bytes, peak_f32, peak_bf16 = card_peaks()
    t_bytes = nbytes / peak_bytes * 1e3
    t_ops = (ops / peak_f32 + ops_bf16 / peak_bf16) * 1e3
    rec = {"name": name, "route": "cuda", "source": SOURCE,
           "replaces": REPLACES[name], "launches": 0,
           "ms": cuda_ms(fn),
           "plain_ms": (cuda_ms(plain, iters=10, warmup=2) if with_plain
                        else None),
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
    the default bf16 ratio chain (logged): a lane's reductions batched over
    5 replicates round otherwise than over 1, and a bf16 rounding can turn
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
    gaps, equal = {}, {}
    for chain in ("f32", "bf16"):
        seq, other = errs[chain, "sequential"], errs[chain, "batched"]
        gaps[f"{chain} vs batched"] = {k: float(np.max(
            np.abs(np.asarray(seq[k], np.float64) - other[k])
            / np.abs(np.asarray(other[k], np.float64))))
            for k in SEQ_KS}
        equal[f"{chain} vs batched"] = all(np.array_equal(
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
                   "CNMF_TPU_TRACE_SAMPLE": "1", "CNMF_TPU_PERF_MODEL": "1"}
# a perf_model reading above this fraction of a peak means the cost
# formula counts work the program does not do: a fault, not a clip
ROOFLINE_MAX = 1.05
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
    roofline = perf_model_gate(events, "factorize", "ell-cuda", "phase 8")

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
                   "consensus.kmeans", "Roofline"):
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
    # two pairs, each side first in one
    turns = {"off": [], "on": []}
    for state in ("off", "on", "on", "off"):
        env = {key: ("1" if state == "on" else "0")
               for key in TELEMETRY_KNOBS}
        with knobs(**env):
            stages.run(f"factorize telemetry {state}", obj.factorize)
        turns[state].append(stages.rows[-1][1])
    log(f"phase 8: factorize with the telemetry knobs off {turns['off']} "
        f"s, on {turns['on']} s (turns off, on, on, off); "
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
            "events_bytes": size, "perf_model": roofline,
            "events": n_events, "trace_bytes": os.path.getsize(trace_fn),
            "kernel_names": named}


def perf_model_gate(events, stage, lane, label) -> dict:
    """The one ``perf_model`` event of ``stage`` on ``lane``, priced
    against the card's data-sheet peaks, not exempt, and its achieved
    fractions of the peaks in (0, ``ROOFLINE_MAX``]; returns its
    reading."""
    pms = [e for e in events if e["t"] == "perf_model"
           and e["stage"] == stage]
    check(len(pms) == 1 and pms[0]["lane"] == lane,
          f"{label}: perf_model events {pms}")
    pm = pms[0]
    roof = pm["roofline"]
    check(roof["peak_source"] == "datasheet" and not roof["perf_exempt"],
          f"{label}: perf_model peaks {roof}")
    check(0 < roof["mfu"] <= ROOFLINE_MAX
          and 0 < roof["bw_frac"] <= ROOFLINE_MAX,
          f"{label}: perf_model fractions out of (0, {ROOFLINE_MAX}]: "
          f"{pm}")
    reading = {"stage": stage, "lane": lane,
               "wall_s": pm["measured"]["wall_s"],
               "passes": pm["measured"]["passes"],
               "flops": pm["predicted"]["flops"],
               "bytes": pm["predicted"]["bytes"],
               "mfu": roof["mfu"], "bw_frac": roof["bw_frac"],
               "intensity": roof["intensity"], "bound": roof["bound"]}
    log(f"{label}: perf_model {reading}")
    return reading


# -- phase 9: the atlas path -------------------------------------------------

# 9a: the pipeline at atlas size (the JAX package's row-shard threshold is
# 200,000 cells; BASELINE.md names the "1M-cell atlas" use case). 30
# counts per unit of usage give ~300 UMI a cell over 3,000 genes: 6.7%
# nonzeros over the 2,000 HVGs, the ELL lane of the consensus refits
ATLAS_CELLS, ATLAS_GENES, ATLAS_SCALE = 250_000, 3_000, 30.0
ATLAS_KS = [9, 13]
ATLAS_REPLICATES = 4
ATLAS_BLOCK = 25_000
# 9b: the solver API at BASELINE.md config 5's scale (1M cells, 2,000
# genes), built as CSR in blocks of 50,000 rows; 15 counts per unit of
# usage give 6.9% nonzeros, the ELL lane
SOLVER_CELLS, SOLVER_GENES, SOLVER_SCALE = 1_000_000, 2_000, 15.0
SOLVER_BLOCK = 50_000
SOLVER_CHECK_ROWS = 250_000
DNA_PASSES = 10
# 9b: passes of the dense row-sharded solve of the 1M matrix staged dense,
# whose device peak is held to the resident budget's model
DENSE_PASSES = 3
# device bytes a dense row-sharded stage may hold beyond the model of
# parallel/rowshard.py:dense_pass_bytes (the factors and their updates)
DENSE_SLACK_BYTES = 256 << 20
# streamed against resident consensus: max |a - b| / max |a| of each
# artifact and of the prediction errors, about 20 times the readings on
# an H100 (at most 4.3e-7 and 4.3e-10: on this data the two refits stop
# at the same iterations, unlike on the CPU tests' fixture)
STREAM_RTOL = 1e-5
STREAM_ERR_RTOL = 1e-8
# 9c: the slab-looped tier's resident budget (33,554 rows a group at
# 2,000 genes). It and the resident solve run to convergence (the online
# schedule). Its spectra are held to a plain group loop over row slices
# of the staged matrix (the same partition, usage solves and W steps, as
# many passes), and to the resident solve by one objective (each
# spectra's usages refit on the staged matrix), by max |a - b| / max |a|
# and by the cosine of matched spectra. Limits from the readings on an
# H100 (16 and 57 passes): 1.1e-6 against the plain loop, objectives
# 1.1e-3 apart, spectra 0.148 apart with matched cosines of 0.9927 and
# above (the two solvers take different steps to nearby factors)
OOC_SHARD_BYTES = 256 << 20
OOC_REF_RTOL = 2e-5
OOC_OBJ_RTOL = 5e-3
OOC_W_RTOL = 0.3
OOC_COS_MIN = 0.98
KILL_SPEC = "kill:stage=pass,after=3"
TORN_SPEC = "torn:artifact=ckpt,after=2;kill:stage=pass,after=2"


def card_counts(n, g, scale, seed, block):
    """The low-rank Poisson model of :func:`synthetic_counts` at ``n``
    cells, in row blocks: usages and spectra from numpy at ``seed``, the
    Poisson draws on the card from a CUDA generator at ``seed``, so the
    host never holds the dense mean. Yields ``(lo, hi, f32 block on the
    card)``; a row without counts gets one in gene 0."""
    rng = np.random.default_rng(seed)
    usage = rng.dirichlet(np.ones(14) * 0.2, size=n).astype(np.float32)
    spectra = rng.gamma(0.25, 1.0, size=(14, g)) * 40.0 / g
    S = torch.as_tensor((spectra * scale).astype(np.float32), device=CARD)
    gen = torch.Generator(device=CARD).manual_seed(seed)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        blk = torch.poisson(torch.as_tensor(usage[lo:hi], device=CARD) @ S,
                            generator=gen)
        blk[blk.sum(1) == 0, 0] = 1.0
        yield lo, hi, blk


def atlas_counts(out: str) -> str:
    """9a's counts, written as the dense ``.df.npz`` the port reads."""
    from cnmf_torch_tpu_torch import Frame, save_df_to_npz

    counts = np.empty((ATLAS_CELLS, ATLAS_GENES), np.float32)
    for lo, hi, blk in card_counts(ATLAS_CELLS, ATLAS_GENES, ATLAS_SCALE,
                                   SEED, ATLAS_BLOCK):
        counts[lo:hi] = blk.cpu().numpy()
    fn = os.path.join(out, "atlas_counts.df.npz")
    save_df_to_npz(Frame(counts,
                         np.asarray([f"c{i}" for i in range(ATLAS_CELLS)]),
                         np.asarray([f"g{j}" for j in range(ATLAS_GENES)])),
                   fn, compress=False)
    log(f"9a counts {counts.shape}: {counts.sum() / ATLAS_CELLS:.1f} UMI a "
        f"cell, {np.count_nonzero(counts) / counts.size:.4f} nonzeros, "
        f"file {os.path.getsize(fn) / 2 ** 30:.2f} GiB")
    return fn


def solver_csr():
    """9b's matrix: 1,000,000 x 2,000 CSR, built in blocks of 50,000 rows
    on the card."""
    import scipy.sparse as sp

    parts = []
    for lo, hi, blk in card_counts(SOLVER_CELLS, SOLVER_GENES, SOLVER_SCALE,
                                   SEED + 1, SOLVER_BLOCK):
        c = blk.to_sparse_csr()
        parts.append(sp.csr_matrix(
            (c.values().cpu().numpy(),
             c.col_indices().cpu().numpy().astype(np.int32),
             c.crow_indices().cpu().numpy()), shape=tuple(blk.shape)))
    return sp.vstack(parts).tocsr()


class EventRecorder:
    """An event sink for direct solver calls: every event and the last
    ``StreamStats`` of each stream context."""

    enabled = True

    def __init__(self):
        self.events, self.streams = [], {}

    def emit(self, event_type, **fields):
        self.events.append(dict(fields, t=event_type))

    def emit_stream(self, context, stats):
        self.streams[context] = stats


def pass_rises(traces, label) -> int:
    """Every replicate's per-pass objectives finite and none above the
    previous pass's by more than ``MONOTONE_RTOL``; returns the count of
    (tolerated) rises."""
    rises = 0
    for tr in traces:
        tr = np.asarray(tr, np.float64)
        tr = tr[~np.isnan(tr)]
        check(tr.size >= 2 and np.isfinite(tr).all(),
              f"{label}: objectives {tr.tolist()}")
        rise = np.diff(tr) - MONOTONE_RTOL * np.abs(tr[:-1])
        check((rise <= 0).all(), f"{label}: an objective rose by "
              f"{float(np.diff(tr).max())} (trace {tr.tolist()})")
        rises += int((np.diff(tr) > 0).sum())
    return rises


def dense_peak_gate(stages, name, n, g):
    """The device peak of stage ``name`` within the dense pass's working
    set as ``store_dispatch`` budgets it (``dense_pass_bytes``)."""
    from cnmf_torch_tpu_torch.parallel.rowshard import dense_pass_bytes

    peak = [p for stage, _, p in stages.rows if stage == name][-1] * 2 ** 30
    model = dense_pass_bytes(n, g) + DENSE_SLACK_BYTES
    check(peak <= model, f"{name}: device peak {peak:.0f} bytes above the "
          f"dense pass model {model} ({n} x {g})")
    log(f"{name}: device peak {peak / 2 ** 30:.3f} GiB, the dense pass "
        f"model {model / 2 ** 30:.3f} GiB ({n} x {g})")
    return peak


def atlas_artifact_gap(a_obj, b_obj, dt="2_0") -> dict:
    """max |a - b| / max |a| of the consensus artifacts of two runs."""
    from cnmf_torch_tpu_torch.utils.io import load_df_from_npz

    out = {}
    for key in ("consensus_spectra", "consensus_usages", "gene_spectra_tpm",
                "gene_spectra_score", "starcat_spectra"):
        a = np.asarray(load_df_from_npz(a_obj.paths[key]
                                        % (CONSENSUS_K, dt)).values,
                       np.float64)
        b = np.asarray(load_df_from_npz(b_obj.paths[key]
                                        % (CONSENSUS_K, dt)).values,
                       np.float64)
        check(a.shape == b.shape and np.isfinite(b).all(),
              f"9a {key}: {a.shape} against {b.shape}")
        out[key] = float(np.abs(a - b).max() / np.abs(a).max())
    return out


def atlas_pipeline(stages) -> dict:
    """9a: prepare -> factorize (the row-sharded solver, engaged by the
    cell count) -> combine -> consensus -> k_selection_plot at 250,000
    cells, then the same with the shard store as the only copy and pass
    checkpoints every pass."""
    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.utils import shardstore, telemetry

    out = {}
    counts_fn = stages.run("9a counts", lambda: atlas_counts(OUT))
    obj = cNMF(OUT, "atlas", device=CARD)
    with knobs(CNMF_TPU_TELEMETRY="1", CNMF_TPU_OOC="0",
               CNMF_TPU_PERF_MODEL="1"):
        stages.run("9a prepare", lambda: obj.prepare(
            counts_fn, components=ATLAS_KS, n_iter=ATLAS_REPLICATES,
            seed=SEED, beta_loss="kullback-leibler",
            num_highvar_genes=N_HVG, batch_size=CHUNK))
        kl_ell.reset_launches()
        stages.run("9a factorize", obj.factorize)
        after_f = dict(kl_ell.launches)
        stages.run("9a combine", obj.combine)
        stages.run("9a consensus", lambda: obj.consensus(
            CONSENSUS_K, density_threshold=2.0))
        after_c = dict(kl_ell.launches)
        stats = stages.run("9a k_selection_plot", obj.k_selection_plot)
        launches = dict(kl_ell.launches)
    info = obj.factorize_info
    events = telemetry.read_events(os.path.join(
        OUT, "atlas", "cnmf_tmp", "atlas.events.jsonl"))
    recipe_ev = [e for e in events if e["t"] == "dispatch"
                 and e.get("decision") == "solver_recipe"]
    check(info["mode"] == "rowshard" and recipe_ev
          and recipe_ev[-1]["context"].get("mode") == "rowshard",
          f"9a: factorize ran {info['mode']}, solver_recipe events "
          f"{[e['context'] for e in recipe_ev]}")
    out["perf_model"] = perf_model_gate(events, "factorize_rowshard",
                                        "dense", "9a")
    check(sum(after_f.values()) == 0,
          f"9a: the dense row-sharded factorize launched {after_f}")
    dense_peak_gate(stages, "9a factorize", ATLAS_CELLS, N_HVG)
    check(after_c["h_stats"] > 0,
          f"9a: the consensus refit launched no h_stats ({after_c})")
    rises = sum(pass_rises(info["trace"][k], f"9a k={k}")
                for k in ATLAS_KS)
    for k in ATLAS_KS:
        log(f"9a k={k}: passes {[int(np.isfinite(t).sum()) for t in info['trace'][k]]}"
            f", final objective {np.round(info['errs'][k], 1).tolist()}")
    check(stats.shape == (len(ATLAS_KS), 4)
          and np.isfinite(stats.values).all(), "9a k-selection statistics")
    out.update(launches=launches, factorize_launches=after_f,
               consensus_launches=after_c, rises=rises,
               k_selection=stats.values.tolist())
    ref = iter_bytes(obj, ATLAS_KS, ATLAS_REPLICATES)

    obj2 = cNMF(OUT, "atlas_ooc", device=CARD)
    with knobs(CNMF_TPU_OOC="1", CNMF_TPU_CKPT_EVERY_PASSES="1"):
        stages.run("9a ooc prepare", lambda: obj2.prepare(
            counts_fn, components=ATLAS_KS, n_iter=ATLAS_REPLICATES,
            seed=SEED, beta_loss="kullback-leibler",
            num_highvar_genes=N_HVG, batch_size=CHUNK))
        store = obj2._probe_store()
        check(store is not None
              and not os.path.exists(obj2.paths["normalized_counts"]),
              "9a: CNMF_TPU_OOC=1 must write the store and skip the "
              "matrix file")
        out["store"] = {"slabs": len(store.slabs),
                        "store_bytes": store.store_bytes,
                        "slab_rows": store.manifest["slab_rows"]}
        stages.run("9a ooc factorize (checkpoint every pass)",
                   obj2.factorize)
        check(iter_bytes(obj2, ATLAS_KS, ATLAS_REPLICATES) == ref,
              "9a: the store-backed iter spectra differ from the in-memory "
              "run's")
        stages.run("9a ooc combine", obj2.combine)
        stages.run("9a ooc consensus (streamed)", lambda: obj2.consensus(
            CONSENSUS_K, density_threshold=2.0))
        stats2 = stages.run("9a ooc k_selection_plot (streamed)",
                            obj2.k_selection_plot)
    gap = atlas_artifact_gap(obj, obj2)
    err_gap = float(np.abs(stats2.values[:, 3] - stats.values[:, 3]).max()
                    / np.abs(stats.values[:, 3]).max())
    peaks = {c: int(st.host_peak_bytes) for c, st in obj2.stream_stats.items()}
    check(all(v <= STREAM_RTOL for v in gap.values())
          and err_gap <= STREAM_ERR_RTOL,
          f"9a: streamed consensus against resident {gap} (band "
          f"{STREAM_RTOL}), prediction errors {err_gap} (band "
          f"{STREAM_ERR_RTOL})")
    check(max(peaks.values()) <= shardstore.ooc_budget_bytes(),
          f"9a: streamed host residency {peaks} above the budget")
    log(f"9a: {len(ref)} iter spectra files bit for bit the in-memory "
        f"run's with the store as the only copy; streamed consensus "
        f"against resident (max |a-b| / max |a|) {gap}, prediction errors "
        f"{err_gap:.3g}; streamed host peaks {peaks} bytes; store "
        f"{out['store']}")
    out.update(stream_gap=gap, error_gap=err_gap, stream_peaks=peaks)
    return out, obj, obj2, ref, counts_fn


def solver_api(stages, rows) -> dict:
    """9b: ``nmf_fit_rowsharded`` on 1,000,000 x 2,000 CSR (the ELL lane),
    the three kernels held against their plain versions at R=1 on the
    first 250,000 rows and timed at both sizes, and a 250,000-row solve
    under a pinned dna recipe."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.recipe import SolverRecipe
    from cnmf_torch_tpu_torch.ops.sparse import EllMatrix
    from cnmf_torch_tpu_torch.parallel import rowshard
    from cnmf_torch_tpu_torch.parallel.rowshard import (nmf_fit_rowsharded,
                                                        stream_ell_to_mesh,
                                                        stream_rows_to_mesh)

    out = {}
    X = stages.run("9b CSR 1M x 2,000", solver_csr)
    out["density"] = X.nnz / (X.shape[0] * X.shape[1])
    # the solve takes the CSR matrix, so the entry's own dispatch stages it
    # (ELL under the rule); the staged encoding is kept from the staging
    # call for the 10^6-row kernel timings, so it is encoded once
    staged = []

    def keep_staged(*args, **kwargs):
        got = stream_ell_to_mesh(*args, **kwargs)
        staged.append(got[0])
        return got

    kl_ell.reset_launches()
    rec = EventRecorder()
    payloads = []
    rowshard.stream_ell_to_mesh = keep_staged
    try:
        _H, W, err = stages.run("9b nmf_fit_rowsharded 1M (ELL)",
                                lambda: nmf_fit_rowsharded(
                                    X, CONSENSUS_K,
                                    beta_loss="kullback-leibler", seed=SEED,
                                    telemetry_sink=payloads.append,
                                    events=rec, device=CARD))
    finally:
        rowshard.stream_ell_to_mesh = stream_ell_to_mesh
    check(len(staged) == 1 and isinstance(staged[0], EllMatrix),
          f"9b: the CSR entry staged {[type(x).__name__ for x in staged]}, "
          "not one ELL encoding")
    x_full = staged.pop()
    st = rec.streams["rowshard_staging"]
    enc_full_s = st.wall_s
    out["launches"] = dict(kl_ell.launches)
    for name in ONLINE_KERNELS:
        check(out["launches"][name] > 0, f"9b: {name} never launched")
    check(np.isfinite(W).all() and np.isfinite(err), "9b: nonfinite solve")
    out["passes"] = int(payloads[0]["iters"][0])
    out["rises"] = pass_rises([payloads[0]["trace"][0]], "9b 1M")
    out["encode"] = {"host_s": st.host_prep_s, "h2d_s": st.h2d_s,
                     "bytes": st.nbytes}
    log(f"9b: 1M solve, {out['passes']} passes, objective {err:.6g}, "
        f"launches {out['launches']}; encoding {st.host_prep_s:.2f} s on the "
        f"host, {st.nbytes / 2 ** 30:.2f} GiB copied in {st.h2d_s:.2f} s")
    records = {}
    gen = torch.Generator().manual_seed(SEED + 3)
    for n_rows in (SOLVER_CHECK_ROWS, SOLVER_CELLS):
        if n_rows == SOLVER_CELLS:
            x, x_full, enc_s = x_full, None, enc_full_s
        else:
            t0 = time.perf_counter()
            x, _ = stream_ell_to_mesh(X[:n_rows], CARD)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
        nnz = int((x.vals > 0).sum())
        g = X.shape[1]
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x.vals, x.cols, x.rows_t, x.perm_t))
        H = (torch.rand((1, n_rows, CONSENSUS_K), generator=gen)
             + 0.1).to(CARD)
        W0 = (torch.rand((1, CONSENSUS_K, g), generator=gen) + 0.1).to(CARD)
        tag = f"R=1 rows={n_rows} k={CONSENSUS_K}"
        check_it = n_rows == SOLVER_CHECK_ROWS
        errs = {}
        if check_it:
            got = kl_ell.h_stats(x.vals, x.cols, H, W0)
            again = kl_ell.h_stats(x.vals, x.cols, H, W0)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"h_stats {tag} not repeatable")
            errs["h_stats"] = max_abs_err(
                got, kl_ell.h_stats_plain(x.vals, x.cols, H, W0), 2e-5)
            del got, again
            errs["w_numer"] = w_numer_check(kl_ell, x, H, W0, False, tag)
            errs["beta_err_partials"], _ = beta_err_check(kl_ell, x, H, W0,
                                                          tag)
        shape = {"rows": n_rows, "w": x.width, "t_w": x.t_width, "nnz": nnz,
                 "encoding_bytes": nbytes, "encode_s": enc_s}
        for name in ONLINE_KERNELS:
            rec = _time_kernel(kl_ell, name, x, x.vals, H, W0, False, nnz,
                               with_plain=check_it)
            rec["max_abs_err"] = errs.get(name)
            rec["variant"] = (f"{tag}, genes={g}, w={x.width}, "
                              f"wt={x.t_width}, nnz={nnz}")
            records.setdefault(name, {})[n_rows] = rec
            rows.append(
                f"  {name:18s} {tag:26s} kernel {rec['ms']:.4f} ms  plain "
                f"{rec['plain_ms']} ms  bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']})  max_abs_err {rec['max_abs_err']}")
        out.setdefault("shapes", []).append(shape)
        log(f"9b encoding of {n_rows} rows: w {x.width}, t_w {x.t_width}, "
            f"{nnz} nonzeros, {nbytes / 2 ** 30:.3f} GiB on the card, "
            f"{enc_s:.2f} s (host encode and copy)")
        del x, H, W0
        torch.cuda.empty_cache()
    # the same matrix staged dense: the pass's row blocks keep the device
    # peak to X and a fixed scratch
    Xd = stages.run("9b stage 1M dense", lambda: stream_rows_to_mesh(
        X, CARD)[0])
    dense_payloads = []
    stages.run(f"9b dense row-sharded solve 1M ({DENSE_PASSES} passes)",
               lambda: nmf_fit_rowsharded(
                   Xd, CONSENSUS_K, beta_loss="kullback-leibler", seed=SEED,
                   n_passes=DENSE_PASSES,
                   telemetry_sink=dense_payloads.append, device=CARD))
    out["dense_peak_bytes"] = dense_peak_gate(
        stages, f"9b dense row-sharded solve 1M ({DENSE_PASSES} passes)",
        SOLVER_CELLS, SOLVER_GENES)
    out["dense_rises"] = pass_rises([dense_payloads[0]["trace"][0]],
                                    "9b dense 1M")
    del Xd
    torch.cuda.empty_cache()
    kl_ell.reset_launches()
    stages.run("9b dna solve 250k", lambda: nmf_fit_rowsharded(
        X[:SOLVER_CHECK_ROWS], CONSENSUS_K, beta_loss="kullback-leibler",
        seed=SEED, n_passes=DNA_PASSES,
        recipe=SolverRecipe("dna", 1, True, "caller"), device=CARD))
    out["dna_launches"] = dict(kl_ell.launches)
    # the Newton usage steps replace h_stats; the W step and the objective
    # stay on w_numer and beta_err_partials
    for name in BATCH_KERNELS + ("w_numer", "beta_err_partials"):
        check(out["dna_launches"][name] > 0,
              f"9b dna: {name} never launched")
    log(f"9b dna solve launches {out['dna_launches']}")
    return out, records


def matched_cosines(A, B):
    """The cosines of the spectra of ``A`` and ``B`` (k x g) paired one to
    one for the largest total cosine."""
    from scipy.optimize import linear_sum_assignment

    a = A / np.linalg.norm(A, axis=1, keepdims=True)
    b = B / np.linalg.norm(B, axis=1, keepdims=True)
    sim = a @ b.T
    rows, cols = linear_sum_assignment(-sim)
    return sim[rows, cols]


def plain_slab_loop(Xd, init, passes):
    """The slab-looped tier's KL passes done plainly on row slices of the
    staged matrix: groups of ``OOC_SHARD_BYTES`` of rows in order, each
    group's usages solved with W fixed (warm from its last pass), then one
    MU step of W from that group's statistics. Returns W (k, g)."""
    from cnmf_torch_tpu_torch.parallel.rowshard import fit_h_rowsharded

    n, g = Xd.shape
    rows = min(max(8, OOC_SHARD_BYTES // (g * 4)), n)
    H = np.array(init[0], np.float32)
    W = torch.as_tensor(np.array(init[1], np.float32), device=CARD)
    for _ in range(passes):
        for lo in range(0, n, rows):
            x = Xd[lo:lo + rows]
            H[lo:lo + rows] = fit_h_rowsharded(
                x, W.cpu().numpy(), beta=1.0, chunk_max_iter=1000,
                H0=H[lo:lo + rows], device=CARD)
            h = torch.as_tensor(H[lo:lo + rows], device=CARD)
            numer = h.T @ (x / torch.clamp_min(h @ W, 1e-16))
            W = W * numer / torch.clamp_min(h.sum(0)[:, None], 1e-16)
    return W.cpu().numpy()


def ooc_faults(stages, obj2, ref) -> dict:
    """9c on 9a's store-backed run: the slab-looped tier against the
    resident solve, a factorize killed at a pass boundary and resumed, a
    torn checkpoint, and a torn slab read."""
    import warnings

    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.ops.nmf import beta_divergence, random_init
    from cnmf_torch_tpu_torch.parallel.rowshard import (fit_h_rowsharded,
                                                        nmf_fit_rowsharded,
                                                        stream_rows_to_mesh)
    from cnmf_torch_tpu_torch.utils import shardstore, telemetry

    out = {}
    store = shardstore.open_shard_store(obj2.paths["shard_store"])
    n, g = store.shape
    init = tuple(t.numpy() for t in random_init(
        SEED, n, g, CONSENSUS_K, store.value_sum / (n * g)))
    kw = dict(beta_loss="kullback-leibler", seed=SEED, init_factors=init,
              device=CARD)
    Xd = stages.run("9c stage store resident",
                    lambda: stream_rows_to_mesh(store, CARD)[0])
    res_pay, ooc_pay = [], []
    _, W_res, _ = stages.run("9c resident solve", lambda: nmf_fit_rowsharded(
        Xd, CONSENSUS_K, telemetry_sink=res_pay.append, **kw))
    rec = EventRecorder()
    with knobs(CNMF_TPU_OOC_SHARD_BYTES=str(OOC_SHARD_BYTES)):
        _, W_ooc, _ = stages.run(
            "9c slab-looped solve", lambda: nmf_fit_rowsharded(
                store, CONSENSUS_K, store_slab_loop=True, events=rec,
                telemetry_sink=ooc_pay.append, **kw))
    st = rec.streams["rowshard_ooc_passes"]
    passes = (int(res_pay[0]["iters"][0]), int(ooc_pay[0]["iters"][0]))
    W_ref = stages.run("9c plain group loop", lambda: plain_slab_loop(
        Xd, init, passes[1]))

    def objective(W):
        # W's usages refit on the staged matrix, then one KL objective,
        # summed in f64 over blocks of ATLAS_BLOCK rows
        H = torch.as_tensor(fit_h_rowsharded(Xd, W, beta=1.0, device=CARD),
                            device=CARD)[None]
        Wt = torch.as_tensor(W, device=CARD)[None]
        return sum(float(beta_divergence(Xd[lo:lo + ATLAS_BLOCK],
                                         H[:, lo:lo + ATLAS_BLOCK], Wt,
                                         1.0)[0])
                   for lo in range(0, n, ATLAS_BLOCK))

    o_res, o_ooc = objective(W_res), objective(W_ooc)
    del Xd
    torch.cuda.empty_cache()

    ref_gap = float(np.abs(W_ref - W_ooc).max() / np.abs(W_ref).max())
    w_gap = float(np.abs(W_res - W_ooc).max() / np.abs(W_res).max())
    cos = matched_cosines(W_res, W_ooc)
    obj_gap = abs(o_ooc - o_res) / abs(o_res)
    log(f"9c slab loop: {passes[1]} passes ({passes[0]} resident); spectra "
        f"against the plain group loop {ref_gap:.4g}; against the resident "
        f"solve max |a-b| / max |a| {w_gap:.4g}, matched cosines "
        f"{np.round(cos, 5).tolist()}; refit objective {o_ooc:.9g} against "
        f"the resident {o_res:.9g} (gap {obj_gap:.4g}); host peak "
        f"{st.host_peak_bytes} bytes of {shardstore.ooc_budget_bytes()}; "
        f"{st.slabs} slabs read")
    check(ref_gap <= OOC_REF_RTOL and obj_gap <= OOC_OBJ_RTOL
          and w_gap <= OOC_W_RTOL and cos.min() >= OOC_COS_MIN,
          f"9c: slab-looped spectra against the plain group loop {ref_gap} "
          f"(band {OOC_REF_RTOL}); against the resident solve: objective "
          f"gap {obj_gap} (band {OOC_OBJ_RTOL}), spectra {w_gap} (band "
          f"{OOC_W_RTOL}), least matched cosine {cos.min()} (limit "
          f"{OOC_COS_MIN})")
    check(st.host_peak_bytes <= shardstore.ooc_budget_bytes(),
          f"9c: host residency peak {st.host_peak_bytes} above the budget")
    out["slab_loop"] = {"objective": o_ooc, "resident": o_res,
                        "objective_gap": obj_gap, "spectra_gap": w_gap,
                        "matched_cosines": cos.tolist(),
                        "plain_loop_gap": ref_gap, "passes": passes,
                        "host_peak_bytes": int(st.host_peak_bytes),
                        "disk_gb_per_s": st.read_gb_per_s(),
                        "slabs_read": int(st.slabs)}

    # a factorize killed at a pass boundary, then --skip-completed-runs
    env = dict(os.environ, PYTHONPATH=HERE, CNMF_TPU_TELEMETRY="1")
    cmd = [sys.executable, "-m", "cnmf_torch_tpu_torch", "factorize",
           "--output-dir", OUT, "--name", "atlas_ooc", "--device", CARD,
           "--rowshard", "--skip-completed-runs"]
    os.unlink(obj2.paths["iter_spectra"] % (CONSENSUS_K, 0))
    killed = stages.run("9c factorize killed at pass 4", lambda: subprocess.run(
        cmd, env=dict(env, CNMF_TPU_FAULT_SPEC=KILL_SPEC), cwd=HERE,
        capture_output=True, text=True, timeout=900))
    ckpt = obj2.paths["pass_checkpoint"] % (CONSENSUS_K, 0)
    check(killed.returncode == -9 and os.path.exists(ckpt),
          f"9c: the killed factorize exited {killed.returncode}, "
          f"checkpoint {os.path.exists(ckpt)}: {killed.stderr[-2000:]}")
    resumed = stages.run("9c resume (CLI --skip-completed-runs)",
                         lambda: subprocess.run(
                             cmd, env=env, cwd=HERE, capture_output=True,
                             text=True, timeout=900))
    check(resumed.returncode == 0, f"9c resume: {resumed.stderr[-2000:]}")
    events = telemetry.read_events(os.path.join(
        OUT, "atlas_ooc", "cnmf_tmp", "atlas_ooc.events.jsonl"))
    resumes = [e["context"] for e in events if e["t"] == "checkpoint"
               and e.get("action") == "resume"]
    check(resumes and resumes[-1]["pass_idx"] == 4 and resumes[-1]["with_h"],
          f"9c: checkpoint resume events {resumes}")
    check(iter_bytes(obj2, ATLAS_KS, ATLAS_REPLICATES) == ref,
          "9c: the resumed iter spectra differ from the uninterrupted run's")
    out["kill_resume"] = {"killed_rc": killed.returncode,
                          "resumed_from_pass": resumes[-1]["pass_idx"]}
    log(f"9c kill at a pass boundary: resumed from pass "
        f"{resumes[-1]['pass_idx']} with H; every iter file bit for bit")

    # a torn checkpoint: discarded, its replicate restarts from scratch
    os.unlink(obj2.paths["iter_spectra"] % (CONSENSUS_K, 0))
    torn = stages.run("9c factorize torn and killed", lambda: subprocess.run(
        cmd, env=dict(env, CNMF_TPU_FAULT_SPEC=TORN_SPEC), cwd=HERE,
        capture_output=True, text=True, timeout=900))
    check(torn.returncode == -9, f"9c torn: exited {torn.returncode}")
    again = cNMF(OUT, "atlas_ooc", device=CARD)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stages.run("9c resume after a torn checkpoint",
                   lambda: again.factorize(skip_completed_runs=True))
    discarded = [str(w.message) for w in caught
                 if "pass checkpoint failed validation" in str(w.message)]
    check(discarded, "9c: the torn checkpoint was not discarded")
    check(iter_bytes(obj2, ATLAS_KS, ATLAS_REPLICATES) == ref,
          "9c: the restarted replicate differs from the uninterrupted run")
    out["torn_checkpoint"] = discarded[0][:200]
    log("9c torn checkpoint: discarded, the replicate restarted from "
        "scratch and wrote the uninterrupted run's bytes")

    # a torn slab read heals by re-reading
    clean = stream_rows_to_mesh(store, CARD)[0]
    rec = EventRecorder()
    with knobs(CNMF_TPU_FAULT_SPEC="shard_read:limit=1"), \
            warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        healed = stream_rows_to_mesh(store, CARD, events=rec)[0]
    faults_seen = [e for e in rec.events if e["t"] == "fault"
                   and e.get("kind") == "shard_read_torn"]
    check(len(faults_seen) == 1 and torch.equal(clean, healed),
          f"9c shard_read: faults {faults_seen}, staged equal "
          f"{bool(torch.equal(clean, healed))}")
    out["shard_read"] = faults_seen[0]["context"]
    log(f"9c torn slab read: detected ({faults_seen[0]['context']['path']}),"
        " re-read, staged matrix bit for bit the clean one")
    return out


def phase9(stages, rows):
    """Phase 9, the atlas path: 9a, 9b and 9c. Returns its report, the
    R=1 kernel records and what phase 10 compares with: 9a's counts file,
    its in-memory and store-backed runs and its iter spectra bytes."""
    p9, obj, obj2, ref, counts_fn = atlas_pipeline(stages)
    p9["solver"], records = solver_api(stages, rows)
    p9["faults"] = ooc_faults(stages, obj2, ref)
    p9["kernel_launches"] = {
        name: int(p9["launches"][name]) + int(p9["solver"]["launches"][name])
        + int(p9["solver"]["dna_launches"][name])
        for name in ONLINE_KERNELS + BATCH_KERNELS}
    return p9, records, (counts_fn, obj, obj2, ref)


# -- phase 10: the remote object store ----------------------------------------

# 10b: the small store (phase 3's normalized counts) in slabs of this many
# rows, the slow request's seconds and the hedge's trigger
NET_SLAB_ROWS = 2_000
NET_SLOW_S = 1.0
NET_HEDGE_S = 0.1


def remote_pipeline(stages, srv, counts_fn, atlas_obj, ooc_obj, ref) -> dict:
    """10a: 9a's counts prepared store-only into the object store at K=9
    with 9a's replicates, factorized and brought to consensus through it,
    resident (``atlas_obj``, 9a's in-memory run, is its reference) and
    streamed (``ooc_obj``, 9a's store-backed run); the iter spectra must be
    9a's bytes."""
    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.utils import storebackend, telemetry

    out = {}
    name = "atlas_remote"
    obj = cNMF(OUT, name, device=CARD)
    uri = srv.url + "/atlas"
    with knobs(CNMF_TPU_OOC="1", CNMF_TPU_STORE_URI=uri,
               CNMF_TPU_TELEMETRY="1"):
        stages.run("10a prepare, store only, remote", lambda: obj.prepare(
            counts_fn, components=[CONSENSUS_K], n_iter=ATLAS_REPLICATES,
            seed=SEED, beta_loss="kullback-leibler",
            num_highvar_genes=N_HVG, batch_size=CHUNK))
        store = obj._probe_store()
        leaf = os.path.basename(obj.paths["shard_store"])
        with srv.lock:
            remote = {k: len(v) for k, v in srv.objects.items()
                      if k.startswith(f"atlas/{leaf}/")}
        check(store is not None and store.backend.kind == "remote"
              and not os.path.exists(obj.paths["shard_store"])
              and not os.path.exists(obj.paths["normalized_counts"])
              and len(remote) == len(store.slabs) + 2,
              f"10a: the store is not the remote one only: "
              f"{len(remote)} objects for {len(store.slabs)} slabs")
        out["store"] = {"objects": len(remote),
                        "object_bytes": int(sum(remote.values())),
                        "slabs": len(store.slabs),
                        "store_bytes": int(store.store_bytes)}
        kl_ell.reset_launches()
        stages.run("10a factorize through the remote store", obj.factorize)
        after_f = dict(kl_ell.launches)
        mine = iter_bytes(obj, [CONSENSUS_K], ATLAS_REPLICATES)
        want = {key: v for key, v in ref.items() if key[0] == CONSENSUS_K}
        check(mine == want, "10a: the iter spectra differ from 9a's "
              "local store-backed run's")
        stages.run("10a combine", obj.combine)
        # the resident refit on the matrix read back through the store:
        # the streamed refit of a store-only run is dense and launches no
        # kernel (as in the JAX package)
        counts = stages.run("10a matrix read back through the store",
                            lambda: obj._store_counts(store,
                                                      with_matrix=True))
        stages.run("10a consensus (resident refit)", lambda: obj.consensus(
            CONSENSUS_K, density_threshold=2.0, norm_counts=counts))
        launches = dict(kl_ell.launches)
        del counts
        # read before the streamed consensus writes the same artifacts
        gap = atlas_artifact_gap(atlas_obj, obj)
        # the consensus a store-only run takes: streamed from the store
        # through the remote backend and its read-through cache
        stages.run("10a consensus (streamed through the store)",
                   lambda: obj.consensus(CONSENSUS_K, density_threshold=2.0))
    check(sum(after_f.values()) == 0,
          f"10a: the dense row-sharded factorize launched {after_f}")
    check(launches["h_stats"] > 0,
          f"10a: the consensus refit launched no h_stats ({launches})")
    check(all(v <= STREAM_RTOL for v in gap.values()),
          f"10a: consensus against 9a's in-memory run {gap} (band "
          f"{STREAM_RTOL})")
    stream_gap = atlas_artifact_gap(ooc_obj, obj)
    check(all(v <= STREAM_RTOL for v in stream_gap.values()),
          f"10a: streamed consensus against 9a's streamed run {stream_gap} "
          f"(band {STREAM_RTOL})")
    events = telemetry.read_events(os.path.join(
        OUT, name, "cnmf_tmp", name + ".events.jsonl"))
    cons_ev = [e for e in events if e["t"] == "stream"
               and e["context"] == "consensus_stream"]
    check(len(cons_ev) == 1 and cons_ev[0].get("store_remote") is True
          and cons_ev[0]["store_cache_hits"] >= len(store.slabs)
          and cons_ev[0]["store_cache_misses"] == 0
          and cons_ev[0]["store_retries"] == 0,
          f"10a: the streamed consensus's stream events {cons_ev} "
          f"({len(store.slabs)} slabs, the cache warm)")
    (stage_ev,) = [e for e in events if e["t"] == "stream"
                   and e["context"] == "rowshard_stage_x"]
    slab_bytes = int(sum(int(sl["raw_bytes"]) for sl in store.slabs))
    check(stage_ev.get("store_remote") is True
          and stage_ev["disk_nbytes"] == slab_bytes
          and stage_ev["store_cache_misses"] == len(store.slabs)
          and stage_ev["nbytes"] > 0,
          f"10a: the staging's stream event {stage_ev} (slab bytes "
          f"{slab_bytes}, {len(store.slabs)} slabs)")
    cache_dir = storebackend.store_cache_dir(obj.paths["shard_store"])
    entries = {fn: os.path.getsize(os.path.join(cache_dir, fn))
               for fn in os.listdir(cache_dir) if not fn.endswith(".sha1")}
    cache_bytes = sum(entries.values())
    check(len(entries) == len(remote)
          and cache_bytes == sum(remote.values())
          and cache_bytes <= storebackend.store_cache_bytes(),
          f"10a: the read-through cache holds {len(entries)} entries, "
          f"{cache_bytes} bytes, for {len(remote)} objects of "
          f"{sum(remote.values())} bytes (budget "
          f"{storebackend.store_cache_bytes()})")
    log(f"10a: {len(mine)} iter spectra files bit for bit 9a's through "
        f"{uri}; store {out['store']}; staging stream {stage_ev['nbytes']} "
        f"bytes to the card, {stage_ev['disk_nbytes']} read at "
        f"{stage_ev.get('disk_gb_per_s')} GB/s, cache misses "
        f"{stage_ev['store_cache_misses']}; cache {len(entries)} entries, "
        f"{cache_bytes} bytes; consensus against 9a's {gap}; streamed "
        f"consensus against 9a's streamed {stream_gap}, its stream "
        f"{cons_ev[0]['disk_nbytes']} bytes read, cache hits "
        f"{cons_ev[0]['store_cache_hits']}; launches {launches}")
    out.update(launches=launches, factorize_launches=after_f,
               consensus_gap=gap, stream_consensus_gap=stream_gap,
               consensus_stream={k: cons_ev[0].get(k) for k in (
                   "wall_s", "disk_nbytes", "disk_gb_per_s",
                   "store_cache_hits", "store_cache_misses")},
               cache_bytes=cache_bytes,
               stream={k: stage_ev.get(k) for k in (
                   "wall_s", "nbytes", "disk_nbytes", "disk_gb_per_s",
                   "store_cache_misses", "store_cache_hits",
                   "store_retries")})
    return out, obj


def net_faults(stages, srv, Xn) -> dict:
    """10b: each network fault on a small store heals to the clean staging
    bytes, with its evidence in the events file and the report."""
    import warnings

    from cnmf_torch_tpu_torch.parallel.rowshard import stream_rows_to_mesh
    from cnmf_torch_tpu_torch.parallel.streaming import StreamStats
    from cnmf_torch_tpu_torch.utils import shardstore, storebackend, telemetry

    name = "netfaults"
    run_dir = os.path.join(OUT, name)
    store_dir = os.path.join(run_dir, "small.store")
    out = {}
    with knobs(CNMF_TPU_STORE_URI=srv.url + "/small",
               CNMF_TPU_TELEMETRY="1", CNMF_TPU_STORE_BACKOFF_S="0.01",
               CNMF_TPU_STORE_TIMEOUT_S="10"):
        log_ = telemetry.EventLog(os.path.join(run_dir, "cnmf_tmp",
                                               name + ".events.jsonl"),
                                  device=CARD)
        shardstore.write_shard_store(store_dir, Xn,
                                     slab_rows=NET_SLAB_ROWS, events=log_)
        clean = stream_rows_to_mesh(
            shardstore.open_shard_store(store_dir), CARD)[0]
        cases = [
            ("netflake", "netflake:context=get:slab",
             {"CNMF_TPU_STORE_CACHE_BYTES": "0"}),
            ("netslow", f"netslow:context=get:slab,seconds={NET_SLOW_S}",
             {"CNMF_TPU_STORE_CACHE_BYTES": "0",
              "CNMF_TPU_STORE_HEDGE_S": str(NET_HEDGE_S)}),
            ("nettorn", "nettorn:context=get:slab",
             {"CNMF_TPU_STORE_CACHE_BYTES": "0"}),
            ("netdown", "netdown:context=get:",
             {"CNMF_TPU_STORE_RETRIES": "1"}),
        ]
        storebackend._reset_degraded_warnings()
        for kind, spec, env in cases:
            if kind == "netdown":
                # warm the read-through cache first
                warm = shardstore.open_shard_store(store_dir)
                stream_rows_to_mesh(warm, CARD)
                warm.obs_names()
            n_before = len(telemetry.read_events(log_.path))
            stats = StreamStats()
            with knobs(CNMF_TPU_FAULT_SPEC=spec, **env), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")

                def stage():
                    st = shardstore.open_shard_store(store_dir, events=log_)
                    return st, stream_rows_to_mesh(st, CARD, stats=stats,
                                                   events=log_)[0]

                store, got = stages.run(f"10b staging under {kind}", stage)
            log_.emit_stream(f"net_{kind}", stats)
            check(torch.equal(got, clean),
                  f"10b {kind}: the staged matrix differs from the clean one")
            snap = storebackend.backend_counter_snapshot(store)
            new = telemetry.read_events(log_.path)[n_before:]
            net = [e["context"] for e in new if e["t"] == "fault"
                   and e["kind"] == "store_net"]
            torn = [e["context"] for e in new if e["t"] == "fault"
                    and e["kind"] == "shard_read_torn"]
            loud = [str(w.message) for w in caught
                    if "DEGRADED" in str(w.message)]
            if kind == "netflake":
                ok = (snap["retries"] >= 1 and snap["healed"] >= 1
                      and any(c.get("healed") for c in net))
            elif kind == "netslow":
                ok = snap["hedges"] >= 1 and snap["hedges_won"] >= 1
            elif kind == "nettorn":
                ok = len(torn) == 1
            else:
                ok = (snap["degraded_reads"] >= 1 and len(loud) == 1
                      and any(c.get("degraded") for c in net))
            check(ok, f"10b {kind}: counters {snap}, store_net events "
                  f"{net[:4]}, torn reads {torn}, warnings {loud}")
            out[kind] = {"counters": snap, "store_net_events": len(net),
                         "torn_reads": len(torn),
                         "wall_s": stages.rows[-1][1]}
            log(f"10b {kind}: staged bit for bit the clean matrix; "
                f"counters {snap}; store_net events {len(net)}, torn "
                f"reads {len(torn)}, degraded warnings {len(loud)}")
    summary = telemetry.summarize_events(telemetry.read_events(log_.path))
    report = cli_text(["report", run_dir])
    with open(os.path.join(OUT, "phase10_report.txt"), "w") as f:
        f.write(report)
    recovered = summary["faults"].get("store_net_recovered", 0)
    degraded = summary["faults"].get("store_net_degraded", 0)
    check(recovered >= 1 and degraded >= 1
          and "store_net: recovered %d, degraded reads %d"
          % (recovered, degraded) in report,
          f"10b: the report's store_net line (recovered {recovered}, "
          f"degraded {degraded})")
    out["report"] = {"recovered": recovered, "degraded": degraded}
    return out


def cold_netdown(stages, obj, uri) -> dict:
    """10c: with 10a's cache gone and slab reads down, factorize ends with
    ``RemoteStoreError`` and a ``remote_store`` ledger record."""
    from cnmf_torch_tpu_torch.utils import storebackend
    from cnmf_torch_tpu_torch.utils.shardstore import RemoteStoreError

    shutil.rmtree(storebackend.store_cache_dir(obj.paths["shard_store"]))
    raised = None
    with knobs(CNMF_TPU_OOC="1", CNMF_TPU_STORE_URI=uri,
               CNMF_TPU_FAULT_SPEC="netdown:context=get:slab_",
               CNMF_TPU_STORE_RETRIES="1", CNMF_TPU_STORE_BACKOFF_S="0.01"):
        def run():
            nonlocal raised
            try:
                obj.factorize()
            except RemoteStoreError as exc:
                raised = exc

        stages.run("10c factorize, slab reads down, cold cache", run)
    ledger = read_ledger(obj)
    kinds = [r["kind"] for r in ledger.get("shard_faults", [])]
    check(raised is not None and kinds == ["remote_store"],
          f"10c: factorize raised {raised!r}; ledger shard faults {kinds}")
    log(f"10c: factorize ended with RemoteStoreError ({str(raised)[:160]}); "
        f"the ledger records {kinds}")
    return {"error": str(raised)[:300], "ledger": kinds}


def phase10(stages, Xn, atlas) -> dict:
    """Phase 10, the remote object store: the fixture server in this
    process on the loopback interface (a server that cannot bind fails the
    phase), then 10a, 10b and 10c."""
    from cnmf_torch_tpu_torch.utils.netstore import ObjectStoreServer

    counts_fn, atlas_obj, ooc_obj, ref = atlas
    with ObjectStoreServer("127.0.0.1", 0) as srv:
        log(f"phase 10: object store fixture at {srv.url}")
        p10, obj = remote_pipeline(stages, srv, counts_fn, atlas_obj,
                                   ooc_obj, ref)
        p10["faults"] = net_faults(stages, srv, Xn)
        p10["cold_netdown"] = cold_netdown(stages, obj, srv.url + "/atlas")
    return p10


# -- phase 11: the multi-device layer ----------------------------------------

# the phase's solves stop at these pass caps (the sharded and one-shard
# solves then ran the same passes)
P11_PASSES = 15
P11_GRID_PASSES = 5
# a sharded solve against the one-shard solve from the same init: max
# |a - b| / max |a| of W and the largest relative gap of the per-pass
# objectives. On an NVIDIA H100 80GB HBM3 at 700 W, 11b-11d read at most
# 7.5e-7 in W and 9.6e-8 in the objectives (on this data each shard's usage
# solve stops where the whole one does); the bands leave about 100x
P11_W_RTOL = 1e-4
P11_TRACE_RTOL = 1e-5
# two processes against one process over as many shards: the same sums in
# the same order (gloo adds two ranks exactly as one process adds two
# shards)
P11_PROC_RTOL = 1e-5
MESH_KERNELS = ("h_stats", "w_numer", "beta_err_partials")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _trace_gap(tr, ref) -> float:
    m = np.isfinite(ref) & np.isfinite(tr)
    return float(np.max(np.abs(tr[m] - ref[m]) / np.abs(ref[m])))


def replicate_axis(Xn, stages) -> dict:
    """11a: the online KL sweep at K=9, 20 replicates, on a 2-entry mesh
    on the card against the same sweep with no mesh, under strict f32;
    each entry's sub-sweep launches the three kernels."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.parallel import replicates
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh

    seeds = list(range(SEED, SEED + REPLICATES))
    kw = dict(beta_loss="kullback-leibler", mode="online",
              online_chunk_size=CHUNK, device=CARD)
    per_entry = []
    inner = replicates.replicate_sweep

    def spy(*args, **kwargs):
        if kwargs.get("mesh") is not None:
            return inner(*args, **kwargs)
        before = dict(kl_ell.launches)
        got = inner(*args, **kwargs)
        per_entry.append({k: kl_ell.launches[k] - before[k]
                          for k in MESH_KERNELS})
        return got

    with knobs(CNMF_TPU_BF16_RATIO="0"):
        ref = stages.run("11a sweep, no mesh", lambda: inner(
            Xn, seeds, CONSENSUS_K, **kw))
        kl_ell.reset_launches()
        replicates.replicate_sweep = spy
        try:
            got = stages.run("11a sweep, 2-entry mesh", lambda: inner(
                Xn, seeds, CONSENSUS_K,
                mesh=Mesh([CARD] * 2, ("replicates",)), **kw))
        finally:
            replicates.replicate_sweep = inner
    launches = dict(kl_ell.launches)
    check(len(per_entry) == 2, f"11a: {len(per_entry)} entry sweeps")
    for i, counts in enumerate(per_entry):
        for name in MESH_KERNELS:
            check(counts[name] > 0, f"11a entry {i}: {name} never launched")
    gap = _rel(got[0], ref[0])
    check(got[0].shape == ref[0].shape and gap <= 1e-4,
          f"11a: mesh sweep {got[0].shape} {gap:.3g} from the plain sweep")
    log(f"11a: 20 replicates over a 2-entry mesh, spectra {gap:.3g} from "
        f"the sweep with no mesh (strict f32); launches an entry "
        f"{per_entry}")
    return {"gap": gap, "per_entry": per_entry, "launches": launches}


def rowshard_shards(Xa, stages, rows) -> dict:
    """11b: ``nmf_fit_rowsharded(k=9)`` on the 250,000 x 2,000 CSR (the
    ELL lane) over 1, 2 and 4 cells shards on the card, from one init: the
    objectives and W within the bands of the one-shard solve, and
    ``w_numer`` and ``beta_err_partials`` launched once a shard and pass
    (``h_stats`` at least as often). Shard 0's kernels are held to their
    plain versions on its own encoding (one global width, the shard's
    transpose width) at ``rtol 2e-5``, and timed beside the one-shard
    ones."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh
    from cnmf_torch_tpu_torch.parallel.rowshard import (nmf_fit_rowsharded,
                                                        stream_ell_to_mesh)

    n, g = Xa.shape
    H0, W0 = random_init(SEED, n, g, CONSENSUS_K, float(Xa.sum()) / (n * g))
    init = (H0.numpy(), W0.numpy())
    out = {"solves": {}, "kernels": {}}
    base = None
    gen = torch.Generator().manual_seed(SEED + 11)
    for shards in (1, 2, 4):
        target = CARD if shards == 1 else Mesh([CARD] * shards, ("cells",))
        staged, _ = stages.run(f"11b stage ELL, {shards} shard(s)",
                               lambda: stream_ell_to_mesh(Xa, target))
        parts = staged.parts if shards > 1 else [staged]
        payloads = []
        kl_ell.reset_launches()
        _H, W, err = stages.run(
            f"11b nmf_fit_rowsharded, {shards} shard(s)",
            lambda: nmf_fit_rowsharded(
                staged, CONSENSUS_K, beta_loss="kullback-leibler",
                n_passes=P11_PASSES, init_factors=init, n_orig=n,
                telemetry_sink=payloads.append, device=CARD))
        launches = dict(kl_ell.launches)
        passes = int(payloads[0]["iters"][0])
        trace = payloads[0]["trace"][0]
        check(np.isfinite(W).all() and np.isfinite(err),
              f"11b {shards} shards: nonfinite solve")
        for name in ("w_numer", "beta_err_partials"):
            check(launches[name] == shards * passes,
                  f"11b {shards} shards: {name} launched {launches[name]} "
                  f"times, not once a shard and pass ({shards} x {passes})")
        check(launches["h_stats"] >= shards * passes,
              f"11b {shards} shards: h_stats launched {launches['h_stats']}")
        rec = {"passes": passes, "err": err, "launches": launches,
               "t_width": int(parts[0].rows_t.shape[-1])}
        if base is None:
            base = (W, trace, err)
        else:
            rec["w_gap"] = _rel(W, base[0])
            rec["trace_gap"] = _trace_gap(trace, base[1])
            check(rec["w_gap"] <= P11_W_RTOL
                  and rec["trace_gap"] <= P11_TRACE_RTOL,
                  f"11b {shards} shards against one: W {rec['w_gap']:.3g}, "
                  f"objectives {rec['trace_gap']:.3g}")
        out["solves"][shards] = rec
        # shard 0's kernels at R=1, timed
        x = parts[0]
        nnz = int((x.vals > 0).sum())
        H = (torch.rand((1, x.vals.shape[0], CONSENSUS_K), generator=gen)
             + 0.1).to(CARD)
        Wt = (torch.rand((1, CONSENSUS_K, g), generator=gen) + 0.1).to(CARD)
        tag = f"shard of {shards}"
        errs = {"w_numer": w_numer_check(kl_ell, x, H, Wt, False, tag),
                "beta_err_partials": beta_err_check(kl_ell, x, H, Wt,
                                                    tag)[0]}
        got = kl_ell.h_stats(x.vals, x.cols, H, Wt, False)
        again = kl_ell.h_stats(x.vals, x.cols, H, Wt, False)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"h_stats {tag} not repeatable")
        errs["h_stats"] = max_abs_err(
            got, kl_ell.h_stats_plain(x.vals, x.cols, H, Wt, False), 2e-5)
        del got, again
        for name in MESH_KERNELS:
            r = _time_kernel(kl_ell, name, x, x.vals, H, Wt, False, nnz,
                             with_plain=False)
            out["kernels"][f"{name} {shards}"] = {
                "ms": r["ms"], "bound_ms": r["bound_ms"],
                "max_abs_err": errs[name],
                "rows": int(x.vals.shape[0]), "t_width": rec["t_width"]}
            rows.append(f"  {name:18s} {tag}: "
                        f"{x.vals.shape[0]} rows, t_width {rec['t_width']}: "
                        f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms), "
                        f"max_abs_err {errs[name]:.3g} against plain")
        del staged, parts, x, H, Wt
        torch.cuda.empty_cache()
        log(f"11b {shards} shard(s): {rec}")
    return out


def mesh_2d_sweep(Xa, stages) -> dict:
    """11c: ``replicate_sweep_2d`` on a 2 x 2 mesh on the card (dense
    staging, two replicates), each replicate against the one-shard ELL
    solve from the same seed."""
    from cnmf_torch_tpu_torch.parallel.multihost import (mesh_2d,
                                                         replicate_sweep_2d,
                                                         stage_x_2d)
    from cnmf_torch_tpu_torch.parallel.rowshard import (nmf_fit_rowsharded,
                                                        stream_ell_to_mesh)

    mesh = mesh_2d(devices=[CARD] * 4, replicate_shards=2)
    staged = stages.run("11c stage 2x2 (dense)",
                        lambda: stage_x_2d(Xa, mesh))
    seeds = [SEED, SEED + 1]
    spectra, errs = stages.run("11c replicate_sweep_2d, 2 replicates",
                               lambda: replicate_sweep_2d(
                                   staged, seeds, CONSENSUS_K, mesh,
                                   beta_loss="kullback-leibler",
                                   n_passes=P11_PASSES))
    del staged
    torch.cuda.empty_cache()
    x1, _ = stream_ell_to_mesh(Xa, CARD)
    gaps = []
    for r, s in enumerate(seeds):
        _H, W, err = stages.run(f"11c one-shard solve, seed {s}",
                                lambda: nmf_fit_rowsharded(
                                    x1, CONSENSUS_K,
                                    beta_loss="kullback-leibler", seed=s,
                                    n_passes=P11_PASSES, device=CARD))
        gaps.append((_rel(spectra[r], W), abs(float(errs[r]) - err) / err))
        check(gaps[-1][0] <= P11_W_RTOL and gaps[-1][1] <= P11_TRACE_RTOL,
              f"11c replicate {r} against the one-shard solve: {gaps[-1]}")
    log(f"11c: 2 x 2 mesh, (W, objective) gaps to the one-shard solve "
        f"{gaps}")
    return {"gaps": gaps}


def grid_phase(Xa, counts_fn, stages) -> dict:
    """11d: ``nmf_fit_grid2d`` on a 2 x 2 grid on the card against the
    one-shard dense solve over the same passes; no kernel launches; the
    ``collective`` event's bytes are ``coll_bytes_per_pass``; one pass
    timed with the overlap on and off (``measure_collectives``); then a
    grid factorize of phase 3's counts (K=9, 2 replicates) through ``cNMF``
    with its ``perf_model`` event gated."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel.grid2d import (coll_bytes_per_pass,
                                                      measure_collectives,
                                                      mesh_grid2d,
                                                      nmf_fit_grid2d,
                                                      stage_x_grid)
    from cnmf_torch_tpu_torch.parallel.rowshard import (nmf_fit_rowsharded,
                                                        stream_rows_to_mesh)
    from cnmf_torch_tpu_torch.utils import telemetry

    n, g = Xa.shape
    H0, W0 = random_init(SEED, n, g, CONSENSUS_K, float(Xa.sum()) / (n * g))
    init = (H0.numpy(), W0.numpy())
    mesh = mesh_grid2d(2, 2, devices=[CARD] * 4)
    gx, _, _ = stages.run("11d stage grid 2x2",
                          lambda: stage_x_grid(Xa, mesh))
    rec = EventRecorder()
    kl_ell.reset_launches()
    _H, Wg, eg = stages.run("11d nmf_fit_grid2d 2x2", lambda: nmf_fit_grid2d(
        gx, CONSENSUS_K, mesh, beta_loss="kullback-leibler",
        n_passes=P11_GRID_PASSES, init_factors=init, n_orig=n, g_orig=g,
        events=rec))
    launches = dict(kl_ell.launches)
    check(sum(launches.values()) == 0, f"11d: the grid launched {launches}")
    colls = [e for e in rec.events if e["t"] == "collective"]
    check(len(colls) == 1, f"11d: collective events {colls}")
    ctx = colls[0]["context"]
    want = coll_bytes_per_pass(gx.rows_per, gx.cols_per, CONSENSUS_K, 1.0,
                               ctx["blocks"][0], ctx["blocks"][1], 4)
    check(colls[0]["nbytes"] == want,
          f"11d: collective bytes {colls[0]['nbytes']} != {want}")
    coll = stages.run("11d measure_collectives 2x2, overlap on and off",
                      lambda: measure_collectives(gx, CONSENSUS_K, beta=1.0,
                                                  repeats=5))
    check(coll["nbytes_per_pass"] == want,
          f"11d: measure_collectives bytes {coll['nbytes_per_pass']}")
    log(f"11d: one grid pass, overlap on {coll['pass_overlap_s']} s, off "
        f"{coll['pass_serial_s']} s (medians of 5); the sums alone "
        f"{coll['coll_s']} s, hidden fraction "
        f"{coll['pass_hidden_fraction']}")
    del gx
    torch.cuda.empty_cache()
    Xd, _ = stream_rows_to_mesh(Xa, CARD)
    _H, W1, e1 = stages.run("11d one-shard dense solve", lambda: (
        nmf_fit_rowsharded(Xd, CONSENSUS_K, beta_loss="kullback-leibler",
                           n_passes=P11_GRID_PASSES, init_factors=init,
                           device=CARD)))
    del Xd
    torch.cuda.empty_cache()
    w_gap, e_gap = _rel(Wg, W1), abs(eg - e1) / e1
    check(w_gap <= P11_W_RTOL and e_gap <= P11_TRACE_RTOL,
          f"11d: grid against the one-shard solve W {w_gap:.3g}, "
          f"objective {e_gap:.3g}")
    log(f"11d: 2 x 2 grid, {P11_GRID_PASSES} passes in "
        f"{colls[0]['wall_s']:.3f} s, W {w_gap:.3g} and objective "
        f"{e_gap:.3g} from the one-shard dense solve; collective bytes a "
        f"pass {want} (blocks {ctx['blocks']}, overlap {ctx['overlap']})")
    obj = prepared_run("grid", counts_fn, [CONSENSUS_K], "kullback-leibler",
                       n_iter=2)
    kl_ell.reset_launches()
    with knobs(CNMF_TPU_TELEMETRY="1", CNMF_TPU_PERF_MODEL="1"):
        stages.run("11d grid factorize (cNMF, K=9)", lambda: obj.factorize(
            mesh=mesh_grid2d(2, 2, devices=[CARD] * 4)))
    check(sum(kl_ell.launches.values()) == 0,
          f"11d: the grid factorize launched {dict(kl_ell.launches)}")
    check(obj.factorize_info["mode"] == "grid2d",
          f"11d: factorize ran {obj.factorize_info['mode']}")
    events = telemetry.read_events(obj._events.path)
    pm = perf_model_gate(events, "factorize_grid2d", "grid2d", "11d")
    return {"w_gap": w_gap, "err_gap": e_gap, "wall_s": colls[0]["wall_s"],
            "coll_bytes": want, "overlap": coll, "perf_model": pm}


def elastic_phase(atlas, stages) -> dict:
    """11e: one replicate of 9a's store-backed run factorized on a 4-shard
    cells mesh with a ``hostloss`` fault after the first pass: re-meshed
    over the survivors, resumed from the pass checkpoint, ``host_loss``
    and ``remesh`` events, finite non-negative spectra."""
    from cnmf_torch_tpu_torch import load_df_from_npz
    from cnmf_torch_tpu_torch.models.cnmf import _ledger_ints
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh
    from cnmf_torch_tpu_torch.utils import telemetry

    obj2 = atlas[2]
    with knobs(CNMF_TPU_TELEMETRY="1",
               CNMF_TPU_FAULT_SPEC="hostloss:context=pass,after=1"):
        stages.run("11e factorize, hostloss on 4 shards", lambda: (
            obj2.factorize(worker_i=0, total_workers=len(ATLAS_KS)
                           * ATLAS_REPLICATES, rowshard=True,
                           mesh=Mesh([CARD] * 4, ("cells",)))))
    info = obj2.factorize_info
    every = telemetry.read_events(obj2._events.path)
    resumes = [e["context"] for e in every if e["t"] == "checkpoint"
               and e.get("action") == "resume"]
    check(resumes and resumes[-1]["pass_idx"] >= 1,
          f"11e: checkpoint resume events {resumes}")
    events = [e for e in every if e["t"] == "fault"]
    kinds = [e["kind"] for e in events]
    remesh = [e["context"] for e in events if e["kind"] == "remesh"]
    check("host_loss" in kinds and remesh
          and (remesh[-1]["from_devices"], remesh[-1]["to_devices"])
          == (4, 3) and info["mesh_devices_final"] == 3,
          f"11e: fault events {kinds}, remesh {remesh}, final mesh "
          f"{info.get('mesh_devices_final')}")
    ledger = load_df_from_npz(obj2.paths["nmf_replicate_parameters"])
    k = int(_ledger_ints(ledger, "n_components")[0])
    it = int(_ledger_ints(ledger, "iter")[0])
    W = load_df_from_npz(obj2.paths["iter_spectra"] % (k, it)).values
    check(np.isfinite(W).all() and (W >= 0).all(),
          "11e: the re-meshed replicate's spectra are not finite and "
          "non-negative")
    log(f"11e: host loss after pass 1 re-meshed {remesh[-1]}, resumed "
        f"from pass {resumes[-1]['pass_idx']}; spectra {W.shape} of k={k} "
        f"iter {it} finite and non-negative")
    return {"faults": kinds, "remesh": remesh[-1],
            "resumed_from_pass": resumes[-1]["pass_idx"]}


def _spawn_ranks(argv_of, timeout=300):
    """Start one process a rank, wait for all (killing every one on the
    first failure or past ``timeout``); returns their return codes."""
    procs = [subprocess.Popen(argv) for argv in argv_of]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            check(time.monotonic() - t0 < timeout,
                  f"ranks still running after {timeout} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def mesh_rank_main(rank: int, world: int, port: int, out: str,
                   device: str) -> int:
    """One rank of 11f's two-process ELL solve (``chip_smoke.py
    --mesh-rank R --mesh-world N --mesh-port P --mesh-out DIR
    --mesh-device D``): joins the mesh, solves phase 3's matrix on its
    cells shard and writes its launches, W and collective events."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh, global_devices
    from cnmf_torch_tpu_torch.parallel.multihost import (
        initialize_distributed)
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device)
    from cnmf_torch_tpu_torch.parallel.mesh import backend

    X = sp.load_npz(os.path.join(out, "X.npz")).tocsr()
    init = np.load(os.path.join(out, "init.npz"))
    devices, owners = global_devices([torch.device(device)])
    mesh = Mesh(devices, ("cells",), owners=owners)
    if torch.device(device).type == "cuda":
        kl_ell.build()
    kl_ell.reset_launches()
    rec = EventRecorder()
    _H, W, err = nmf_fit_rowsharded(
        X, CONSENSUS_K, beta_loss="kullback-leibler", n_passes=P11_PASSES,
        init_factors=(init["H0"], init["W0"]), mesh=mesh, events=rec)
    np.save(os.path.join(out, f"W{rank}.npy"), W)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": dict(kl_ell.launches), "err": err,
                   "backend": backend(),
                   "collectives": [e for e in rec.events
                                   if e["t"] == "collective"]}, f)
    return 0


def two_processes(counts_fn, Xn, stages) -> dict:
    """11f: ``run_parallel --engine multihost`` with two processes on the
    card (one cells shard each, a gloo group) running a row-sharded KL
    factorize of phase 3's counts (K=9, 2 replicates): the cross-process
    ``all_reduce`` ran (``collective`` events), and the spectra equal a
    one-process run over two shards. Then two ranks solve phase 3's CSR
    on the ELL lane over the same two-process mesh: the three kernels
    launch in each, and W is the one-process two-shard solve's."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch import cNMF, load_df_from_npz
    from cnmf_torch_tpu_torch.launcher import run_pipeline
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded
    from cnmf_torch_tpu_torch.utils import telemetry

    prep = dict(components=[CONSENSUS_K], n_iter=2, seed=SEED,
                numgenes=N_HVG, beta_loss="kullback-leibler",
                batch_size=CHUNK)
    with knobs(CNMF_TPU_TELEMETRY="1"):
        stages.run("11f run_parallel --engine multihost (2 processes)",
                   lambda: run_pipeline(
                       counts_fn, OUT, "mh", total_workers=2,
                       engine="multihost", factorize_flags=["--rowshard"],
                       device=CARD, timeout_s=600, **prep))
    mh = cNMF(OUT, "mh", device=CARD)
    colls = [e for e in telemetry.read_events(mh._events.path)
             if e["t"] == "collective"]
    check(colls and all(c["context"]["backend"] == "gloo"
                        and c["context"]["processes"] == 2
                        and c["context"]["all_reduces"] > 0
                        for c in colls),
          f"11f: collective events {colls}")
    one = cNMF(OUT, "mh1", device=CARD)
    one.prepare(counts_fn, components=prep["components"],
                n_iter=prep["n_iter"], seed=SEED, num_highvar_genes=N_HVG,
                beta_loss="kullback-leibler", batch_size=CHUNK)
    stages.run("11f one process, 2 shards", lambda: one.factorize(
        rowshard=True, mesh=Mesh([CARD] * 2, ("cells",))))
    gaps = []
    for it in range(prep["n_iter"]):
        a = load_df_from_npz(mh.paths["iter_spectra"]
                             % (CONSENSUS_K, it)).values
        b = load_df_from_npz(one.paths["iter_spectra"]
                             % (CONSENSUS_K, it)).values
        gaps.append(_rel(a, b))
    check(max(gaps) <= P11_PROC_RTOL,
          f"11f: two processes against one process {gaps}")
    # the ELL lane over the two-process mesh
    sub = os.path.join(OUT, "mesh_ranks")
    os.makedirs(sub, exist_ok=True)
    n, g = Xn.shape
    H0, W0 = random_init(SEED, n, g, CONSENSUS_K, float(Xn.sum()) / (n * g))
    sp.save_npz(os.path.join(sub, "X.npz"), Xn.tocsr())
    np.savez(os.path.join(sub, "init.npz"), H0=H0.numpy(), W0=W0.numpy())
    from cnmf_torch_tpu_torch.launcher import _free_port

    port = _free_port()
    rcs = stages.run("11f two ranks, ELL solve", lambda: _spawn_ranks(
        [[sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
          "--mesh-world", "2", "--mesh-port", str(port), "--mesh-out", sub,
          "--mesh-device", CARD] for r in range(2)]))
    check(rcs == [0, 0], f"11f ranks exited {rcs}")
    ranks = []
    for r in range(2):
        with open(os.path.join(sub, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        for name in MESH_KERNELS:
            check(ranks[r]["launches"][name] > 0,
                  f"11f rank {r}: {name} never launched")
        check(ranks[r]["backend"] == "gloo" and ranks[r]["collectives"],
              f"11f rank {r}: backend {ranks[r]['backend']}, collectives "
              f"{ranks[r]['collectives']}")
    _H, W1, _e = nmf_fit_rowsharded(
        Xn, CONSENSUS_K, beta_loss="kullback-leibler", n_passes=P11_PASSES,
        init_factors=(H0.numpy(), W0.numpy()),
        mesh=Mesh([CARD] * 2, ("cells",)))
    ell_gap = max(_rel(np.load(os.path.join(sub, f"W{r}.npy")), W1)
                  for r in range(2))
    check(ell_gap <= P11_PROC_RTOL,
          f"11f: two-rank ELL solve {ell_gap:.3g} from one process")
    log(f"11f: multihost factorize spectra {gaps} from one process over "
        f"two shards; {len(colls)} collective events "
        f"({colls[0]['context']['all_reduces']} all_reduces, "
        f"{colls[0]['nbytes']} bytes in the first); ELL ranks' launches "
        f"{[r['launches'] for r in ranks]}, W {ell_gap:.3g} from one "
        f"process")
    return {"spectra_gaps": gaps, "collectives": len(colls),
            "rank_launches": [r["launches"] for r in ranks],
            "ell_gap": ell_gap}


def subprocess_workers(counts_fn, stages) -> dict:
    """11g: ``run_parallel --engine subprocess`` with 2 workers on phase
    3's counts (K in {5, 9}, 4 replicates) under strict f32, its merged
    spectra against a single-worker run's."""
    from cnmf_torch_tpu_torch import cNMF, load_df_from_npz
    from cnmf_torch_tpu_torch.launcher import run_pipeline

    ks = [5, CONSENSUS_K]
    prep = dict(components=ks, n_iter=4, seed=SEED, numgenes=N_HVG,
                beta_loss="kullback-leibler", batch_size=CHUNK)
    with knobs(CNMF_TPU_BF16_RATIO="0"):
        stages.run("11g run_parallel --engine subprocess (2 workers)",
                   lambda: run_pipeline(counts_fn, OUT, "sp",
                                        total_workers=2, device=CARD,
                                        **prep))
        one = cNMF(OUT, "sp1", device=CARD)
        one.prepare(counts_fn, components=ks, n_iter=4, seed=SEED,
                    num_highvar_genes=N_HVG, beta_loss="kullback-leibler",
                    batch_size=CHUNK)
        stages.run("11g one worker", one.factorize)
        one.combine()
    sp_ = cNMF(OUT, "sp", device=CARD)
    gaps = {k: _rel(load_df_from_npz(sp_.paths["merged_spectra"] % k).values,
                    load_df_from_npz(one.paths["merged_spectra"] % k).values)
            for k in ks}
    check(max(gaps.values()) <= 1e-4,
          f"11g: two workers against one {gaps}")
    log(f"11g: merged spectra of 2 workers against 1: {gaps}")
    return {"gaps": gaps}


def phase11(stages, counts_fn, Xn, atlas, rows) -> dict:
    """The multi-device layer on the one card, every mesh repeating it."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    out = {}
    out["a"] = replicate_axis(Xn, stages)
    Xa = atlas[1]._read_norm_counts().X.tocsr()
    out["b"] = rowshard_shards(Xa, stages, rows)
    out["c"] = mesh_2d_sweep(Xa, stages)
    out["d"] = grid_phase(Xa, counts_fn, stages)
    del Xa
    out["e"] = elastic_phase(atlas, stages)
    out["f"] = two_processes(counts_fn, Xn, stages)
    out["g"] = subprocess_workers(counts_fn, stages)
    # this process's launches on the phase's main paths (11a's mesh sweep
    # and 11b's solves; the children's are in 11f's rank records)
    out["launches"] = {name: int(out["a"]["launches"][name])
                       + sum(int(r["launches"][name])
                             for r in out["b"]["solves"].values())
                       for name in kl_ell.KERNELS}
    return out


# -- phase 12: serving and the fleet -------------------------------------------

SERVE_SIZES = [33, 256, 1_000, 5_000, 7_500]   # 7,500 rows is two lanes
SERVE_REQUESTS = 64
SERVE_THREADS = 8
SERVE_TENANTS = 4
SERVE_BATCH = 8
SERVE_LINGER_MS = 2.0
SERVE_REPEATS = 8
SERVE_B2_REQUESTS = 16
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6
SERVE_BUCKET_LANES = [1, 2, 4, 8]
SERVE_BUCKET_ROWS = [64, 256, 1_024, 5_000]
FLEET_SIZES = [33, 256, 1_000]
FLEET_QUERIES = 12
FLEET_TENANTS = 4
FLEET_HEALTH_S = 0.25
FLEET_DEATH_AFTER = 8          # supervision ticks of slot 0 before its kill
# a replica took 13.8 s to respawn and two 18.8 s to warm for a rollover
# on an H100 at 700 W: about four times that
FLEET_WARM_TIMEOUT_S = 80.0
FLEET_DEADLINE_S = 150.0


def serve_rows(Xn, n: int, i: int) -> np.ndarray:
    """Request ``i`` of ``n`` rows: a dense f32 window of phase 3's
    normalized HVG counts, starting at a row that moves with ``i``."""
    lo = (i * 997) % (Xn.shape[0] - n + 1)
    return np.asarray(Xn[lo:lo + n].toarray(), dtype=np.float32)


def serve_solo(ref, X, H_init=None):
    """The port's solo refit on the card: ``cNMF.refit_usage``'s
    ``fit_h`` with the reference's parameters, from the same default
    init (or ``H_init``)."""
    from cnmf_torch_tpu_torch.ops.nmf import fit_h

    return fit_h(X, ref.W, H_init=H_init, chunk_size=ref.chunk_size,
                 chunk_max_iter=ref.chunk_max_iter, h_tol=ref.h_tol,
                 l1_reg_H=ref.l1_H, l2_reg_H=0.0, beta=ref.beta,
                 device=CARD)


def solo_gap(H, want, label) -> float:
    """Max relative gap of a reply to its solo refit; fails outside
    ``SERVE_RTOL``/``SERVE_ATOL``."""
    diff = np.abs(H - want)
    bad = diff > SERVE_ATOL + SERVE_RTOL * np.abs(want)
    check(H.shape == want.shape and not bad.any(),
          f"{label}: {int(bad.sum())} of {want.size} usage entries outside "
          f"rtol {SERVE_RTOL} of solo fit_h (max diff {float(diff.max())})")
    return float((diff / (np.abs(want) + SERVE_ATOL)).max())


def _threads(fns, timeout=120.0):
    threads = [__import__("threading").Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        check(not t.is_alive(), "a client thread passed its deadline")


def bucket_times(ref, Xn) -> dict:
    """The batched program's solve time at every ``(lanes, rows)`` bucket
    of the daemon, on rows of phase 3's counts (CUDA events, median of 5
    after one warm call)."""
    from cnmf_torch_tpu_torch.ops.nmf import fit_h_default_init
    from cnmf_torch_tpu_torch.serving.batcher import batched_project

    init = fit_h_default_init(max(SERVE_BUCKET_ROWS), ref.k).numpy()
    out = {}
    for b in SERVE_BUCKET_LANES:
        for n in SERVE_BUCKET_ROWS:
            Xb = torch.from_numpy(np.stack(
                [serve_rows(Xn, n, 31 * b + i) for i in range(b)])).to(CARD)
            Hb = torch.from_numpy(
                np.broadcast_to(init[:n], (b, n, ref.k)).copy()).to(CARD)

            def solve():
                return batched_project(
                    Xb, Hb, ref.Wd, ref.WWT, ref.w_colsum, ref.h_tol_dev,
                    beta=ref.beta, max_iter=ref.chunk_max_iter,
                    l1=ref.l1_H, l2=0.0)

            out[f"{b}x{n}"] = cuda_ms(solve, iters=5, warmup=1)
            del Xb, Hb
    return out


def serve_load(ref, Xn, sock, n_requests, label, events=None) -> dict:
    """A ``ServeDaemon`` over ``ref`` on ``sock`` under ``n_requests``
    requests from ``SERVE_THREADS`` client threads and ``SERVE_TENANTS``
    tenants (sizes in turn, dense f32 on the b64 wire); every reply held
    to its solo refit. Then the repeats (warm starts) and the poison
    tenant. Returns the daemon's stats and the client-side numbers."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.serving import (PoisonError,
                                              ProjectionService,
                                              QuarantinedError, ServeClient,
                                              ServeDaemon)

    kl_ell.reset_launches()
    svc = ProjectionService(ref, device=CARD, max_batch=SERVE_BATCH,
                            linger_ms=SERVE_LINGER_MS, events=events)
    daemon = ServeDaemon(svc, socket_path=sock)
    t0 = time.perf_counter()
    daemon.start()
    start_s = time.perf_counter() - t0
    sizes = SERVE_SIZES
    reqs = [(f"tenant-{i % SERVE_TENANTS}", sizes[i % len(sizes)], i)
            for i in range(n_requests)]
    replies = [None] * n_requests
    lat = [0.0] * n_requests
    errors = []

    def worker(w):
        cli = ServeClient(socket_path=sock, timeout=120.0)
        for j in range(w, n_requests, SERVE_THREADS):
            tenant, n, i = reqs[j]
            try:
                t = time.perf_counter()
                replies[j] = cli.project(serve_rows(Xn, n, i), tenant=tenant)
                lat[j] = (time.perf_counter() - t) * 1e3
            except Exception as exc:
                errors.append(f"request {j}: {exc!r}")

    try:
        t_load = time.perf_counter()
        _threads([lambda w=w: worker(w) for w in range(SERVE_THREADS)])
        load_s = time.perf_counter() - t_load
        check(not errors, f"{label}: {errors[:3]}")
        gaps, identical = [], 0
        for (tenant, n, i), (H, meta) in zip(reqs, replies):
            want = serve_solo(ref, serve_rows(Xn, n, i))
            gaps.append(solo_gap(H, want, f"{label} request {i} ({n} rows)"))
            identical += int(np.array_equal(H, want))
        multi = sum(1 for _, meta in replies if meta["batch_requests"] > 1)
        # repeats: the same tenant sends a matrix again and is warm-started
        cli = ServeClient(socket_path=sock, timeout=120.0)
        warm_gaps = []
        for j in range(SERVE_REPEATS if events is not None else 0):
            tenant, n, i = reqs[j]
            X = serve_rows(Xn, n, i)
            H, meta = cli.project(X, tenant=tenant)
            check(meta["warm_start"], f"{label}: repeat {j} not warm-started")
            warm_gaps.append(solo_gap(
                H, serve_solo(ref, X, H_init=replies[j][0]),
                f"{label} warm repeat {j}"))
        # the poison tenant: a NaN request among good ones from others
        poison = {}
        if events is not None:
            bad = serve_rows(Xn, 256, 5)
            bad[3, 7] = np.nan
            mates = [(f"mate-{m}", serve_rows(Xn, 256, 100 + m))
                     for m in range(3)]
            got = {}

            def send(tenant, X):
                try:
                    got[tenant] = ServeClient(
                        socket_path=sock, timeout=120.0).project(
                            X, tenant=tenant)
                except Exception as exc:
                    got[tenant] = exc

            _threads([lambda: send("toxic", bad)]
                     + [lambda t=t, X=X: send(t, X) for t, X in mates])
            check(isinstance(got["toxic"], PoisonError),
                  f"{label}: NaN request answered {got['toxic']!r}")
            shared = 0
            for t, X in mates:
                H, meta = got[t]
                solo_gap(H, serve_solo(ref, X), f"{label} {t}")
                shared += int(meta["batch_requests"] > 1)
            for _ in range(2):
                try:
                    cli.project(bad, tenant="toxic")
                    check(False, f"{label}: a poison request was served")
                except PoisonError:
                    pass
            status, body = cli._request(
                "POST", "/project",
                {"tenant": "toxic", "data": serve_rows(Xn, 33, 1).tolist()})
            check(status == 403 and body["status"] == "quarantined",
                  f"{label}: the third strike's tenant got {status} {body}")
            try:
                cli.project(serve_rows(Xn, 33, 2), tenant="toxic")
                check(False, f"{label}: a quarantined tenant was served")
            except QuarantinedError:
                pass
            poison = {"mates_batched_with_others": shared,
                      "strikes_then": status}
        stats = cli.stats()
    finally:
        daemon.close()
    if events is not None:
        svc.emit_perf_model()
    launches = dict(kl_ell.launches)
    check(sum(launches.values()) == 0,
          f"{label}: the serve path launched kernels {launches}")
    check(stats["cold_dispatches_after_warmup"] == 0,
          f"{label}: {stats['cold_dispatches_after_warmup']} cold dispatches")
    check(multi > 0 and stats["multi_request_batches"] > 0,
          f"{label}: no batch held more than one request")
    cells = sum(n for _, n, _ in reqs)
    out = {"requests": n_requests, "threads": SERVE_THREADS,
           "tenants": SERVE_TENANTS, "sizes": list(sizes),
           "daemon_start_s": start_s, "warmup_s": stats["warmup_s"],
           "load_s": load_s, "requests_per_s": n_requests / load_s,
           "cells_per_s": cells / load_s,
           "client_ms": {"p50": float(np.percentile(lat, 50)),
                         "p95": float(np.percentile(lat, 95)),
                         "p99": float(np.percentile(lat, 99))},
           "daemon_latency_ms": stats["latency_ms"],
           "batches": stats["batches"], "mean_lanes": stats["mean_lanes"],
           "max_lanes": stats["max_lanes"],
           "multi_request_batches": stats["multi_request_batches"],
           "replies_batched_with_others": multi,
           "bit_identical_to_solo": identical,
           "max_rel_gap_to_solo": max(gaps),
           "warm_started": stats["warm_started"],
           "max_rel_gap_warm": max(warm_gaps) if warm_gaps else None,
           "poison": poison, "launches": launches}
    log(f"{label}: {n_requests} requests in {load_s:.3f} s "
        f"({out['requests_per_s']:.1f} requests/s, "
        f"{out['cells_per_s']:.0f} cells/s); client p50/p95/p99 "
        f"{out['client_ms']['p50']:.2f}/{out['client_ms']['p95']:.2f}/"
        f"{out['client_ms']['p99']:.2f} ms (in the daemon "
        f"{stats['latency_ms'].get('p50', 0):.2f}/"
        f"{stats['latency_ms'].get('p99', 0):.2f}); {stats['batches']} "
        f"batches, "
        f"mean lanes {stats['mean_lanes']}, {stats['multi_request_batches']}"
        f" with more than one request; warmup {stats['warmup_s']:.3f} s; "
        f"{identical}/{n_requests} replies bit-identical to solo, max "
        f"relative gap {max(gaps):.3g}")
    return out


def serve_phase(stages, Xn) -> dict:
    """12a: the daemon over phase 3's k=9 consensus reference (KL) under
    load, its events and report; the bucket times."""
    from cnmf_torch_tpu_torch.serving import load_reference
    from cnmf_torch_tpu_torch.utils.telemetry import (EventLog, read_events,
                                                      render_report,
                                                      validate_events_file)

    run = os.path.join(OUT, "serve12")
    os.makedirs(os.path.join(run, "cnmf_tmp"), exist_ok=True)
    ref = load_reference(os.path.join(OUT, "pipeline"), k=CONSENSUS_K,
                         density_threshold=0.5)
    check((ref.beta, ref.k, ref.n_genes, ref.chunk_size)
          == (1.0, CONSENSUS_K, Xn.shape[1], CHUNK),
          f"12a reference {ref.describe()}")
    with knobs(CNMF_TPU_TELEMETRY="1", CNMF_TPU_PERF_MODEL="1"):
        ev_path = os.path.join(run, "cnmf_tmp", "serve12.events.jsonl")
        events = EventLog(ev_path, manifest_extra={"run_name": "serve12",
                                                   "role": "serve"},
                          device=CARD)
        out = stages.run("serve 12a daemon under load", lambda: serve_load(
            ref, Xn, os.path.join(OUT, "serve12.sock"), SERVE_REQUESTS,
            "12a", events=events))
    out["bucket_ms"] = stages.run("serve 12a bucket times",
                                  lambda: bucket_times(ref, Xn))
    log("12a solve ms by bucket (lanes x rows): " + ", ".join(
        f"{key} {ms:.3f}" for key, ms in out["bucket_ms"].items()))
    check(validate_events_file(ev_path) > 0, "12a events do not validate")
    evs = read_events(ev_path)
    kinds = {e["t"] for e in evs}
    check({"manifest", "serve_request", "serve_batch", "fault"} <= kinds,
          f"12a event kinds {sorted(kinds)}")
    pms = [e for e in evs if e["t"] == "perf_model"]
    check(len(pms) == 1 and pms[0]["stage"] == "serve",
          f"12a perf_model events {pms}")
    pred = pms[0]["predicted"]
    check(all(np.isfinite(pred[key]) and pred[key] > 0
              for key in ("flops", "bytes")),
          f"12a perf_model predictions {pred}")
    # priced at the iteration cap, so its fractions overstate the work:
    # logged, not gated
    out["perf_model"] = {"predicted": pred,
                         "measured": pms[0]["measured"],
                         "roofline": pms[0]["roofline"]}
    log(f"12a perf_model (iteration cap priced): {out['perf_model']}")
    report = render_report(run)
    check("Serving (projection daemon)" in report,
          "12a report has no serving section")
    with open(os.path.join(OUT, "phase12_report.txt"), "w") as f:
        f.write(report)
    out["peak_gib"] = stages.rows[-2][2]
    out["events"] = len(evs)
    ref.Wd = ref.WWT = ref.w_colsum = ref.h_tol_dev = None
    return out


def serve_b2_phase(stages, Xn) -> dict:
    """12b: phase 5's Frobenius k=9 consensus reference, ``W W^T``
    resident, under the same gates."""
    from cnmf_torch_tpu_torch.serving import load_reference

    ref = load_reference(os.path.join(OUT, "frobenius"), k=CONSENSUS_K,
                         density_threshold=0.5)
    check(ref.beta == 2.0, f"12b reference beta {ref.beta}")
    out = stages.run("serve 12b beta=2 daemon", lambda: serve_load(
        ref, Xn, os.path.join(OUT, "serve12b.sock"), SERVE_B2_REQUESTS,
        "12b"))
    check(ref.WWT is not None and ref.WWT.shape == (1, ref.k, ref.k)
          and ref.w_colsum is None, "12b: W W^T is not resident")
    ref.Wd = ref.WWT = ref.h_tol_dev = None
    return out


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _children(pid) -> list:
    """The live child processes of ``pid`` (from ``/proc``)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().split(")")[-1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def _stop_fleet(proc, pids):
    """Stop a fleet started by 12c on any path: SIGTERM (the router
    drains its replicas), then SIGKILL for the fleet and every replica
    still alive."""
    if proc.poll() is None:
        kids = _children(proc.pid)
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        pids.update(kids)
    for pid in pids:
        if _alive(pid):
            try:
                os.kill(pid, 9)
            except OSError:
                pass


def _p99(vals):
    return float(np.percentile(vals, 99)) if vals else None


def fleet_phase(stages, Xn) -> dict:
    """12c: ``fleet`` over phase 3's run as a subprocess (two ``serve``
    subprocesses on the card), a ``replicadeath`` under load from four
    tenants, a rollover to phase 4's k=9 consensus spectra, then a poison
    tenant and a clean shutdown."""
    import threading

    from cnmf_torch_tpu_torch.serving import load_reference
    from cnmf_torch_tpu_torch.serving.fleet import FleetClient
    from cnmf_torch_tpu_torch.utils.telemetry import (read_events,
                                                      validate_events_file)

    run_dir = os.path.join(OUT, "pipeline")
    v2_path = os.path.join(OUT, "batch", "cnmf_tmp",
                           "batch.spectra.k_9.dt_0_5.consensus.df.npz")
    refs = [load_reference(run_dir, k=CONSENSUS_K, density_threshold=0.5),
            load_reference(run_dir, spectra_path=v2_path)]
    check(refs[0].genes == refs[1].genes, "12c: v2 has other genes")
    queries = [serve_rows(Xn, FLEET_SIZES[i % len(FLEET_SIZES)], 500 + i)
               for i in range(FLEET_QUERIES)]
    wants = [[serve_solo(r, X) for X in queries] for r in refs]
    ev_path = os.path.join(run_dir, "cnmf_tmp", "pipeline.fleet.events.jsonl")
    if os.path.exists(ev_path):
        os.unlink(ev_path)
    sock = os.path.join(OUT, "fleet12.sock")
    env = dict(os.environ, CNMF_TPU_TELEMETRY="1",
               CNMF_TPU_SERVE_WARM_START="0",
               CNMF_TPU_FLEET_HEALTH_S=str(FLEET_HEALTH_S),
               CNMF_TPU_FLEET_WARM_TIMEOUT_S=str(FLEET_WARM_TIMEOUT_S),
               CNMF_TPU_FAULT_SPEC=f"replicadeath:context=fleet,worker=0,"
                                   f"after={FLEET_DEATH_AFTER}",
               PYTHONPATH=os.pathsep.join(
                   [HERE] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    log_f = open(os.path.join(OUT, "fleet12.log"), "wb")
    t_spawn = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", "fleet", run_dir,
         "-k", str(CONSENSUS_K), "--local-density-threshold", "0.5",
         "--replicas", "2", "--socket", sock, "--device", CARD],
        stdout=log_f, stderr=subprocess.STDOUT, env=env, cwd=HERE)
    pids, records, errors = set(), [], []
    stop = threading.Event()
    cli = FleetClient(socket_path=sock, timeout=120.0)
    out = {}
    try:
        deadline = time.monotonic() + FLEET_DEADLINE_S
        while True:
            check(proc.poll() is None, "12c: the fleet exited while "
                  "warming (build/chip_smoke/fleet12.log)")
            try:
                if cli.healthz()["replicas_up"] == 2:
                    break
            except (OSError, ValueError):
                pass
            check(time.monotonic() < deadline, "12c: fleet never healthy")
            time.sleep(0.1)
        out["fleet_start_s"] = time.perf_counter() - t_spawn

        def tenant(t):
            c = FleetClient(socket_path=sock, timeout=120.0)
            i = t
            while not stop.is_set():
                j = i % FLEET_QUERIES
                t0 = time.time()
                try:
                    H, meta = c.project(queries[j], tenant=f"tenant-{t}")
                    records.append((t0, time.time(), j,
                                    meta.get("generation"), H))
                except Exception as exc:
                    errors.append(f"tenant-{t} query {j}: {exc!r}")
                i += FLEET_TENANTS

        threads = [threading.Thread(target=tenant, args=(t,))
                   for t in range(FLEET_TENANTS)]
        for th in threads:
            th.start()

        def poll():
            st = cli.stats()
            pids.update(r["pid"] for r in st["replicas"]
                        if r["pid"] is not None)
            return st

        st = poll()
        while st["replica_deaths"] < 1:
            check(time.monotonic() < deadline, "12c: no replica death")
            time.sleep(0.05)
            st = poll()
        t_dead = time.time()
        while not (st["replicas_up"] == 2
                   and all(r["in_ring"] for r in st["replicas"])):
            check(time.monotonic() < deadline, "12c: no respawn")
            time.sleep(0.05)
            st = poll()
        t_back = time.time()
        time.sleep(0.5)
        t_roll = time.time()
        roll = cli.rollover(v2_path)
        t_rolled = time.time()
        poll()
        time.sleep(0.5)
        stop.set()
        for th in threads:
            th.join(timeout=120.0)
            check(not th.is_alive(), "12c: a tenant passed its deadline")
        check(not errors, f"12c: {len(errors)} failed requests: "
              f"{errors[:3]}")
        # every reply is one reference's solo refit, the one it names
        by_gen = {0: 0, 1: 0}
        gaps = []
        for _, _, j, gen, H in records:
            check(gen in (0, 1), f"12c: reply of generation {gen}")
            gaps.append(solo_gap(H, wants[gen][j],
                                 f"12c query {j} (generation {gen})"))
            other = wants[1 - gen][j]
            check(not np.allclose(H, other, rtol=SERVE_RTOL,
                                  atol=SERVE_ATOL),
                  f"12c query {j}: a reply matches both references")
            by_gen[gen] += 1
        check(by_gen[0] > 0 and by_gen[1] > 0,
              f"12c replies by generation {by_gen}")
        # the poison tenant: strikes at the router, then 403 there
        bad = queries[0].copy()
        bad[1, 5] = np.nan
        codes = []
        for _ in range(4):
            status, body = cli._request(
                "POST", "/project", {"tenant": "toxic", "shape":
                                     list(bad.shape), "b64": __import__(
                                         "base64").b64encode(bad.tobytes())
                                     .decode("ascii")})
            codes.append(status)
        check(codes == [422, 422, 422, 403],
              f"12c poison tenant answered {codes}")
        st = poll()
        check("toxic" in st["quarantined_tenants"],
              "12c: the router did not quarantine the poison tenant")
        out["replica_ready_s"] = [r["ready_s"] for r in st["replicas"]]
        out["router_stats"] = {key: st[key] for key in (
            "requests", "ok", "poison", "quarantined", "error", "retries",
            "failovers", "replica_deaths", "rollovers", "generation")}
        check(st["error"] == 0, f"12c router errors {st['error']}")
        check(cli.shutdown(), "12c: shutdown refused")
        check(proc.wait(timeout=120) == 0,
              f"12c: the fleet exited {proc.returncode}")
    finally:
        stop.set()
        time.sleep(0.5)
        alive = [p for p in pids if _alive(p)]
        _stop_fleet(proc, pids)
        log_f.close()
    check(not alive, f"12c: replica processes outlived the fleet: {alive}")
    check(not os.path.exists(sock), "12c: the fleet left its socket")
    check(validate_events_file(ev_path) > 0, "12c events do not validate")
    evs = read_events(ev_path)
    deaths = [e for e in evs if e["t"] == "replica_death"]
    fails = [e for e in evs if e["t"] == "failover"]
    rolls = [e for e in evs if e["t"] == "rollover"]
    check(deaths and fails and rolls,
          f"12c events: {len(deaths)} deaths, {len(fails)} failovers, "
          f"{len(rolls)} rollovers")
    kill_ts = deaths[0]["ts"] - deaths[0].get("since_kill_s", 0.0)
    lat = [(t0, (t1 - t0) * 1e3) for t0, t1, *_ in records]
    out.update(
        replies=len(records), replies_by_generation=by_gen,
        max_rel_gap_to_solo=max(gaps), pids=len(pids),
        failover_gap_s=deaths[0].get("since_kill_s"),
        respawn_wall_s=t_back - deaths[0]["ts"],
        death_seen_s=t_dead - kill_ts,
        rollover_wall_s=rolls[0]["wall_s"], rollover_call_s=t_rolled - t_roll,
        p99_ms={"before": _p99([ms for t, ms in lat if t < kill_ts]),
                "during": _p99([ms for t, ms in lat
                                if kill_ts <= t < t_back]),
                "after": _p99([ms for t, ms in lat if t_back <= t < t_roll]),
                "rollover": _p99([ms for t, ms in lat
                                  if t_roll <= t < t_rolled]),
                "after_rollover": _p99([ms for t, ms in lat
                                        if t >= t_rolled])},
        poison_codes=codes, rollover=roll)
    log(f"12c fleet: started in {out['fleet_start_s']:.2f} s; "
        f"{len(records)} replies ({by_gen}), max relative gap to solo "
        f"{max(gaps):.3g}; failover gap {out['failover_gap_s']} s, respawn "
        f"wall {out['respawn_wall_s']:.2f} s, rollover wall "
        f"{out['rollover_wall_s']} s; p99 ms {out['p99_ms']}")
    return out


def phase12(stages, Xn) -> dict:
    """Serving and the fleet on the card."""
    out = {"a": serve_phase(stages, Xn)}
    out["b"] = serve_b2_phase(stages, Xn)
    out["c"] = stages.run("serve 12c fleet", lambda: fleet_phase(stages,
                                                                 Xn))
    torch.cuda.empty_cache()
    out["launches"] = {name: int(out["a"]["launches"].get(name, 0))
                       + int(out["b"]["launches"].get(name, 0))
                       for name in out["a"]["launches"]}
    return out


# -- phase 13: formats and the planner on the card ---------------------------

PLAN_K = 9              # 13c's factorize: one K, the pipeline's replicates
PLAN_DT = 0.5           # 13c's consensus density threshold


def _int_digits(a: np.ndarray, width: int):
    """The decimal digits of non-negative ints ``a`` as an ``(n, width)``
    uint8 matrix of ASCII, right-aligned, and the mask of the digits that
    are not leading zeros (``0`` keeps one)."""
    a = a.astype(np.int64)
    digits = np.empty((a.size, width), np.uint8)
    rest = a.copy()
    for j in range(width - 1, -1, -1):
        digits[:, j] = 48 + rest % 10
        rest //= 10
    n_dig = np.ones(a.size, np.int64)
    for j in range(1, width):
        n_dig += a >= 10 ** j
    keep = np.arange(width)[None, :] >= (width - n_dig)[:, None]
    return digits, keep


def write_10x(d: str, X, cells, genes) -> str:
    """A gzipped 10x directory of the integer counts ``X`` (cells x genes,
    CSR): ``matrix.mtx.gz`` (genes x cells, sorted by cell as 10x writes
    it), ``features.tsv.gz`` and ``barcodes.tsv.gz``. The coordinate lines
    are built as one byte buffer with numpy (no per-line Python), then
    gzipped at level 1. Returns the matrix's path."""
    import gzip

    os.makedirs(d, exist_ok=True)
    Xc = X.tocsr()
    n, g = Xc.shape
    rows = Xc.indices.astype(np.int64) + 1                    # genes
    cols = np.repeat(np.arange(1, n + 1), np.diff(Xc.indptr))  # cells
    vals = Xc.data.astype(np.int64)
    check(np.array_equal(vals, Xc.data), "10x writer: non-integer counts")
    parts, masks = [], []
    for a in (rows, cols, vals):
        dig, keep = _int_digits(a, len(str(int(a.max()))))
        parts += [dig, np.full((a.size, 1), 32, np.uint8)]
        masks += [keep, np.ones((a.size, 1), bool)]
    parts[-1][:] = 10                                         # newline
    body = np.hstack(parts)[np.hstack(masks)].tobytes()
    head = (f"%%MatrixMarket matrix coordinate integer general\n"
            f"%metadata_json: {{\"software_version\": \"chip_smoke\"}}\n"
            f"{g} {n} {Xc.nnz}\n").encode()
    mtx = os.path.join(d, "matrix.mtx.gz")
    with open(mtx, "wb") as f:
        f.write(gzip.compress(head + body, compresslevel=1))
    with gzip.open(os.path.join(d, "features.tsv.gz"), "wt") as f:
        f.write("".join(f"{x}\t{x}\tGene Expression\n" for x in genes))
    with gzip.open(os.path.join(d, "barcodes.tsv.gz"), "wt") as f:
        f.write("".join(f"{c}\n" for c in cells))
    return mtx


def _file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def tenx_phase(stages, counts_fn, ref_obj, smi) -> dict:
    """13a: phase 3's raw counts as a gzipped 10x directory, read by the
    native reader and by scipy (equal CSR), then ``prepare`` from it: the
    normalized counts, the HVG list and the TPM statistics byte for byte
    phase 3's prepare from ``.npz``."""
    import gzip

    import scipy.io
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch import cNMF
    from cnmf_torch_tpu_torch.native import native_available
    from cnmf_torch_tpu_torch.utils.io import load_df_from_npz, read_10x_mtx

    df = load_df_from_npz(counts_fn)
    X = sp.csr_matrix(df.values)
    t0 = time.perf_counter()
    mtx = write_10x(os.path.join(OUT, "tenx"), X, df.index, df.columns)
    write_s = time.perf_counter() - t0
    check(native_available(), "the native .mtx reader did not build")
    t0 = time.perf_counter()
    native = read_10x_mtx(os.path.dirname(mtx))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with gzip.open(mtx, "rb") as f:
        via_scipy = sp.csr_matrix(scipy.io.mmread(f)).T.tocsr()
    scipy_s = time.perf_counter() - t0
    for name, got in (("native", native.X), ("scipy", via_scipy)):
        check(got.shape == X.shape and (got != X).nnz == 0,
              f"13a: the {name} read differs from the counts")
    for attr in ("data", "indices", "indptr"):
        check(np.array_equal(getattr(native.X, attr),
                             getattr(via_scipy, attr)),
              f"13a: native and scipy CSR {attr} differ")
    check(list(native.obs_names) == list(df.index.astype(str))
          and list(native.var_names) == list(df.columns.astype(str)),
          "13a: 10x names")
    log(f"13a on {smi}: {X.nnz} stored counts, 10x directory written in "
        f"{write_s:.3f} s ({os.path.getsize(mtx) / 2 ** 20:.1f} MiB "
        f"gzipped); read native {native_s:.3f} s, scipy {scipy_s:.3f} s")
    obj = cNMF(OUT, "tenx_run", device=CARD)
    stages.run("13a prepare from 10x", lambda: obj.prepare(
        mtx, components=KS, n_iter=REPLICATES, seed=SEED,
        beta_loss="kullback-leibler", num_highvar_genes=N_HVG,
        batch_size=CHUNK))
    for key in ("normalized_counts", "nmf_genes_list", "tpm_stats"):
        check(_file_bytes(obj.paths[key]) == _file_bytes(ref_obj.paths[key]),
              f"13a: {key} from 10x differs from the .npz prepare")
    log("13a: prepare from 10x wrote the normalized counts, HVG list and "
        "TPM statistics of the .npz prepare byte for byte")
    return {"nnz": int(X.nnz), "write_s": write_s, "native_read_s": native_s,
            "scipy_read_s": scipy_s,
            "mtx_gz_bytes": os.path.getsize(mtx)}


def autotune_phase(smi) -> dict:
    """13b: ``CNMF_TPU_AUTOTUNE=1`` into the smoke's private cache: the
    ELL lane of the microbench launches ``h_stats`` and ``w_numer``; the
    fingerprint names the card; the scales and the four plan points are
    finite."""
    import math

    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.utils import autotune

    kl_ell.reset_launches()
    with knobs(CNMF_TPU_AUTOTUNE="1"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rho = autotune.maybe_autotune_rho(beta=1.0, device=CARD)
        plan = autotune.maybe_autotune_plan(device=CARD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kl_ell.launches)
    for name in ("h_stats", "w_numer"):
        check(launches[name] > 0, f"13b: the autotuner launched no {name}")
    path = autotune.cache_path(device=CARD)
    with open(path) as f:
        payload = json.load(f)
    card = torch.cuda.get_device_name(0).replace(" ", "_")
    check(path.startswith(OUT) and card in payload["fingerprint"],
          f"13b: cache {path} fingerprint {payload['fingerprint']}")
    scales, points = payload["scales"], payload["plan_points"]
    check(set(scales) == {"b2", "dense", "ell"}, f"13b: scales {scales}")
    check(set(points) == {"ell_density_crossover", "grid_blocks",
                          "stream_threads", "sketch_dim"},
          f"13b: plan points {points}")
    for v in list(scales.values()) + list(points.values()):
        check(math.isfinite(v) and v > 0, f"13b: {scales} {points}")
    check(rho["scales"] == scales and plan["plan_points"] == points,
          "13b: the returned payloads are not the cache's")
    log(f"13b on {smi}: autotune wall {wall:.3f} s, fingerprint "
        f"{payload['fingerprint']}, probe {payload['probe']}")
    log(f"  rho scales {scales}; plan points {points}; launches {launches}")
    return {"wall_s": wall, "fingerprint": payload["fingerprint"],
            "probe": payload["probe"], "scales": scales, "points": points,
            "launches": launches}


def _plan_events(obj) -> list:
    from cnmf_torch_tpu_torch.utils.telemetry import read_events

    return [e for e in read_events(os.path.join(
        OUT, obj.name, "cnmf_tmp", f"{obj.name}.events.jsonl"))
        if e["t"] == "plan"]


def _run_files(obj, pattern) -> dict:
    d = os.path.join(OUT, obj.name, "cnmf_tmp")
    return {f[len(obj.name):]: _file_bytes(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if pattern in f}


def plan_phase(stages, counts_fn, smi) -> dict:
    """13c: phase 3's online KL factorize at k=9 under ``auto`` with the
    13b cache (telemetry on): one ``plan`` event, the measured groups
    ``autotuned``, ``ell-cuda``; ``plan --out``; ``factorize --plan`` into
    a fresh run: the same signature, the same iter spectra and consensus
    usages byte for byte, the sources ``pin``; a missing plan file exits
    non-zero naming it. The environment is restored after the replay."""
    import io

    from cnmf_torch_tpu_torch.cli import main as cli_main
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    env0 = dict(os.environ)
    plan_fn = os.path.join(OUT, "plan13.json")
    out = {}
    try:
        with knobs(CNMF_TPU_TELEMETRY="1", CNMF_TPU_AUTOTUNE="auto"):
            a = prepared_run("planned", counts_fn, [PLAN_K], "kullback-"
                             "leibler")
            kl_ell.reset_launches()
            stages.run("13c factorize (autotuned)", a.factorize)
            out["factorize_s"] = stages.rows[-1][1]
            out["launches"] = dict(kl_ell.launches)
        for name in ONLINE_KERNELS:
            check(out["launches"][name] > 0, f"13c: {name} never launched")
        evs = _plan_events(a)
        check(len(evs) == 1, f"13c: {len(evs)} plan events")
        plan = evs[0]["plan"]
        check(plan["kernel"] == "ell-cuda" and a.factorize_info["kernel"]
              == "ell-cuda", f"13c: kernel {plan['kernel']}")
        for group in ("encoding", "streaming"):
            check(plan["sources"][group] == "autotuned",
                  f"13c: {group} source {plan['sources'][group]}")
        text = cli_text(["plan", os.path.join(OUT, a.name), "--out",
                         plan_fn])
        check("[autotuned]" in text and os.path.exists(plan_fn),
              "13c: plan --out")
        log(text.rstrip())
        b = prepared_run("replayed", counts_fn, [PLAN_K], "kullback-leibler")
        os.environ["CNMF_TPU_TELEMETRY"] = "1"
        kl_ell.reset_launches()
        stages.run("13c factorize --plan", lambda: cli_main(
            ["factorize", "--output-dir", OUT, "--name", b.name, "--device",
             CARD, "--plan", plan_fn]))
        out["replay_s"] = stages.rows[-1][1]
        replay_launches = dict(kl_ell.launches)
        check(os.environ.get("CNMF_TPU_AUTOTUNE") == "0",
              "13c: the replay pinned no knobs")
    finally:
        os.environ.clear()
        os.environ.update(env0)
    for name in ONLINE_KERNELS:
        check(replay_launches[name] > 0, f"13c replay: {name} not launched")
    evs_b = _plan_events(b)
    check(len(evs_b) == 1, f"13c replay: {len(evs_b)} plan events")
    check(evs_b[0]["signature"] == evs[0]["signature"],
          f"13c: signatures {evs[0]['signature']} != "
          f"{evs_b[0]['signature']}")
    for group in ("encoding", "streaming", "recipe", "kernel"):
        check(evs_b[0]["plan"]["sources"][group] == "pin",
              f"13c replay: {group} source "
              f"{evs_b[0]['plan']['sources'][group]}")
    for obj in (a, b):
        stages.run(f"13c {obj.name} combine", obj.combine)
        stages.run(f"13c {obj.name} consensus", lambda obj=obj:
                   obj.consensus(PLAN_K, density_threshold=PLAN_DT))
    spectra_a = _run_files(a, ".iter_")
    check(len(spectra_a) == REPLICATES
          and spectra_a == _run_files(b, ".iter_"),
          "13c: the replay's iter spectra differ")
    usages_a = _run_files(a, ".usages.")
    check(usages_a and usages_a == _run_files(b, ".usages."),
          "13c: the replay's consensus usages differ")
    missing = os.path.join(OUT, "no_such_plan.json")
    err = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stderr(err):
            cli_main(["factorize", "--output-dir", OUT, "--name", b.name,
                      "--device", CARD, "--plan", missing])
    except SystemExit as exc:
        code = exc.code
    finally:
        os.environ.clear()
        os.environ.update(env0)
    check(code not in (0, None) and missing in err.getvalue(),
          f"13c: a missing plan file exited {code}: {err.getvalue()!r}")
    log(f"13c on {smi}: signature {evs[0]['signature']} both runs; "
        f"sources {evs[0]['plan']['sources']} -> "
        f"{evs_b[0]['plan']['sources']}; {len(spectra_a)} iter spectra "
        f"and {len(usages_a)} usage files byte-identical; a missing plan "
        f"exits {code}")
    out.update(signature=evs[0]["signature"],
               sources=evs[0]["plan"]["sources"],
               replay_sources=evs_b[0]["plan"]["sources"],
               replay_launches=replay_launches, missing_plan_exit=code)
    return out


def phase13(stages, counts_fn, ref_obj, smi) -> dict:
    """Formats and the planner on the card."""
    out = {"a": tenx_phase(stages, counts_fn, ref_obj, smi),
           "b": autotune_phase(smi)}
    out["c"] = plan_phase(stages, counts_fn, smi)
    out["launches"] = {
        name: int(out["b"]["launches"][name])
        + int(out["c"]["launches"][name])
        + int(out["c"]["replay_launches"][name])
        for name in out["b"]["launches"]}
    torch.cuda.empty_cache()
    return out


PP_DONORS = 4            # 14a's donors, 2,500 cells each
DONOR_SIGMA = 0.5        # the planted donor effect a gene: lognormal(0, 0.5)
PP_MT, PP_DOT, PP_ADT = 10, 10, 50   # MT- genes, dotted names, ADT features
ADT = "Antibody Capture"
PP_FILTER = dict(min_cells_per_gene=10, min_counts_per_cell=100,
                 filter_mito_genes=True, filter_mito_thresh=0.2)
PP_HARMONY = dict(feature_type_col="feature_types", harmony_vars="batch",
                  n_top_rna_genes=N_HVG, theta=1, max_iter_harmony=20)
PP_GAP_MAX = 0.35        # JAX's band (tests/test_preprocess.py:124)
PP_REPEAT_TOL = 1e-6     # two card runs, of the largest corrected value
PP_SUB = 2_000           # the subsample of 14a's CPU run and of 14c
PP_CPU_TOL = 1e-3        # card against CPU, of the largest corrected value
PP_KS = [7, 9]
PP_ITER = 10
PP_K = 9
MI_TOP = 70
MI_TOL = 1e-5


def donor_counts():
    """14a's input: phase 3's low-rank Poisson model at full width with
    four donors of 2,500 cells and their planted effect, ten ``MT-`` genes
    and ten dotted names among the 5,000 genes, and a 50-feature ADT block
    (``var["feature_types"]``), as CSR ``Counts`` with ``obs["batch"]``."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch.utils.io import Counts

    donors = np.arange(N_CELLS) * PP_DONORS // N_CELLS
    rna = synthetic_counts(N_CELLS, N_GENES, donors=donors)
    rng = np.random.default_rng(SEED + 1)
    adt = rng.poisson(rng.gamma(2.0, 5.0, size=(1, PP_ADT)),
                      size=(N_CELLS, PP_ADT)).astype(np.float32)
    genes = [f"g{j}" for j in range(N_GENES)]
    genes[:PP_MT] = [f"MT-{j}" for j in range(PP_MT)]
    genes[PP_MT:PP_MT + PP_DOT] = [f"AC{j}.1" for j in range(PP_DOT)]
    names = genes + [f"adt{j}" for j in range(PP_ADT)]
    X = sp.hstack([sp.csr_matrix(rna), sp.csr_matrix(adt)]).tocsr()
    return Counts(X, np.asarray([f"c{i}" for i in range(N_CELLS)]),
                  np.asarray(names),
                  obs={"batch": np.asarray([f"donor{d}" for d in donors],
                                           dtype=object)},
                  var={"feature_types": np.asarray(
                      ["Gene Expression"] * N_GENES + [ADT] * PP_ADT,
                      dtype=object)})


@contextlib.contextmanager
def timed_calls(targets, walls: dict, results: list):
    """Wrap ``(module, name, label)`` functions for the block: each call's
    synchronized wall lands in ``walls[label]`` and its result in
    ``results`` as ``(label, result)``."""
    saved = []
    for mod, name, label in targets:
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls.setdefault(_label, []).append(time.perf_counter() - t0)
            results.append((_label, out))
            return out

        setattr(mod, name, wrapped)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _donor_gaps(M, donors) -> list:
    """Centroid distance of every pair of donors in the rows of ``M``."""
    ids = sorted(set(donors))
    cents = [M[donors == d].mean(0) for d in ids]
    return [float(np.linalg.norm(cents[a] - cents[b]))
            for a in range(len(ids)) for b in range(a + 1, len(ids))]


def sidecar_phase(stages, smi) -> dict:
    """14a: ``filter_adata`` and ``preprocess_for_cnmf`` with Harmony on the
    card, twice; then the port's CPU run against the card's on a
    subsample."""
    from cnmf_torch_tpu_torch import Preprocess
    from cnmf_torch_tpu_torch.models import preprocess as pp_mod
    from cnmf_torch_tpu_torch.ops import harmony as hm

    t0 = time.perf_counter()
    counts = donor_counts()
    log(f"14a: counts {counts.shape} ({counts.X.nnz} stored, "
        f"{counts.X[:, :N_GENES].sum() / N_CELLS:.1f} RNA UMI a cell), "
        f"{PP_DONORS} donors, made in {time.perf_counter() - t0:.2f} s")
    spies = [(pp_mod, "seurat_v3_hvg", "hvg"), (pp_mod, "pca", "pca"),
             (pp_mod, "run_harmony", "harmony"),
             (hm, "_cluster_phase", "cluster_phase"),
             (pp_mod, "_moe_ridge", "moe_genes")]
    runs, walls, results = [], {}, []
    for i in (1, 2):
        pp = Preprocess(SEED, device=CARD)
        filt = stages.run(f"14a filter_adata #{i}", lambda: pp.filter_adata(
            counts, **PP_FILTER))
        with timed_calls(spies if i == 1 else [], walls, results):
            out = stages.run(f"14a preprocess_for_cnmf #{i}",
                             lambda: pp.preprocess_for_cnmf(filt,
                                                            **PP_HARMONY))
        runs.append((filt,) + out)
    whole_s, peak = stages.rows[-3][1], stages.rows[-3][2]
    check(not torch.backends.cuda.matmul.allow_tf32,
          "14a: TF32 matmuls are on")
    filt, rna, tp10k, hvgs = runs[0]
    n = filt.shape[0]
    check(not any("MT-" in v or "." in v for v in filt.var_names),
          "14a: filter_adata kept an MT- or dotted gene")
    check(rna.X.shape == (n, N_HVG) and len(hvgs) == N_HVG,
          f"14a: corrected matrix {rna.X.shape}")
    check(bool((rna.X >= 0).all()) and bool(np.isfinite(rna.X).all()),
          "14a: the corrected matrix is negative or not finite")
    ft = np.asarray(tp10k.var["feature_types"])
    sums = {k: np.asarray(tp10k.X[:, m].sum(1)).ravel()
            for k, m in (("rna", ft != ADT), ("adt", ft == ADT))}
    for k, v in sums.items():
        check(np.allclose(v, 1e4, rtol=1e-5),
              f"14a: {k} TP10K sums {v.min()}-{v.max()}")
    donors = np.asarray(filt.obs["batch"])
    before = _donor_gaps(rna.obsm["X_pca"], donors)
    after = _donor_gaps(rna.obsm["X_pca_harmony"], donors)
    ratio = float(np.mean(after) / np.mean(before))
    check(ratio < PP_GAP_MAX, f"14a: donor gap ratio {ratio}")
    repeat = float(np.abs(runs[1][1].X - rna.X).max())
    check(repeat <= PP_REPEAT_TOL * float(np.abs(rna.X).max())
          and runs[1][3] == hvgs, f"14a: two card runs differ by {repeat}")
    res = [r for label, r in results if label == "harmony"][0]
    rounds = [int(r[5]) for label, r in results if label == "cluster_phase"]
    log(f"14a on {smi}: {n} cells x {N_HVG} HVGs corrected, K="
        f"{res.K} clusters, {len(res.objective_harmony)} Harmony "
        f"iterations, cluster rounds {rounds}; donor centroid gaps "
        f"before {np.round(before, 3).tolist()} after "
        f"{np.round(after, 3).tolist()} (mean ratio {ratio:.4f}); two "
        f"card runs differ by {repeat}")
    sub_rows = np.sort(np.random.default_rng(SEED).choice(
        n, PP_SUB, replace=False))
    sub = {}
    for dev in (CARD, "cpu"):
        sub[dev] = stages.run(
            f"14a preprocess_for_cnmf, {PP_SUB} cells ({dev})",
            lambda dev=dev: Preprocess(SEED, device=dev).preprocess_for_cnmf(
                filt.take(rows=sub_rows), **PP_HARMONY))
    scale = float(np.abs(sub["cpu"][0].X).max())
    cpu_gap = float(np.abs(sub[CARD][0].X - sub["cpu"][0].X).max())
    check(sub[CARD][2] == sub["cpu"][2], "14a: card and CPU HVGs differ")
    check(cpu_gap <= PP_CPU_TOL * scale,
          f"14a: card and CPU differ by {cpu_gap} (largest value {scale})")
    log(f"14a: {PP_SUB} cells, card against CPU: max gap {cpu_gap:.3e} "
        f"of the largest value {scale:.4f} ({cpu_gap / scale:.3e})")
    out = {"cells": n, "walls": {k: [float(x) for x in v]
                                 for k, v in walls.items()},
           "whole_s": whole_s, "peak_gib": peak,
           "harmony_iterations": len(res.objective_harmony),
           "cluster_rounds": rounds, "K": res.K,
           "gap_before": before, "gap_after": after, "gap_ratio": ratio,
           "repeat_gap": repeat, "cpu_gap": cpu_gap, "cpu_scale": scale}
    log(f"14a walls (s): hvg {sum(walls['hvg']):.3f}, pca "
        f"{sum(walls['pca']):.3f}, Harmony {sum(walls['harmony']):.3f} "
        f"(cluster phase {sum(walls['cluster_phase']):.3f} over "
        f"{len(walls['cluster_phase'])} calls), gene-space MOE ridge "
        f"{sum(walls['moe_genes']):.3f}, the whole call {whole_s:.3f}; "
        f"peak {peak:.3f} GiB")
    return out, runs[0]


def _handoff_files(base, rna, tp10k, hvgs):
    """The sidecar's three files as the card's machine can write them
    (no h5py): the two matrices as dense ``.df.npz``, the HVGs as text."""
    import scipy.sparse as sp

    from cnmf_torch_tpu_torch import Frame, save_df_to_npz

    for suffix, c in ((".Corrected.HVG.Varnorm.df.npz", rna),
                      (".TP10K.df.npz", tp10k)):
        X = c.X.toarray() if sp.issparse(c.X) else np.asarray(c.X)
        save_df_to_npz(Frame(X.astype(np.float32), c.obs_names,
                             c.var_names), base + suffix)
    with open(base + ".Corrected.HVGs.txt", "w") as f:
        f.write("\n".join(hvgs))
    return (base + ".Corrected.HVG.Varnorm.df.npz", base + ".TP10K.df.npz",
            base + ".Corrected.HVGs.txt")


def handoff_phase(stages, side, smi) -> dict:
    """14b: the sidecar's files into ``prepare -> factorize -> combine ->
    consensus -> k_selection_plot``, for the Harmony output (the lane rule
    as it stands) and for ``harmony_vars=None`` (sparse; the ELL lane asked
    for with ``CNMF_TPU_SPARSE_BETA=1``, the rule's own choice logged);
    launches gated against each run's lane, the figures against the
    machine's matplotlib (D17)."""
    import importlib.util
    import warnings

    from cnmf_torch_tpu_torch import Preprocess, cNMF
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.sparse import resolve_sparse_beta
    from cnmf_torch_tpu_torch.utils.io import load_matrix

    filt, rna_h, tp_h, hvgs_h = side
    plain = stages.run("14b preprocess_for_cnmf (no Harmony)",
                       lambda: Preprocess(SEED, device=CARD)
                       .preprocess_for_cnmf(filt, **dict(
                           PP_HARMONY, harmony_vars=None)))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    out = {}
    for label, (rna, tp, hvgs) in (("harmony", (rna_h, tp_h, hvgs_h)),
                                   ("plain", plain)):
        name = f"pp14_{label}"
        counts_fn, tpm_fn, genes_fn = _handoff_files(
            os.path.join(OUT, name), rna, tp, hvgs)
        obj = cNMF(OUT, name, device=CARD)
        kl_ell.reset_launches()
        stages.run(f"14b {label} prepare", lambda: obj.prepare(
            counts_fn, tpm_fn=tpm_fn, genes_file=genes_fn,
            components=PP_KS, n_iter=PP_ITER, seed=SEED,
            beta_loss="kullback-leibler", batch_size=CHUNK))
        Xn = load_matrix(obj.paths["normalized_counts"]).X
        dens = Xn.nnz / (Xn.shape[0] * Xn.shape[1])
        width = int(np.diff(Xn.indptr).max())
        auto = ("ell" if resolve_sparse_beta(1.0, dens, width, Xn.shape[1])
                else "dense")
        log(f"14b {label}: normalized counts {Xn.shape}, density "
            f"{dens:.4f}, widest row {width} (guard {Xn.shape[1] // 8}): "
            f"the lane rule picks {auto}")
        with knobs(**({"CNMF_TPU_SPARSE_BETA": "1"} if label == "plain"
                      else {})):
            stages.run(f"14b {label} factorize", obj.factorize)
            stages.run(f"14b {label} combine", obj.combine)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                stages.run(f"14b {label} consensus", lambda: obj.consensus(
                    PP_K, density_threshold=2.0))
                stats = stages.run(f"14b {label} k_selection_plot",
                                   obj.k_selection_plot)
        launches = dict(kl_ell.launches)
        info = obj.factorize_info
        lane = info["lane"]
        check(lane in ("ell", "dense"), f"14b {label}: lane {lane}")
        for kname in kl_ell.KERNELS:
            want = lane == "ell" and kname in ONLINE_KERNELS
            check((launches[kname] > 0) == want,
                  f"14b {label} on the {lane} lane: {kname} launched "
                  f"{launches[kname]} times")
        pngs = [obj.paths["clustering_plot"] % (PP_K, "2_0"),
                obj.paths["k_selection_plot"]]
        skipped = [str(w.message) for w in caught
                   if issubclass(w.category, RuntimeWarning)
                   and "matplotlib" in str(w.message)]
        for png in pngs:
            if have_mpl:
                check(os.path.exists(png), f"14b {label}: no {png}")
            else:
                check(not os.path.exists(png)
                      and any(png in m for m in skipped),
                      f"14b {label}: {png} not skipped with the warning")
        for key in ("consensus_spectra", "consensus_usages",
                    "gene_spectra_tpm", "gene_spectra_score"):
            check(os.path.exists(obj.paths[key] % (PP_K, "2_0")),
                  f"14b {label}: no {key}")
        check(os.path.exists(obj.paths["k_selection_stats"])
              and stats.shape == (len(PP_KS), 4)
              and np.isfinite(stats.values).all(),
              f"14b {label}: K-selection statistics")
        log(f"14b {label} on {smi}: lane {lane}, kernel "
            f"{info['kernel']}, launches {launches}; figures "
            f"{'written' if have_mpl else 'skipped (no matplotlib)'}: "
            f"{len(skipped)} warnings")
        out[label] = {"lane": lane, "auto_lane": auto, "density": dens,
                      "width": width, "kernel": info["kernel"],
                      "launches": launches, "figures_skipped": skipped,
                      "obj": obj}
    check(out["harmony"]["lane"] == out["harmony"]["auto_lane"] == "dense",
          "14b: the corrected (dense) hand-off did not take the dense lane")
    check(out["plain"]["lane"] == "ell",
          "14b: the sparse hand-off did not take the ELL lane")
    return out


def mi_phase(stages, filt, obj, smi) -> dict:
    """14c: ``select_features_MI`` on the card against the port's CPU path
    on a subsample, the label each cell's largest program of 14b's
    sparse run."""
    from cnmf_torch_tpu_torch import Preprocess
    from cnmf_torch_tpu_torch.utils.io import load_df_from_npz

    usages = load_df_from_npz(obj.paths["consensus_usages"] % (PP_K, "2_0"))
    check(list(usages.index) == list(filt.obs_names), "14c: cell order")
    labels = np.argmax(usages.values, axis=1)
    rows = np.sort(np.random.default_rng(SEED + 2).choice(
        filt.shape[0], PP_SUB, replace=False))
    sub = filt.take(rows=rows)
    got = {}
    for dev in (CARD, "cpu"):
        got[dev] = stages.run(
            f"14c select_features_MI, {PP_SUB} cells ({dev})",
            lambda dev=dev: Preprocess(SEED, device=dev).select_features_MI(
                sub, labels[rows], n_top_features=MI_TOP))
    top = {dev: set(np.asarray(c.var_names)[c.var["highly_variable"]])
           for dev, c in got.items()}
    gap = float(np.abs(got[CARD].var["MI"] - got["cpu"].var["MI"]).max())
    check(len(top[CARD]) == MI_TOP and top[CARD] == top["cpu"],
          "14c: card and CPU top features differ")
    check(gap <= MI_TOL, f"14c: MI differs by {gap}")
    log(f"14c on {smi}: {sub.shape} features, {len(set(labels[rows]))} "
        f"labels; the top {MI_TOP} equal, MI gap {gap:.3e}, largest MI "
        f"{float(got[CARD].var['MI'].max()):.4f}")
    return {"features": int(sub.shape[1]), "mi_gap": gap}


def phase14(stages, smi) -> dict:
    """The preprocess sidecar on the card."""
    a, side = sidecar_phase(stages, smi)
    b = handoff_phase(stages, side, smi)
    c = mi_phase(stages, side[0], b["plain"].pop("obj"), smi)
    b["harmony"].pop("obj")
    torch.cuda.empty_cache()
    return {"a": a, "b": b, "c": c, "launches": b["plain"]["launches"]}


# -- phase 15: lint and the sanitizer ----------------------------------------

SAN_K = 13              # 15b's solves: k, replicates and the online passes
SAN_R = 20
SAN_PASSES = 3
SAN_DNA_ITERS = 20
SAN_LANES, SAN_ROWS = 4, 1_024      # 15b's batched_project bucket


def lint_phase(stages) -> dict:
    """15a: the lint gate over the port, as a user runs it, and the knob
    table it generates."""
    def gate():
        return subprocess.run(
            [sys.executable, "-m", "cnmf_torch_tpu_torch.analysis.gate"],
            cwd=HERE, capture_output=True, text=True, timeout=300)

    t0 = time.perf_counter()
    proc = stages.run("15a lint gate", gate)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("LINT_GATE:")]
    check(len(lines) == 1, f"15a: no LINT_GATE line: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    log(f"15a {lines[0]} ({wall:.2f} s)")
    counts = {key: int(val) for key, val in
              re.findall(r"([a-z]+)=(\d+)", lines[0])}
    findings = {k: v for k, v in counts.items()
                if k not in ("baselined", "suppressed", "files")}
    check(proc.returncode == 0 and not any(findings.values())
          and counts.get("baselined") == 0,
          f"15a: the lint gate failed (rc {proc.returncode}): "
          f"{proc.stdout[-3000:]}")
    table = subprocess.run(
        [sys.executable, "-m", "cnmf_torch_tpu_torch", "lint",
         "--knob-table"], cwd=HERE, capture_output=True, text=True,
        timeout=120)
    with open(os.path.join(HERE, "cnmf_torch_tpu_torch", "KNOBS.md")) as f:
        knobs_md = f.read()
    check(table.returncode == 0 and table.stdout == knobs_md,
          "15a: lint --knob-table differs from KNOBS.md")
    n_lines = len(table.stdout.splitlines())
    log(f"15a lint --knob-table: {n_lines} lines, KNOBS.md byte for byte")
    return {"gate_line": lines[0], "gate_wall_s": wall, "counts": counts,
            "knob_table_lines": n_lines}


def guarded(fn):
    """``fn()`` under ``sync_guard`` on the card: ``(out, host reads,
    launches)``. A sync error is not caught."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.utils.sanitize import sync_guard

    kl_ell.reset_launches()
    with sync_guard(CARD) as guard:
        check(guard.active, "15b: sync_guard did not engage on the card")
        out = fn()
    return out, guard.reads, dict(kl_ell.launches)


def sanitize_phase(stages, Xn) -> dict:
    """15b: the negative control, then the solver paths under
    ``sync_guard`` at the main path's width, their inputs staged and the
    kernels warmed outside it."""
    from cnmf_torch_tpu_torch.ops import nmf
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.sparse import csr_to_ell, ell_chunk_rows
    from cnmf_torch_tpu_torch.parallel.rowshard import _rowsharded_pass
    from cnmf_torch_tpu_torch.serving import ResidentReference
    from cnmf_torch_tpu_torch.serving.batcher import batched_project
    from cnmf_torch_tpu_torch.utils.sanitize import host_read, sync_guard

    # the negative control: a guard that never engaged would pass below
    probe = torch.ones(8, device=CARD)
    caught = None
    with sync_guard(CARD) as guard:
        try:
            probe.sum().item()
        except RuntimeError as exc:
            caught = str(exc)
        with host_read():
            marked = probe.sum().item()
    check(guard.active and caught is not None,
          "15b: a bare .item() under sync_guard did not raise")
    check(marked == 8.0 and guard.reads == 1,
          "15b: host_read() did not let its read through")
    log(f"15b negative control: a bare .item() under sync_guard raised "
        f"({caught.strip().splitlines()[0][:120]})")

    # inputs, staged before any guard: the pipeline's counts in chunks of
    # CHUNK rows (online), its first chunk with the transpose set (batch
    # and the row-sharded pass), and random inits
    rng = np.random.default_rng(SEED)
    n, g = Xn.shape
    xc, _ = ell_chunk_rows(Xn, CHUNK)
    xc = xc.to(CARD)
    C = xc.vals.shape[0]
    x0 = csr_to_ell(Xn[:CHUNK]).to(CARD)
    scale = float(np.sqrt(Xn.sum() / (n * g) / SAN_K))

    def init(*shape):
        return torch.as_tensor(
            (scale * (rng.random(shape) + 0.1)).astype(np.float32)).to(CARD)

    Hc0, W0 = init(SAN_R, C, CHUNK, SAN_K), init(SAN_R, SAN_K, g)
    Hb0 = init(SAN_R, CHUNK, SAN_K)
    H1, W1 = init(1, CHUNK, SAN_K), init(1, SAN_K, g)
    Xd = torch.as_tensor(Xn[:CHUNK].toarray().astype(np.float32)).to(CARD)
    h_tol, _, h_tol_start = nmf.resolve_online_schedule(1.0)
    ref = ResidentReference(
        rng.gamma(0.3, 1.0, (SAN_K, g)).astype(np.float32), beta=1.0,
        chunk_size=CHUNK, chunk_max_iter=1000, h_tol=0.05).stage(CARD)
    Xq = torch.as_tensor(
        Xn[CHUNK:CHUNK + SAN_LANES * SAN_ROWS].toarray().astype(
            np.float32).reshape(SAN_LANES, SAN_ROWS, g)).to(CARD)
    Hq = torch.full((SAN_LANES, SAN_ROWS, SAN_K), 1.0 / SAN_K, device=CARD)

    solves = {
        "online_kl_ell_bf16": lambda p, trace: nmf.nmf_fit_online(
            xc, Hc0, W0, beta=1.0, tol=1e-4, h_tol=h_tol,
            h_tol_start=h_tol_start, chunk_max_iter=1000, n_passes=p,
            bf16_ratio=True, trace=trace),
        "batch_dna": lambda p, trace: nmf.nmf_fit_batch(
            x0, Hb0, W0, beta=1.0, tol=0.0, max_iter=p, kl_newton=True,
            trace=trace),
        "batch_beta2": lambda p, trace: nmf.nmf_fit_batch(
            Xd, Hb0, W0, beta=2.0, tol=0.0, max_iter=p, trace=trace),
        "rowsharded_pass": lambda p, trace: _rowsharded_pass(
            [x0], [H1], W1, 1.0, 0.05, 1000, 0.0, 0.0, 0.0, 0.0),
        "batched_project": lambda p, trace: batched_project(
            Xq, Hq, ref.Wd, ref.WWT, ref.w_colsum, ref.h_tol_dev, beta=1.0,
            max_iter=1000, l1=0.0, l2=0.0),
    }
    depth = {"online_kl_ell_bf16": SAN_PASSES, "batch_dna": SAN_DNA_ITERS,
             "batch_beta2": SAN_DNA_ITERS, "rowsharded_pass": 1,
             "batched_project": 1}
    # warm every path (cuBLAS handles, the allocator's pools) outside the
    # guard, one step each
    for solve in solves.values():
        solve(1, [])
    torch.cuda.synchronize()

    out, total = {}, {name: 0 for name in kl_ell.KERNELS}
    for name, solve in solves.items():
        trace = []
        res, reads, launches = stages.run(
            f"15b {name} under sync_guard",
            lambda: guarded(lambda: solve(depth[name], trace)))
        wall = stages.rows[-1][1]
        tensors = [t for t in (res if isinstance(res, tuple) else (res,))
                   if isinstance(t, torch.Tensor)]
        if name == "rowsharded_pass":
            tensors = [res[0][0], res[1], res[2]]
        elif name == "batched_project":
            tensors = [res[0]]
        finite = all(bool(torch.isfinite(t).all()) for t in tensors)
        check(finite, f"15b {name}: a nonfinite output")
        for k_, v in launches.items():
            total[k_] += v
        rec = {"wall_s": wall, "host_reads": reads, "launches": launches}
        if name == "online_kl_ell_bf16":
            rec["passes"] = len(trace)
            rec["host_reads_a_pass"] = reads / max(len(trace), 1)
        out[name] = rec
        log(f"15b {name}: {wall:.3f} s under sync_guard, {reads} host "
            f"reads"
            + (f" ({rec['host_reads_a_pass']:.1f} a pass over "
               f"{rec['passes']} passes)" if "passes" in rec else "")
            + f", launches {launches}")
    for name in kl_ell.KERNELS:
        check(total[name] > 0, f"15b: {name} never launched under "
              "sync_guard")
    torch.cuda.empty_cache()
    return {"solves": out, "launches": total,
            "negative_control": caught.strip().splitlines()[0]}


def phase15(stages, Xn) -> dict:
    """Lint and the sanitizer."""
    return {"a": lint_phase(stages), "b": sanitize_phase(stages, Xn)}


# -- phase 16: the four tutorials --------------------------------------------

# tutorial module -> its run name (``cnmf_tmp/<name>.timings.tsv``)
TUTORIALS = {"simulated_tutorial": "sim_run", "pbmc_tutorial": "pbmc",
             "batch_correction_tutorial": "islets",
             "seurat_vignette": "vignette"}


def stream_rows(tsv: str) -> list:
    """The stream sub-phase rows (``<prefix>/<phase>``) of a timings TSV."""
    with open(tsv) as f:
        return [line.split("\t")[0] for line in f
                if "/" in line.split("\t")[0]]


def phase16(stages, smi) -> dict:
    """The tutorials at their JAX defaults, on the card."""
    import importlib

    from cnmf_torch_tpu_torch.examples._common import have_h5py
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell

    out = {}
    for name, run in TUTORIALS.items():
        module = importlib.import_module(
            f"cnmf_torch_tpu_torch.examples.{name}")
        d = os.path.join(OUT, "tutorials", name)
        shutil.rmtree(d, ignore_errors=True)
        kl_ell.reset_launches()
        result = stages.run(f"tutorial {name}",
                            lambda: module.main(d, device=CARD))
        launches = dict(kl_ell.launches)
        _, wall, peak = stages.rows[-1]
        check(sum(launches.values()) == 0,
              f"16: {name} launched a kernel: {launches}")
        rows = stream_rows(os.path.join(d, run, "cnmf_tmp",
                                        run + ".timings.tsv"))
        check("stage_dense:tpm/wall" in rows,
              f"16: {name}'s timings TSV has no stage_dense rows: {rows}")
        out[name] = {"wall_s": wall, "peak_gib": peak,
                     "launches": launches, "stream_rows": rows}
        if name == "batch_correction_tutorial":
            # the consensus threshold it kept: 2.0 only after the density
            # filter's own failure at 0.5; its spectra are on disk
            dt = result[3]
            spectra = os.path.join(
                d, run, "cnmf_tmp",
                run + ".spectra.k_6.dt_%s.consensus.df.npz"
                % str(dt).replace(".", "_"))
            check(dt in (0.5, 2.0) and os.path.exists(spectra),
                  f"16: batch correction kept density threshold {dt!r}; "
                  f"{spectra} exists {os.path.exists(spectra)}")
            out[name]["density_threshold"] = dt
            log(f"phase 16: batch correction's consensus at density "
                f"threshold {dt}")
    pbmc = os.path.join(OUT, "tutorials", "pbmc_tutorial")
    tenx = os.path.exists(os.path.join(pbmc, "pbmc_like_counts_10x",
                                       "matrix.mtx"))
    check(tenx != have_h5py(), "16: the PBMC input took the wrong format "
          f"(10x directory {tenx}, h5py importable {have_h5py()})")
    out["pbmc_input"] = "10x .mtx (no h5py)" if tenx else "h5ad"
    log(f"phase 16: the PBMC input as {out['pbmc_input']}; stream rows "
        + ", ".join(f"{n} {len(out[n]['stream_rows'])}" for n in TUTORIALS))
    out["launches"] = {k: sum(out[n]["launches"].get(k, 0)
                              for n in TUTORIALS) for k in kl_ell.KERNELS}
    torch.cuda.empty_cache()
    return out


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
    # every phase reads (and 13b writes) the smoke's own autotune cache,
    # emptied above: no cache of another run decides a phase's dispatch
    from cnmf_torch_tpu_torch.utils import autotune

    autotune.set_cache_dir(os.path.join(OUT, "autotune"))
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

    # -- phase 9: the atlas path ---------------------------------------------
    n_stages = len(stages.rows)
    atlas_rows = []
    p9, atlas_records, atlas = phase9(stages, atlas_rows)
    log(f"phase 9 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:40s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log("phase 9 kernels at R=1 (median of CUDA-event timed launches):")
    for line in atlas_rows:
        log(line)
    log(f"phase 9 kernel launches: {p9['kernel_launches']}")

    # -- phase 10: the remote object store -----------------------------------
    n_stages = len(stages.rows)
    p10 = phase10(stages, Xn, atlas)
    log(f"phase 10 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:44s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log(f"phase 10 kernel launches: {p10['launches']}")

    # -- phase 11: the multi-device layer ------------------------------------
    n_stages = len(stages.rows)
    mesh_rows = []
    p11 = phase11(stages, counts_fn, Xn, atlas, mesh_rows)
    log(f"phase 11 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:48s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log("phase 11 kernels a shard at R=1, k=9 (median of CUDA-event timed "
        "launches):")
    for line in mesh_rows:
        log(line)
    log(f"phase 11 kernel launches: {p11['launches']}")

    # -- phase 12: serving and the fleet ------------------------------------
    n_stages = len(stages.rows)
    p12 = phase12(stages, Xn)
    log(f"phase 12 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:48s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log(f"phase 12 kernel launches: {p12['launches']}")

    # -- phase 13: formats and the planner ----------------------------------
    n_stages = len(stages.rows)
    p13 = phase13(stages, counts_fn, obj, smi)
    log(f"phase 13 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:48s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log(f"phase 13 kernel launches: {p13['launches']}")

    # -- phase 14: the preprocess sidecar ------------------------------------
    n_stages = len(stages.rows)
    p14 = phase14(stages, smi)
    log(f"phase 14 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:48s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log(f"phase 14 kernel launches: {p14['launches']}")

    # -- phase 15: lint and the sanitizer ------------------------------------
    n_stages = len(stages.rows)
    p15 = phase15(stages, Xn)
    log(f"phase 15 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:48s} {wall:8.3f} s  peak {peak:7.3f} GiB")
    log(f"phase 15 kernel launches under sync_guard: "
        f"{p15['b']['launches']}")

    # -- phase 16: the tutorials ---------------------------------------------
    n_stages = len(stages.rows)
    p16 = phase16(stages, smi)
    log(f"phase 16 stages on {smi}:")
    for name, wall, peak in stages.rows[n_stages:]:
        log(f"  {name:48s} {wall:8.3f} s  peak {peak:7.3f} GiB")

    out = []
    for name in kl_ell.KERNELS:
        rec = dict(records[name])
        rec["launches"] = (int(launches[name]) + int(b_launches[name])
                           + int(p7_launches[name])
                           + int(p8["launches"][name])
                           + int(p8["profiled_launches"][name])
                           + int(p9["kernel_launches"][name])
                           + int(p10["launches"][name])
                           + int(p11["launches"][name])
                           + int(p12["launches"][name])
                           + int(p13["launches"][name])
                           + int(p14["launches"][name])
                           + int(p15["b"]["launches"][name])
                           + int(p16["launches"][name]))
        out.append(rec)
    report = {"kernels": out, "batch_shape_kernels": batch_extra,
              "launches": {"online": launches, "batch": b_launches,
                           "batch_factorize": b_factorize,
                           "frobenius": frob["launches"],
                           "other_solvers": other, "phase7": p7_launches,
                           "phase8": p8["launches"],
                           "phase8_profiled": p8["profiled_launches"]},
              "phase6_retries": other_retries, "phase7": p7, "phase8": p8,
              "phase9": p9, "phase9_kernels": atlas_records,
              "phase10": p10, "phase11": p11, "phase12": p12,
              "phase13": p13, "phase14": p14, "phase15": p15,
              "phase16": p16,
              "bundles": frob["bundles"],
              "bundle_vs_batch": frob["bundle_vs_batch"],
              "stages": [{"stage": s, "seconds": w, "peak_gib": p}
                         for s, w, p in stages.rows],
              "h_stats_by_k": h_stats_by_k,
              "sketch_rows_check": sketch_rows,
              "profile": profile, "card": smi, "ptxas": ptxas,
              "seconds": time.perf_counter() - t_start}
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        def _arg(flag):
            return sys.argv[sys.argv.index(flag) + 1]

        sys.exit(mesh_rank_main(int(_arg("--mesh-rank")),
                                int(_arg("--mesh-world")),
                                int(_arg("--mesh-port")),
                                _arg("--mesh-out"), _arg("--mesh-device")))
    sys.exit(main())
