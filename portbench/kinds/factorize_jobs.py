"""Traffic kind ``factorize_jobs``: one user in a closed loop of whole
``cNMF.factorize`` jobs.

Set-up makes the counts from the seed, writes them as a 10x directory
(``matrix.mtx``, ``genes.tsv``, ``barcodes.tsv``), the form a PBMC user
hands to ``cNMF.prepare``, which reads it as CSR; runs ``prepare`` as the
configuration states; and warms every K's shapes with a capped sweep. The
window then runs whole jobs, each the full ledger (every K of the
configuration times ``n_iter`` replicates) with its seeds drawn from the
run's seed and the job's index, until ``seconds`` have passed; it ends
when the last job ends. Each job overwrites the last one's replicate
files. A traced run's window is one job, under the profiler.

Every job records its wall, its host CPU seconds, host spans around the
calls into the port (each K group's sweep with its kernel launches, the
ELL encoding, the matrix read, the replicate writes) and the path the
program took (the solver parameters the ledger wrote and
``factorize_info``), which is held to the configuration's ``path``.

The mix's parameters (``traffic/<mix>.json``): ``sample_per_job_per_k``,
the replicates of each job and K that the comparison takes.
"""

from __future__ import annotations

import gc
import os
import time
import warnings

import numpy as np
import scipy.sparse as sp

from portbench.harness import check, trace
from portbench.harness.counts import synthetic_counts

# the job index of prepare's own ledger seed
PREPARE_JOB = 1 << 20
# the jobs a run can draw samples for; a window holds far fewer
MAX_JOBS = 64


def job_seed(seed: int, job: int) -> int:
    """The ledger's master seed of job ``job``: 32 bits of the run's seed
    and the job's index."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, int(job)])
               .generate_state(1)[0])


def sample_iters(seed: int, jobs: int, n_ks: int, n_iter: int,
                 per_k: int) -> np.ndarray:
    """``(jobs, n_ks, per_k)`` replicate indices the comparison takes from
    each job and K, drawn from the run's seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    return np.stack([np.stack([rng.choice(n_iter, per_k, replace=False)
                               for _ in range(n_ks)]) for _ in range(jobs)])


def ledger_seeds(ks, n_iter: int, master_seed: int) -> dict:
    """cNMF's replicate seeds: ``len(ks) * n_iter`` draws of
    ``randint(1, 2**31 - 1)`` after ``np.random.seed(master_seed)``, taken
    in ``product(sorted(ks), range(n_iter))`` order."""
    np.random.seed(seed=master_seed)
    draws = np.random.randint(low=1, high=(2 ** 31) - 1,
                              size=len(ks) * n_iter)
    order = [(int(k), r) for k in sorted(set(ks)) for r in range(n_iter)]
    return {kr: int(draws[i]) for i, kr in enumerate(order)}


def make_counts(cfg: dict, seed: int) -> sp.csr_matrix:
    """The run's counts, cells x genes, from the frozen counts model."""
    return sp.csr_matrix(synthetic_counts(
        cfg["cells"], cfg["genes"], k_true=cfg["programs_planted"],
        scale=cfg["umi_scale"], seed=int(seed) % 2 ** 64))


def _fixed_width(cols) -> bytes:
    """Lines of non-negative integers below 2**31, one a column, each
    right-aligned after at least one space in its column's widest width
    (a few numpy passes a digit: ``np.savetxt`` formats line by line)."""
    n = len(cols[0])
    widths = [len(str(int(np.max(c)))) + 1 for c in cols]
    buf = np.full((n, sum(widths) + 1), ord(" "), np.uint8)
    end = 0
    for c, w in zip(cols, widths):
        end += w
        v = np.asarray(c, np.int32)
        for d in range(w - 1):
            q, r = np.divmod(v, 10)
            digit = (r + 48).astype(np.uint8)
            if d:
                digit[v == 0] = ord(" ")
            buf[:, end - 1 - d] = digit
            v = q
    buf[:, -1] = ord("\n")
    return buf.tobytes()


def write_10x(counts: sp.csr_matrix, directory: str) -> str:
    """Write ``counts`` as a 10x directory (MatrixMarket genes x cells,
    integer counts; one gene name a line; one barcode a line) and return
    the path of its ``matrix.mtx``."""
    os.makedirs(directory, exist_ok=True)
    n, g = counts.shape
    coo = counts.T.tocoo()
    path = os.path.join(directory, "matrix.mtx")
    with open(path, "wb") as f:
        f.write(b"%%MatrixMarket matrix coordinate integer general\n")
        f.write(b"%d %d %d\n" % (g, n, coo.nnz))
        f.write(_fixed_width([coo.row + 1, coo.col + 1,
                              np.rint(coo.data).astype(np.int64)]))
    with open(os.path.join(directory, "genes.tsv"), "w") as f:
        f.write("".join(f"g{j}\n" for j in range(g)))
    with open(os.path.join(directory, "barcodes.tsv"), "w") as f:
        f.write("".join(f"c{i}\n" for i in range(n)))
    return path


def _prepare_kwargs(cfg: dict) -> dict:
    kw = dict(num_highvar_genes=cfg["num_highvar_genes"],
              batch_size=cfg["batch_size"], max_NMF_iter=cfg["max_NMF_iter"],
              init=cfg["init"])
    if cfg.get("beta_loss") is not None:
        kw["beta_loss"] = cfg["beta_loss"]
    return kw


def _ledger(obj, cfg: dict, master_seed: int) -> dict:
    """Write a fresh replicate ledger with the configuration's solver
    parameters (as ``prepare`` writes it); return ``({(k, iter): seed},
    the solver parameters written)``."""
    params, run_params = obj.get_nmf_iter_params(
        ks=cfg["components"], n_iter=cfg["n_iter"],
        random_state_seed=master_seed,
        beta_loss=cfg.get("beta_loss") or "frobenius", init=cfg["init"],
        batch_size=cfg["batch_size"], max_iter=cfg["max_NMF_iter"])
    obj.save_nmf_iter_params(params, run_params)
    cols = list(np.asarray(params.columns))
    vals = np.asarray(params.values)
    k = vals[:, cols.index("n_components")].astype(int)
    it = vals[:, cols.index("iter")].astype(int)
    s = vals[:, cols.index("nmf_seed")].astype(np.int64)
    return ({(int(a), int(b)): int(c) for a, b, c in zip(k, it, s)},
            dict(run_params))


def _passes(trace_entries) -> list[int]:
    """Passes each replicate ran, from the sweep's per-pass objectives
    (``(passes, R)`` a slice; a stopped replicate repeats its last value)."""
    out = []
    for t in trace_entries:
        t = np.asarray(t)
        for r in range(t.shape[1]):
            col = t[:, r]
            changed = np.nonzero(col[1:] != col[:-1])[0]
            out.append(int(changed[-1]) + 2 if changed.size else 1)
    return out


def _warm_up(X, cfg: dict, device):
    """A capped sweep of ``n_iter`` replicates at every K, on the matrix
    staged once as factorize stages it: the shapes the window runs, one
    pass of at most ten inner steps."""
    import torch
    from cnmf_torch_tpu_torch.ops.nmf import (beta_loss_to_float,
                                              dense_on_device, takes_ell_lane)
    from cnmf_torch_tpu_torch.ops.sparse import ell_chunk_rows
    from cnmf_torch_tpu_torch.parallel.replicates import replicate_sweep

    loss = cfg.get("beta_loss") or "frobenius"
    chunk = int(min(cfg["batch_size"], X.shape[0]))
    n_rows = None
    if takes_ell_lane(X, beta_loss_to_float(loss)):
        Xs, n_rows = ell_chunk_rows(X, chunk)[0].to(device), X.shape[0]
    else:
        Xs = dense_on_device(X, device)
    for k in cfg["components"]:
        replicate_sweep(Xs, list(range(1, cfg["n_iter"] + 1)), k,
                        beta_loss=loss, init=cfg["init"],
                        online_chunk_size=chunk, online_chunk_max_iter=10,
                        n_passes=1, n_rows=n_rows, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _JobSpans:
    """Host spans of one job around its calls into the port: each K
    group's sweep (with the kernel launches it made), the ELL encoding, the
    matrix read and the replicate writes, through wrappers that the job's
    end removes."""

    def __init__(self, obj, spans: trace.Spans):
        self.obj, self.spans, self.groups = obj, spans, []
        self.seconds: dict[str, float] = {}
        self._undo = []

    def _wrap(self, owner, attr, label, kind, on_exit=None):
        orig = getattr(owner, attr)

        def wrapped(*a, **kw):
            from cnmf_torch_tpu_torch.ops.kernels import kl_ell

            before = dict(kl_ell.launches)
            t0 = time.perf_counter()
            with self.spans.span(label(a, kw)):
                out = orig(*a, **kw)
            wall = time.perf_counter() - t0
            self.seconds[kind] = self.seconds.get(kind, 0.0) + wall
            if on_exit is not None:
                on_exit(a, kw, before, dict(kl_ell.launches), wall)
            return out
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def __enter__(self):
        from cnmf_torch_tpu_torch.models import cnmf as cnmf_mod

        def k_of(a, kw):
            return int(a[2] if len(a) > 2 else kw["k"])

        def group(a, kw, before, after, wall):
            self.groups.append({
                "k": k_of(a, kw),
                "R": len(a[1] if len(a) > 1 else kw["seeds"]),
                "launches": {n: after[n] - before.get(n, 0) for n in after},
                "wall_s": wall})
        self._wrap(cnmf_mod, "replicate_sweep",
                   lambda a, kw: "sweep k=%d" % k_of(a, kw), "sweeps_s",
                   group)
        self._wrap(cnmf_mod, "ell_chunk_rows", lambda a, kw: "ELL encoding",
                   "encode_s")
        self._wrap(cnmf_mod, "load_matrix", lambda a, kw: "matrix read",
                   "read_s")
        self._wrap(self.obj, "_write_iter_spectra",
                   lambda a, kw: "replicate writes", "writes_s")
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            if owner is self.obj:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        return False


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool,
        device, workdir: str) -> dict:
    """Set-up and window of one run: the record the metric readers and
    :func:`compare` read."""
    import torch
    from cnmf_torch_tpu_torch import cNMF, load_df_from_npz
    from cnmf_torch_tpu_torch.utils.io import load_matrix

    on_card = torch.device(device).type == "cuda"
    parts = {}
    t_part = time.perf_counter()
    counts = make_counts(cfg, seed)
    mtx = write_10x(counts, os.path.join(workdir, "counts_10x"))
    parts["counts_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    obj = cNMF(workdir, "run", device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        obj.prepare(mtx, components=cfg["components"], n_iter=cfg["n_iter"],
                    seed=job_seed(seed, PREPARE_JOB), **_prepare_kwargs(cfg))
    parts["prepare_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    X = load_matrix(obj.paths["normalized_counts"]).X
    _warm_up(X, cfg, device)
    del X
    gc.collect()
    parts["warm_up_s"] = time.perf_counter() - t_part

    ks = [int(k) for k in cfg["components"]]
    per_k = int(traffic["sample_per_job_per_k"])
    picks = sample_iters(seed, MAX_JOBS, len(ks), cfg["n_iter"], per_k)
    jobs, samples = [], []
    spans = trace.Spans()
    profile = None
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    t_window_epoch = time.time()
    j = 0
    while True:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the last job's files exist
            seeds, solver = _ledger(obj, cfg, job_seed(seed, j))
        with trace.profiled(traced and on_card) as prof:
            marker_ns = trace.marker(device) if prof is not None else None
            t0 = time.perf_counter()
            t0_ns = time.perf_counter_ns()
            cpu0 = trace.cpu_s()
            with _JobSpans(obj, spans) as js, warnings.catch_warnings():
                warnings.simplefilter("ignore")
                obj.factorize()
            wall = time.perf_counter() - t0
            cpu = [b - a for a, b in zip(cpu0, trace.cpu_s())]
            spans.items.append(("job", t0_ns, time.perf_counter_ns()))
        if prof is not None:
            profile = trace.reduce(trace.device_events(prof), wall, spans,
                                   marker_ns)
        info = obj.factorize_info
        seen = dict(solver, **info)
        written = int(sum(info.get("written", {}).values()))
        jobs.append({
            "wall_s": wall, "cpu_s": sum(cpu), "sys_s": cpu[1],
            "written": written,
            "attempted": len(seeds), "host_s": js.seconds,
            "path": {key: seen.get(key) for key in cfg["path"]},
            "passes": _passes([t for k in ks for t in info["trace"][k]]),
            "groups": js.groups})
        for ki, k in enumerate(ks):
            for it in picks[j % MAX_JOBS, ki]:
                it = int(it)
                fn = obj.paths["iter_spectra"] % (k, it)
                spectra = (np.asarray(load_df_from_npz(fn).values,
                                      np.float32)
                           if os.path.exists(fn) else None)
                samples.append({"job": j, "k": k, "iter": it,
                                "seed": seeds[(k, it)], "spectra": spectra,
                                "err": float(info["errs"][k][it])})
        j += 1
        if traced or time.perf_counter() - t_window >= seconds:
            break
    window_s = time.perf_counter() - t_window
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    with open(obj.paths["nmf_genes_list"]) as f:
        hvg_names = f.read().split("\n")
    del obj
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    written = sum(jb["written"] for jb in jobs)
    attempted = sum(jb["attempted"] for jb in jobs)
    report = dict(
        parts, window_s=window_s,
        jobs_s=[jb["wall_s"] for jb in jobs],
        jobs_cpu_s=[jb["cpu_s"] for jb in jobs],
        jobs_sys_s=[jb["sys_s"] for jb in jobs],
        **{key: [jb["host_s"].get(key, 0.0) for jb in jobs]
           for key in ("sweeps_s", "encode_s", "read_s", "writes_s")},
        passes_mean=[sum(jb["passes"]) / len(jb["passes"]) for jb in jobs],
        path=jobs[0]["path"])
    return {
        "end_to_end": {"replicates_per_s": written / window_s},
        "attempted": attempted, "failed": attempted - written,
        "window_s": window_s, "window_start": t_window_epoch, "jobs": jobs,
        "samples": samples, "memory_peak_bytes": int(peak),
        "profile": profile, "hvg_names": hvg_names, "counts": counts,
        "report": report}


def reference_solutions(cfg: dict, counts, samples: list, chain: str,
                        device):
    """``({(job, k, iter): (W_ref, D_ref)}, hvg indices, [(rows, stored
    values)] a row chunk)``: the sampled replicates solved by the plain
    reference in the arithmetic ``chain``, one batched solve a K."""
    import torch

    from portbench.reference import online_nmf, prepare

    dense = counts.toarray() if sp.issparse(counts) else counts
    X, hvg = prepare.normalize(dense, cfg["num_highvar_genes"])
    del dense
    n, g = X.shape
    rows = int(min(cfg["batch_size"], n))
    C = -(-n // rows)
    chunks = [(min(rows, n - c * rows),
               int(np.count_nonzero(X[c * rows:(c + 1) * rows])))
              for c in range(C)]
    beta = {"frobenius": 2.0, "kullback-leibler": 1.0}[
        cfg.get("beta_loss") or "frobenius"]
    path = cfg["path"]
    Xt = torch.zeros((C * rows, g), dtype=torch.float32)
    Xt[:n] = torch.from_numpy(X)
    Xt = Xt.to(device)
    mean = online_nmf.x_mean(Xt, n, g)
    Xc = Xt.reshape(C, rows, g)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = chain == "tf32"
    out = {}
    try:
        for k in sorted({s["k"] for s in samples}):
            group = [s for s in samples if s["k"] == k]
            inits = [online_nmf.random_init(s["seed"], n, g, k, mean)
                     for s in group]
            H0 = torch.zeros((len(group), C * rows, k))
            H0[:, :n] = torch.stack([h for h, _ in inits])
            W0 = torch.stack([w for _, w in inits])
            W, D, _ = online_nmf.solve_online(
                Xc, H0.reshape(len(group), C, rows, k).to(device),
                W0.to(device), beta, chain, tol=path["tol"],
                h_tol=path["online_h_tol"],
                h_tol_start=path["online_h_tol_start"],
                n_passes=path["n_passes"], max_iter=cfg["max_NMF_iter"])
            W, D = W.cpu().numpy(), D.cpu().numpy()
            for i, s in enumerate(group):
                out[(s["job"], k, s["iter"])] = (W[i], float(D[i]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out, hvg, chunks


def numbers(cfg: dict, samples: list, ref: dict, hvg_ref, hvg_names: list,
            paths: list) -> dict:
    """The compared numbers:

    * ``hvg_mismatch``: genes in one HVG list and not the other;
    * ``path_mismatch``: jobs whose path (solver parameters and
      ``factorize_info``) is not the configuration's ``path``;
    * ``missing``: sampled replicates the program never wrote;
    * ``spectra_gap_median`` / ``_max``: ``||W - W_ref|| / ||W_ref||`` over
      the sampled replicates;
    * ``spectra_outlier_pct``: the share of them, in %, whose gap is over
      the configuration's ``outlier_gap``;
    * ``objective_gap_median`` / ``_max``: ``|D - D_ref| / D_ref``.
    """
    port = {int(s[1:]) for s in hvg_names if s}
    out = {"hvg_mismatch": len(port ^ {int(i) for i in hvg_ref}),
           "path_mismatch": sum(p != cfg["path"] for p in paths),
           "missing": sum(s["spectra"] is None for s in samples)}
    sg, og = [], []
    for s in samples:
        if s["spectra"] is None:
            continue
        W_ref, D_ref = ref[(s["job"], s["k"], s["iter"])]
        sg.append(float(np.linalg.norm(s["spectra"] - W_ref)
                        / np.linalg.norm(W_ref)))
        og.append(abs(s["err"] - D_ref) / D_ref)
    out.update(check.gap_summary("spectra_gap", sg))
    out["spectra_outlier_pct"] = (
        100.0 * sum(v > cfg["outlier_gap"] for v in sg) / len(sg)
        if sg else float("nan"))
    out.update(check.gap_summary("objective_gap", og))
    return out


def compare(cfg: dict, traffic: dict, record: dict, device) -> dict:
    """The numbers of a run (see :func:`numbers`); the reference's row
    chunks are left in ``record["chunks"]`` for the roofline readers."""
    ref, hvg, chunks = reference_solutions(cfg, record.pop("counts"),
                                           record["samples"], cfg["chain"],
                                           device)
    record["chunks"] = chunks
    return numbers(cfg, record["samples"], ref, hvg, record["hvg_names"],
                   [jb["path"] for jb in record["jobs"]])


def control_numbers(cfg: dict, traffic: dict, seed: int, jobs: int,
                    chain: str, device) -> dict:
    """The numbers of the control: the reference in arithmetic ``chain``
    in the program's place, on the samples a run of ``jobs`` jobs draws,
    judged against the reference in the configuration's ``chain``."""
    ks = [int(k) for k in cfg["components"]]
    picks = sample_iters(seed, MAX_JOBS, len(ks), cfg["n_iter"],
                         int(traffic["sample_per_job_per_k"]))
    samples = []
    for j in range(jobs):
        seeds = ledger_seeds(ks, cfg["n_iter"], job_seed(seed, j))
        for ki, k in enumerate(ks):
            for it in picks[j, ki]:
                samples.append({"job": j, "k": k, "iter": int(it),
                                "seed": seeds[(k, int(it))]})
    counts = make_counts(cfg, seed)
    ref, hvg, _ = reference_solutions(cfg, counts, samples, cfg["chain"],
                                      device)
    side, _, _ = reference_solutions(cfg, counts, samples, chain, device)
    for s in samples:
        s["spectra"], s["err"] = side[(s["job"], s["k"], s["iter"])]
    return numbers(cfg, samples, ref, hvg, [f"g{i}" for i in hvg],
                   [cfg["path"]])
