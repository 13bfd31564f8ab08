"""Command-line interface of the port: ``prepare | factorize | combine |
consensus | k_selection_plot`` with the JAX package's flags for those
stages, plus ``--device`` (default ``cuda``; there is no CPU fallback,
pass ``--device cpu`` to run on the CPU), the telemetry renderers
``report [run_dir] [--json]`` and ``trace [run_dir]``, and
``benchdiff BASE NEW [--band F] [--json]``, the noise-aware comparison of
two bench snapshots (``obs/regress.py``; exit 1 on a regression),
``lint [paths] [--format text|json] [--baseline FILE] [--write-baseline]
[--no-doc-check] [--knob-table]``, the port's static analysis
(``analysis/engine.py``; exit 1 on a finding; ``--knob-table`` prints
``KNOBS.md``),
``serve <run_dir>`` and ``fleet <run_dir>`` (the projection daemon and the
replicated fleet, ``serving/``; ``-k``, ``--local-density-threshold``,
``--spectra``, ``--socket`` or ``--port``, ``--replicas``,
``--replica-index``), and
``run_parallel`` (prepare -> factorize workers -> combine ->
``k_selection_plot``, ``launcher.py``; ``--engine subprocess|multihost``,
``--devices-per-host``, ``--clean``). ``factorize --mesh-2d`` runs the
(replicates x cells) mesh, ``--mesh-grid2d`` the (cells x genes) grid, and
``--distributed`` (implied by ``CNMF_COORDINATOR_ADDRESS``) joins the
processes named by the ``CNMF_*`` coordinates into one mesh.
``plan <run_dir> [--out p.json]`` renders the execution plan a run's
factorize recorded (its ``plan`` event; telemetry on) and dumps it;
``factorize --plan p.json`` replays it (sets ``CNMF_TPU_PLAN``): the same
dispatch, the same signature and the same files bit for bit. ``prepare``
reads ``.df.npz``, tab-delimited text, a 10x ``.mtx[.gz]`` directory and
``.h5ad`` (with h5py).

Run as ``cnmf-tpu-torch ...`` (the console script an install of the
repo's package puts on the path) or ``python -m cnmf_torch_tpu_torch ...``;
``--help`` and usage errors name the command that was typed. A stage
that launched the CUDA kernels prints one line of their launch counts,
``kernel launches: {...}``. ``k_selection_plot`` writes
the K-selection statistics (``<name>.k_selection_stats.df.npz``) and the
figure (``<name>.k_selection.png``), and ``consensus --show-clustering``
the clustergram; without matplotlib a figure is skipped with a warning
naming it and everything else is written. ``report`` renders a
run's telemetry (the events file of a ``CNMF_TPU_TELEMETRY=1`` run, else
the timings TSV) and ``trace`` its sampled span waterfalls; both read
files only and never touch a device. ``factorize --rowshard`` /
``--no-rowshard`` / ``--rowshard-threshold`` choose the row-sharded
solver as the JAX CLI does (auto at 200,000 cells; the consensus refits
keep the constructor's threshold), and ``--store-uri`` sets
``CNMF_TPU_STORE_URI`` (``file:///base`` or
``http(s)://host:port/prefix``, an object store; another scheme fails
before any work). ``factorize`` exits with
``UNHEALTHY_EXIT_CODE`` (3) when a K ends below
``CNMF_TPU_MIN_HEALTHY_FRAC`` healthy replicates after its retries, as
the JAX package's CLI does: a rerun would draw the same derived seeds,
so a launcher must not respawn on it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main", "build_parser"]

# the console script's name (pyproject.toml's [project.scripts])
SCRIPT = "cnmf-tpu-torch"


def _prog() -> str:
    """The command the user typed: the console script, else ``python -m
    cnmf_torch_tpu_torch``."""
    argv0 = os.path.basename(sys.argv[0]) if sys.argv else ""
    return SCRIPT if argv0.startswith(SCRIPT) else \
        "python -m cnmf_torch_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=_prog(),
        description="consensus NMF (cNMF) pipeline on PyTorch and CUDA")
    parser.add_argument(
        "command", type=str,
        choices=["prepare", "factorize", "combine", "consensus",
                 "k_selection_plot", "run_parallel", "report", "trace",
                 "serve", "fleet", "plan", "lint"])
    parser.add_argument(
        "run_dir", type=str, nargs="?", default=None,
        help="[report|trace|serve|fleet|plan] Run directory "
             "([output-dir]/[name]) whose telemetry to render / whose "
             "consensus reference to serve; defaults to "
             "--output-dir/--name")
    parser.add_argument("--name", type=str, nargs="?", default="cNMF",
                        help="[all] Name for analysis. All output will be "
                             "placed in [output-dir]/[name]/...")
    parser.add_argument("--output-dir", type=str, nargs="?", default=".",
                        help="[all] Output directory. All output will be "
                             "placed in [output-dir]/[name]/...")
    parser.add_argument("--device", type=str, default="cuda",
                        help="[all] torch device to run on (default cuda; "
                             "raises when no card is present)")
    parser.add_argument("-c", "--counts", type=str,
                        help="[prepare] Input (cell x gene) counts matrix as "
                             "df.npz, tab delimited text, h5ad (needs "
                             "h5py) or the matrix.mtx[.gz] of a 10x "
                             "directory")
    parser.add_argument("-k", "--components", type=int, nargs="+",
                        help="[prepare] Number of components (k) for matrix "
                             "factorization. Several can be specified with "
                             '"-k 8 9 10"')
    parser.add_argument("-n", "--n-iter", type=int, default=100,
                        help="[prepare] Number of factorization replicates")
    parser.add_argument("--total-workers", type=int, default=-1,
                        help="[all] Total number of workers to distribute "
                             "jobs to")
    parser.add_argument("--worker-index", type=int, default=0,
                        help="[factorize] Index of current worker (the first "
                             "worker should have index 0)")
    parser.add_argument("--use_gpu", action="store_true", default=False,
                        help="[prepare] Recorded in the solver parameters "
                             "for compatibility; --device places the work")
    parser.add_argument("--seed", type=int, default=None,
                        help="[prepare] Seed for pseudorandom number "
                             "generation")
    parser.add_argument("--genes-file", type=str, default=None,
                        help="[prepare] File containing a list of genes to "
                             "include, one gene per line. Must match column "
                             "labels of counts matrix.")
    parser.add_argument("--numgenes", type=int, default=2000,
                        help="[prepare] Number of high variance genes to use "
                             "for matrix factorization.")
    parser.add_argument("--tpm", type=str, default=None,
                        help="[prepare] Pre-computed (cell x gene) TPM "
                             "values as df.npz or tab separated txt file. If "
                             "not provided TPM will be calculated "
                             "automatically")
    parser.add_argument("--max-nmf-iter", type=int, default=1000,
                        help="[prepare] Max number of iterations per "
                             "individual NMF run (default 1000)")
    parser.add_argument("--beta-loss", type=str, default="frobenius",
                        choices=["frobenius", "kullback-leibler",
                                 "itakura-saito"],
                        help="[prepare] Loss function for NMF (default "
                             "frobenius)")
    parser.add_argument("--init", type=str, default="random",
                        choices=["random", "nndsvd"],
                        help="[prepare] Initialization algorithm for NMF "
                             "(default random)")
    parser.add_argument("--densify", dest="densify", action="store_true",
                        default=False,
                        help="[prepare] Treat the input data as non-sparse "
                             "(default False)")
    parser.add_argument("--batch_size", type=int, default=5000,
                        help="[prepare] Size of batch for online NMF "
                             "learning.")
    parser.add_argument("--skip-completed-runs", action="store_true",
                        default=False,
                        help="[factorize] Resume: skip replicates whose "
                             "artifacts probe AND validate on disk (torn "
                             "files are rerun, quarantined lanes stay "
                             "excluded). No prepare re-run needed.")
    parser.add_argument("--sequential", action="store_true", default=False,
                        help="[factorize] Run replicates one at a time "
                             "instead of as one batched solve per K")
    parser.add_argument("--rowshard", dest="rowshard",
                        action=argparse.BooleanOptionalAction, default=None,
                        help="[factorize] Shard the cells axis across the "
                             "device mesh (atlas-scale inputs), streaming "
                             "sparse row blocks host-to-HBM instead of "
                             "densifying. Default: auto above "
                             "--rowshard-threshold cells")
    parser.add_argument("--rowshard-threshold", type=int, default=200_000,
                        help="[factorize] Cell count at which factorize "
                             "auto-switches to the row-sharded path")
    parser.add_argument("--mesh-2d", dest="mesh_2d", action="store_true",
                        default=False,
                        help="[factorize] Run the sweep over the 2-D "
                             "(replicates x cells) mesh — the multi-process "
                             "layout: replicate rows across processes, "
                             "cells-axis sums within one")
    parser.add_argument("--mesh-grid2d", dest="mesh_grid2d",
                        action="store_true", default=False,
                        help="[factorize] Run replicates over the 2-D "
                             "(cells x genes) grid with block-wise "
                             "statistics sums (MPI-FAUN): X over "
                             "both axes, W over genes, H over cells")
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="[factorize] Join the processes named by "
                             "CNMF_COORDINATOR_ADDRESS / CNMF_NUM_PROCESSES "
                             "/ CNMF_PROCESS_ID into one mesh "
                             "(torch.distributed) before running (also "
                             "implied when those env vars are set)")
    parser.add_argument("--engine", type=str, default="subprocess",
                        choices=["subprocess", "multihost"],
                        help="[run_parallel] How factorize workers run: "
                             "independent processes sharing files (the "
                             "reference's GNU-parallel model) or processes "
                             "joined into one mesh")
    parser.add_argument("--devices-per-host", type=int, default=None,
                        help="[run_parallel] Mesh entries a multihost "
                             "process: simulated CPU entries with --device "
                             "cpu, else that many cards of its own; omit "
                             "to split the visible cards evenly")
    parser.add_argument("--clean", action="store_true", default=False,
                        help="[run_parallel] Delete per-replicate spectra, "
                             "leftover checkpoints, heartbeats, temp files "
                             "and the remote store's cache after combine")
    parser.add_argument("--store-uri", type=str, default=None,
                        help="[all] Shard-store transport URI (exports "
                             "CNMF_TPU_STORE_URI for this run): unset = "
                             "local paths, file:///base relocates the "
                             "store, http(s)://host:port/prefix puts it in "
                             "an object store")
    parser.add_argument("--per-k-programs", action="store_true",
                        default=False,
                        help="[factorize] Pin the per-K sweeps (the JAX "
                             "package's flag; the port always runs one "
                             "sweep per K and records the packed rule's "
                             "choice in the provenance)")
    parser.add_argument("--plan", type=str, default=None,
                        help="[factorize] Replay a dumped execution plan "
                             "(JSON from `plan <run_dir> --out`): pins the "
                             "whole dispatch so the run reproduces it "
                             "(sets CNMF_TPU_PLAN for this run)")
    parser.add_argument("--out", type=str, default=None,
                        help="[plan] Also dump the plan JSON to this file "
                             "(replayable with factorize --plan)")
    parser.add_argument("--local-density-threshold", type=float,
                        default=None,
                        help="[consensus] Threshold for the local density "
                             "filtering, >0 and <=2 (default 0.5); "
                             "[serve|fleet] pick the consensus artifact at "
                             "this threshold (default: the run's only "
                             "one)")
    parser.add_argument("--local-neighborhood-size", type=float, default=0.30,
                        help="[consensus] Fraction of the number of "
                             "replicates to use as nearest neighbors for "
                             "local density filtering")
    parser.add_argument("--show-clustering", dest="show_clustering",
                        action="store_true",
                        help="[consensus] Produce a clustergram figure "
                             "summarizing the spectra clustering")
    parser.add_argument("--build-reference", dest="build_reference",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="[consensus] Generate reference spectra for "
                             "use in starCAT")
    parser.add_argument("--socket", type=str, default=None,
                        help="[serve|fleet] Unix-socket path for the "
                             "projection daemon / fleet router (default: "
                             "<run_dir>/cnmf_tmp/<name>.serve.sock or "
                             "<name>.fleet.sock)")
    parser.add_argument("--port", type=int, default=None,
                        help="[serve|fleet] Serve HTTP on 127.0.0.1:PORT "
                             "instead of the unix socket")
    parser.add_argument("--spectra", type=str, default=None,
                        help="[serve|fleet] Explicit reference spectra: a "
                             "consensus .df.npz artifact or a shard-store "
                             "directory (overrides -k/--local-density-"
                             "threshold selection)")
    parser.add_argument("--replicas", type=int, default=None,
                        help="[fleet] Number of serve replicas to spawn "
                             "and route over (default: "
                             "CNMF_TPU_FLEET_REPLICAS)")
    parser.add_argument("--replica-index", type=int, default=0,
                        help="[serve] Replica ordinal within a fleet "
                             "(keys the daemon's heartbeat stamp and "
                             "events stream so N replicas of one run "
                             "directory never collide)")
    parser.add_argument("--json", action="store_true", default=False,
                        help="[report] Print the summary of the run's "
                             "events as JSON instead of the rendered "
                             "report")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "lint":
        # the static analysis owns its arguments (paths, --format,
        # --baseline, ...: analysis/engine.py) and touches no device
        from .analysis.engine import main as lint_main

        raise SystemExit(lint_main(argv[1:], prog=f"{_prog()} lint"))
    if argv and argv[0] == "benchdiff":
        # two positionals do not fit the stage parser's optional run_dir,
        # so the command owns its arguments and dispatches first
        raise SystemExit(_benchdiff(argv[1:]))
    parser = build_parser()
    # intermixed, so flags may precede or follow the optional run_dir
    args = parser.parse_intermixed_args(argv)
    if args.command == "lint":     # e.g. `--name x lint`
        parser.error(f"lint takes its own options; use: {_prog()} lint "
                     "[paths ...] [--format text|json] [--baseline FILE] "
                     "[--write-baseline] [--no-doc-check] [--knob-table]")
    if (args.command not in ("report", "trace", "serve", "fleet", "plan")
            and args.run_dir is not None):
        # a stray positional (e.g. `consensus 9` meaning `-k 9`) fails
        # fast instead of being swallowed
        parser.error(f"unrecognized argument: {args.run_dir!r} (a "
                     "positional run directory applies to 'report', "
                     "'trace', 'serve', 'fleet' and 'plan' only)")
    if args.command == "plan":
        return _plan(parser, args)
    if args.command == "factorize" and args.plan:
        # the flag is the knob: factorize pins the plan before any
        # dispatch resolves; a missing file is a usage error now
        from .runtime.planner import PLAN_ENV

        if not os.path.isfile(args.plan):
            parser.error(f"factorize: plan file not found: {args.plan}")
        os.environ[PLAN_ENV] = args.plan
    if args.command in ("report", "trace"):
        run_dir = args.run_dir or os.path.join(args.output_dir, args.name)
        if not os.path.isdir(run_dir):
            parser.error(f"{args.command}: run directory not found: "
                         f"{run_dir}")
        print(_render(args.command, run_dir, args.json))
        return
    if args.command == "prepare":
        missing = [flag for flag, val in
                   (("--counts/-c", args.counts),
                    ("--components/-k", args.components)) if val is None]
        if missing:
            parser.error(f"prepare requires {' and '.join(missing)}")

    if args.store_uri:
        # the flag is the knob: exported so every reader resolves the
        # same backend; an unsupported scheme fails here, before any work
        from .utils.storebackend import STORE_URI_ENV, resolve_backend

        os.environ[STORE_URI_ENV] = args.store_uri
        resolve_backend(os.path.join(args.output_dir, args.name))

    if args.command in ("serve", "fleet"):
        raise SystemExit(_serve(parser, args))
    if args.command == "run_parallel":
        return _run_parallel(parser, args)
    from .utils.envknobs import env_str

    if args.command == "factorize" and (
            args.distributed or env_str("CNMF_COORDINATOR_ADDRESS")):
        from .parallel.multihost import initialize_distributed

        pid, nproc = initialize_distributed(auto=args.distributed,
                                            device=args.device)
        print(f"torch.distributed: process {pid}/{nproc}")

    from .models.cnmf import cNMF

    obj = cNMF(output_dir=args.output_dir, name=args.name,
               device=args.device)
    if args.command == "prepare":
        obj.prepare(
            args.counts, components=args.components, n_iter=args.n_iter,
            densify=args.densify, tpm_fn=args.tpm, seed=args.seed,
            beta_loss=args.beta_loss, max_NMF_iter=args.max_nmf_iter,
            num_highvar_genes=args.numgenes, genes_file=args.genes_file,
            init=args.init, total_workers=args.total_workers,
            use_gpu=args.use_gpu, batch_size=args.batch_size)
    elif args.command == "factorize":
        from .runtime.resilience import (UNHEALTHY_EXIT_CODE,
                                         UnhealthySweepError)

        try:
            obj.factorize(worker_i=args.worker_index,
                          total_workers=max(args.total_workers, 1),
                          skip_completed_runs=args.skip_completed_runs,
                          batched=not args.sequential,
                          rowshard=args.rowshard,
                          rowshard_threshold=args.rowshard_threshold,
                          packed=False if args.per_k_programs else None,
                          mesh="2d" if args.mesh_2d else None,
                          mesh_shape="grid2d" if args.mesh_grid2d
                          else None)
        except UnhealthySweepError as exc:
            print(f"factorize: {exc}", file=sys.stderr)
            sys.exit(UNHEALTHY_EXIT_CODE)
    elif args.command == "combine":
        obj.combine(components=args.components)
    elif args.command == "consensus":
        ks = args.components or obj.ledger_components()
        for k in ks:
            obj.consensus(int(k), 0.5 if args.local_density_threshold
                          is None else args.local_density_threshold,
                          args.local_neighborhood_size,
                          args.show_clustering,
                          build_ref=args.build_reference,
                          close_clustergram_fig=True)
    elif args.command == "k_selection_plot":
        obj.k_selection_plot(close_fig=True)
    _print_launches()


def _print_launches() -> None:
    """One line of the CUDA kernels' launch counts, when this stage
    launched any (a CPU run launches none and prints nothing)."""
    kl = sys.modules.get("cnmf_torch_tpu_torch.ops.kernels.kl_ell")
    if kl is not None and any(kl.launches.values()):
        print(f"kernel launches: {json.dumps(kl.launches)}", flush=True)


def _serve(parser, args) -> int:
    """``serve`` (one projection daemon over the run's consensus
    reference) or ``fleet`` (N serve replicas behind the router), until
    SIGINT/SIGTERM. The reference is picked by ``-k`` and
    ``--local-density-threshold`` only when given, or by ``--spectra``;
    a missing or ambiguous reference is a usage error."""
    cmd = args.command
    run_dir = args.run_dir or os.path.join(args.output_dir, args.name)
    if not os.path.isdir(run_dir):
        parser.error(f"{cmd}: run directory not found: {run_dir}")
    if args.socket is not None and args.port is not None:
        parser.error(f"{cmd}: pass --socket or --port, not both")
    if cmd == "fleet" and args.replicas is not None and args.replicas < 1:
        parser.error("fleet: --replicas must be >= 1")
    from .serving import ReferenceError, fleet_forever, serve_forever

    k = args.components[0] if args.components else None
    common = dict(k=k, density_threshold=args.local_density_threshold,
                  spectra_path=args.spectra, socket_path=args.socket,
                  port=args.port, device=args.device)
    try:
        if cmd == "serve":
            return serve_forever(run_dir, replica=args.replica_index,
                                 **common)
        return fleet_forever(run_dir, replicas=args.replicas, **common)
    except ReferenceError as exc:
        parser.error(f"{cmd}: {exc}")


def _plan(parser, args) -> None:
    """``plan [run_dir] [--out p.json]``: the run's recorded plan,
    rendered, and dumped for ``factorize --plan`` (host files only)."""
    from .runtime.planner import ExecutionPlan, plan_from_run_dir, render_plan

    run_dir = args.run_dir or os.path.join(args.output_dir, args.name)
    if not os.path.isdir(run_dir):
        parser.error(f"plan: run directory not found: {run_dir}")
    plan_dict = plan_from_run_dir(run_dir)
    if plan_dict is None:
        parser.error(f"plan: no `plan` event recorded under {run_dir}; run "
                     "factorize with CNMF_TPU_TELEMETRY=1")
    print(f"Execution plan — {run_dir}")
    for line in render_plan(plan_dict):
        print(line)
    if args.out:
        ExecutionPlan.from_dict(plan_dict).save(args.out)
        print(f"plan JSON written to {args.out} (replay with: factorize "
              f"--plan {args.out})")


def _run_parallel(parser, args) -> None:
    """``run_parallel``: prepare -> factorize workers -> combine ->
    ``k_selection_plot`` (-> ``--clean``), forwarding the factorize-mode
    flags to every worker (``launcher.py:run_pipeline``)."""
    from .launcher import run_pipeline

    if args.counts is None or args.components is None:
        parser.error("run_parallel requires --counts/-c and "
                     "--components/-k")
    flags = []
    if args.mesh_2d:
        flags.append("--mesh-2d")
    if args.mesh_grid2d:
        flags.append("--mesh-grid2d")
    if args.sequential:
        flags.append("--sequential")
    if args.rowshard is not None:
        flags.append("--rowshard" if args.rowshard else "--no-rowshard")
    flags += ["--rowshard-threshold", str(args.rowshard_threshold)]
    if args.skip_completed_runs:
        flags.append("--skip-completed-runs")
    if args.per_k_programs:
        flags.append("--per-k-programs")
    # --store-uri reaches the workers as CNMF_TPU_STORE_URI, exported above
    run_pipeline(
        args.counts, args.output_dir, args.name,
        components=args.components, n_iter=args.n_iter,
        total_workers=max(args.total_workers, 1), seed=args.seed,
        numgenes=args.numgenes, genes_file=args.genes_file, tpm=args.tpm,
        beta_loss=args.beta_loss, init=args.init,
        max_nmf_iter=args.max_nmf_iter, batch_size=args.batch_size,
        engine=args.engine, devices_per_host=args.devices_per_host,
        clean=args.clean, factorize_flags=flags, device=args.device)


def _benchdiff(argv) -> int:
    """``benchdiff BASE NEW [--band F] [--json]``: the diff of two bench
    snapshots, rendered or as JSON; 0 when nothing regressed, else 1."""
    from .obs.regress import diff_snapshots, load_snapshot, render_diff

    bp = argparse.ArgumentParser(
        prog=f"{_prog()} benchdiff",
        description="Compare two bench snapshots (the obs.regress schema) "
                    "with noise-aware relative bands; exit 1 when any "
                    "lane regresses past the band.")
    bp.add_argument("base", help="baseline snapshot JSON")
    bp.add_argument("new", help="candidate snapshot JSON")
    bp.add_argument("--band", type=float, default=None,
                    help="relative regression band (fraction; default "
                         "CNMF_TPU_PERF_GATE_BAND or 0.6)")
    bp.add_argument("--json", action="store_true", default=False,
                    help="emit the diff as machine-readable JSON")
    args = bp.parse_args(argv)
    try:
        diff = diff_snapshots(load_snapshot(args.base),
                              load_snapshot(args.new), band=args.band)
    except (OSError, ValueError) as exc:
        bp.error(str(exc))
    if args.json:
        print(json.dumps(diff, indent=1, sort_keys=True))
    else:
        print(render_diff(diff))
    return 0 if diff["ok"] else 1


def _render(command: str, run_dir: str, as_json: bool) -> str:
    """The ``report`` or ``trace`` text of a run directory (host files
    only)."""
    if command == "trace":
        from .obs.tracing import render_run_traces

        return render_run_traces(run_dir)
    from .utils.telemetry import (_find_event_files, read_events,
                                  render_report, summarize_events)

    if not as_json:
        return render_report(run_dir)
    events: list[dict] = []
    files = _find_event_files(run_dir)
    for path in files:
        events.extend(read_events(path))
    doc = summarize_events(events)
    doc["run_dir"] = run_dir
    doc["event_files"] = len(files)
    return json.dumps(doc, indent=1, sort_keys=True, default=str)


if __name__ == "__main__":
    main()
