"""Command-line interface of the port: ``prepare | factorize | combine |
consensus | k_selection`` with the JAX package's flags for those stages,
plus ``--device`` (default ``cuda``; there is no CPU fallback, pass
``--device cpu`` to run on the CPU).

Run as ``python -m cnmf_torch_tpu_torch ...``. ``k_selection`` writes the
K-selection statistics (``<name>.k_selection_stats.df.npz``); the figure is
not ported. ``factorize`` exits with ``UNHEALTHY_EXIT_CODE`` (3) when a K
ends below ``CNMF_TPU_MIN_HEALTHY_FRAC`` healthy replicates after its
retries, as the JAX package's CLI does: a rerun would draw the same
derived seeds, so a launcher must not respawn on it.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m cnmf_torch_tpu_torch",
        description="consensus NMF (cNMF) pipeline on PyTorch and CUDA")
    parser.add_argument(
        "command", type=str,
        choices=["prepare", "factorize", "combine", "consensus",
                 "k_selection"])
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
                             "df.npz or tab delimited text file")
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
    parser.add_argument("--per-k-programs", action="store_true",
                        default=False,
                        help="[factorize] Pin the per-K sweeps (the JAX "
                             "package's flag; the port always runs one "
                             "sweep per K and records the packed rule's "
                             "choice in the provenance)")
    parser.add_argument("--local-density-threshold", type=float,
                        default=0.5,
                        help="[consensus] Threshold for the local density "
                             "filtering, >0 and <=2 (default 0.5)")
    parser.add_argument("--local-neighborhood-size", type=float, default=0.30,
                        help="[consensus] Fraction of the number of "
                             "replicates to use as nearest neighbors for "
                             "local density filtering")
    parser.add_argument("--build-reference", dest="build_reference",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="[consensus] Generate reference spectra for "
                             "use in starCAT")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "prepare":
        missing = [flag for flag, val in
                   (("--counts/-c", args.counts),
                    ("--components/-k", args.components)) if val is None]
        if missing:
            parser.error(f"prepare requires {' and '.join(missing)}")

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
                          packed=False if args.per_k_programs else None)
        except UnhealthySweepError as exc:
            print(f"factorize: {exc}", file=sys.stderr)
            sys.exit(UNHEALTHY_EXIT_CODE)
    elif args.command == "combine":
        obj.combine(components=args.components)
    elif args.command == "consensus":
        ks = args.components or obj.ledger_components()
        for k in ks:
            obj.consensus(int(k), args.local_density_threshold,
                          args.local_neighborhood_size,
                          build_ref=args.build_reference)
    elif args.command == "k_selection":
        stats = obj.k_selection_stats()
        print(stats.values)


if __name__ == "__main__":
    main()
