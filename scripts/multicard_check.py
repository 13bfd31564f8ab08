#!/usr/bin/env python3
"""Drive the port's multi-device layer on every card of one host.

    python3 scripts/multicard_check.py            # a host with 2+ cards
    python3 scripts/multicard_check.py --device cpu --cards 4   # rehearsal

Where ``chip_smoke.py`` shards on one card, this script puts each shard
on its own card (or, with ``--device cpu``, on repeated CPU entries) and
checks:

1. The replicate axis: an online KL sweep (K=9, 20 replicates) on the
   default mesh (every visible card, one thread a card) against the same
   sweep on the first card, under strict f32 (``rtol 1e-4`` in the
   spectra); each card's wall.
2. The row-sharded ELL solve (15 passes, one init) over one shard a card
   against the same number of shards on the first card: the same sums in
   the same order, so the same bits; and the kernels' launches.
3. One process a card (``CUDA_VISIBLE_DEVICES`` set to the rank), joined
   by ``torch.distributed``: the backend rule must pick ``nccl`` (distinct
   cards; ``gloo`` on the CPU), and each rank's W must be within ``1e-5``
   of the one-process solve over as many cards (NCCL may add ranks in
   another order). Each rank then times one pass of a 2 x 2 grid spanning
   the processes with the overlap on and off (``measure_collectives``).
4. A factorize of the counts as it runs by default (one card) and with
   ``mesh=default_mesh()`` spreading the batched sweep over every card:
   every replicate's spectra file written by each; both walls.
5. One pass of a 2 x (cards / 2) grid, the overlap on and off
   (``measure_collectives``), with a tile a card and with every tile on
   the first card.

The last line of standard output is the JSON record. Data is a seeded
low-rank Poisson matrix (10,000 x 2,000, about 6% nonzeros; the grids
100,000 x 2,000 on cards).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

K, REPLICATES, PASSES, SEED = 9, 20, 15, 14
GRID_CELLS = {"cuda": 100_000, "cpu": 4_000}


def counts(n=10_000, g=2_000, k=12, seed=SEED):
    rng = np.random.default_rng(seed)
    U = rng.dirichlet(np.ones(k) * 0.2, size=n)
    S = rng.gamma(0.25, 1.0, size=(k, g)) * 120.0 / g
    X = rng.poisson(U @ S).astype(np.float32)
    X[X.sum(1) == 0, 0] = 1.0
    return sp.csr_matrix(X)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"multicard_check failed: {what}")


def sync(devices):
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def grid_overlap(X, mesh) -> dict:
    """One pass of the grid on ``mesh`` with the overlap on and off."""
    from cnmf_torch_tpu_torch.parallel.grid2d import (measure_collectives,
                                                      stage_x_grid)

    gx, _, _ = stage_x_grid(X, mesh)
    return measure_collectives(gx, K, beta=1.0, repeats=7)


def rank_main(rank, world, port, out, device):
    """One process of part 3: one card (the only one it sees)."""
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.parallel.grid2d import mesh_grid2d
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh, backend, \
        global_devices
    from cnmf_torch_tpu_torch.parallel.multihost import \
        initialize_distributed
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device)
    X = sp.load_npz(os.path.join(out, "X.npz")).tocsr()
    init = np.load(os.path.join(out, "init.npz"))
    devices, owners = global_devices([torch.device(device)])
    kl_ell.reset_launches()
    _H, W, err = nmf_fit_rowsharded(
        X, K, beta_loss="kullback-leibler", n_passes=PASSES,
        init_factors=(init["H0"], init["W0"]),
        mesh=Mesh(devices, ("cells",), owners=owners))
    np.save(os.path.join(out, f"W{rank}.npy"), W)
    launches = dict(kl_ell.launches)
    grid = grid_overlap(counts(n=GRID_CELLS[device]),
                        mesh_grid2d(2, world // 2, device=device))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"backend": backend(), "err": err, "launches": launches,
                   "grid_overlap": grid}, f)
    return 0


def main(device, cards) -> int:
    from cnmf_torch_tpu_torch import Frame, cNMF, save_df_to_npz
    from cnmf_torch_tpu_torch.launcher import _free_port
    from cnmf_torch_tpu_torch.ops.kernels import kl_ell
    from cnmf_torch_tpu_torch.ops.nmf import random_init
    from cnmf_torch_tpu_torch.parallel.grid2d import mesh_grid2d
    from cnmf_torch_tpu_torch.parallel.mesh import Mesh
    from cnmf_torch_tpu_torch.parallel.replicates import (default_mesh,
                                                          replicate_sweep)
    from cnmf_torch_tpu_torch.parallel.rowshard import nmf_fit_rowsharded

    on_card = device == "cuda"
    if on_card:
        check(torch.cuda.is_available(), "no card")
        cards = torch.cuda.device_count()
        check(cards >= 2, f"{cards} card(s): this check needs two or more")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        kl_ell.build()
        devices = [torch.device("cuda", i) for i in range(cards)]
        mesh = default_mesh(device="cuda")
        check(mesh is not None and mesh.size == cards,
              f"default_mesh {mesh}")
    else:
        devices = [torch.device("cpu")] * cards
        mesh = Mesh(devices, ("replicates",))
    first = devices[0]
    out = {"cards": cards, "device": device}
    X = counts()
    n, g = X.shape

    # 1. the replicate axis
    seeds = list(range(SEED, SEED + REPLICATES))
    os.environ["CNMF_TPU_BF16_RATIO"] = "0"
    kw = dict(beta_loss="kullback-leibler", mode="online",
              online_chunk_size=5_000)
    walls = {}
    for name, m in (("one card", None), ("every card", mesh)):
        replicate_sweep(X, seeds[:2], K, device=first, mesh=m, **kw)
        sync(devices)
        t0 = time.perf_counter()
        got = replicate_sweep(X, seeds, K, device=first, mesh=m, **kw)
        sync(devices)
        walls[name] = time.perf_counter() - t0
        out.setdefault("sweeps", {})[name] = got[0]
    gap = rel(out["sweeps"]["every card"], out["sweeps"]["one card"])
    del out["sweeps"]
    check(gap <= 1e-4, f"replicate axis {gap:.3g} from one card")
    out["replicate_axis"] = {"gap": gap, "walls_s": walls}

    # 2. the row-sharded solve, a shard a card
    H0, W0 = random_init(SEED, n, g, K, float(X.sum()) / (n * g))
    init = (H0.numpy(), W0.numpy())
    res = {}
    for name, devs in (("a card a shard", devices),
                       ("shards on the first card", [first] * cards)):
        kl_ell.reset_launches()
        sync(devices)
        t0 = time.perf_counter()
        _H, W, err = nmf_fit_rowsharded(
            X, K, beta_loss="kullback-leibler", n_passes=PASSES,
            init_factors=init, mesh=Mesh(devs, ("cells",)))
        sync(devices)
        res[name] = (W, err, time.perf_counter() - t0,
                     dict(kl_ell.launches))
    (Wa, ea, ta, la), (Wb, eb, tb, lb) = res.values()
    check(np.array_equal(Wa, Wb) and ea == eb,
          f"a shard a card vs shards on one card: {rel(Wa, Wb):.3g}")
    if on_card:
        check(la["w_numer"] == cards * PASSES,
              f"w_numer launched {la['w_numer']}")
    out["rowshard"] = {"walls_s": {"a card a shard": ta,
                                   "shards on the first card": tb},
                       "launches": la, "bit_equal": True}

    # 3. one process a card
    sub = tempfile.mkdtemp(prefix="multicard_")
    sp.save_npz(os.path.join(sub, "X.npz"), X)
    np.savez(os.path.join(sub, "init.npz"), H0=init[0], W0=init[1])
    port = str(_free_port())
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(cards):
            env = dict(os.environ, PYTHONPATH=ROOT)
            if on_card:
                env["CUDA_VISIBLE_DEVICES"] = str(r)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(r), "--world", str(cards), "--port", port, "--out",
                 sub, "--device", device], env=env))
        while any(p.poll() is None for p in procs):
            check(all(p.poll() in (None, 0) for p in procs),
                  f"ranks exited {[p.poll() for p in procs]}")
            check(time.perf_counter() - t0 < 300, "ranks past 300 s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    check([p.returncode for p in procs] == [0] * cards,
          f"ranks exited {[p.returncode for p in procs]}")
    ranks = []
    for r in range(cards):
        with open(os.path.join(sub, f"rank{r}.json")) as f:
            rec = json.load(f)
        rec["w_gap"] = rel(np.load(os.path.join(sub, f"W{r}.npy")), Wa)
        ranks.append(rec)
        check(rec["backend"] == ("nccl" if on_card else "gloo"),
              f"rank {r}: backend {rec['backend']}")
        check(rec["w_gap"] <= 1e-5, f"rank {r}: W {rec['w_gap']:.3g}")
    out["processes"] = {"wall_s": time.perf_counter() - t0, "ranks": ranks}

    # 4. factorize as it runs by default (one card), and spread
    d = tempfile.mkdtemp(prefix="multicard_run_")
    fn = os.path.join(d, "counts.df.npz")
    save_df_to_npz(Frame(X.toarray(), np.asarray([f"c{i}" for i in
                                                  range(n)]),
                         np.asarray([f"g{j}" for j in range(g)])), fn)
    obj = cNMF(d, "run", device=first)
    obj.prepare(fn, components=[7, K], n_iter=8, seed=SEED,
                beta_loss="kullback-leibler", num_highvar_genes=1_500)
    out["factorize_s"] = {}
    for name, m in (("one card", None), ("every card", mesh),
                    ("one card again", None), ("every card again", mesh)):
        sync(devices)
        t0 = time.perf_counter()
        obj.factorize(mesh=m)
        sync(devices)
        out["factorize_s"][name] = time.perf_counter() - t0
        written = obj.factorize_info["written"]
        check(written == {7: 8, K: 8}, f"factorize ({name}) wrote {written}")

    # 5. the grid's overlap, a tile a card and every tile on one card
    Xg = counts(n=GRID_CELLS[device])
    tiles = 2 * (cards // 2)
    out["grid_overlap"] = {
        name: grid_overlap(Xg, mesh_grid2d(2, tiles // 2, devices=devs))
        for name, devs in (("a tile a card", devices[:tiles]),
                           ("tiles on the first card", [first] * tiles))}
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]

    def arg(flag, default=None):
        return args[args.index(flag) + 1] if flag in args else default

    if "--rank" in args:
        sys.exit(rank_main(int(arg("--rank")), int(arg("--world")),
                           arg("--port"), arg("--out"), arg("--device")))
    sys.exit(main(arg("--device", "cuda"), int(arg("--cards", 4))))
