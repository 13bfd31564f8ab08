"""End-to-end pipeline launcher: prepare -> factorize workers -> combine
-> ``k_selection_plot`` -> clean (the reference's ``Extras/run_parallel.py``
workflow).

Port of ``cnmf_torch_tpu/launcher.py``. Two engines:

* ``subprocess`` — N independent worker processes, round-robin over the
  replicate ledger by ``--worker-index`` (files as the dataplane). A
  worker that dies (or runs past ``CNMF_TPU_WORKER_TIMEOUT`` seconds and
  is killed) is respawned onto its own unfinished shard with
  ``--skip-completed-runs`` after :func:`respawn_delay`, up to
  ``CNMF_TPU_WORKER_RESPAWNS`` times (backoff base
  ``CNMF_TPU_WORKER_BACKOFF_S``). Elastic (``CNMF_TPU_ELASTIC``): once a
  worker has finished cleanly, a dead shard is adopted by the idle fleet
  at once, with one adoption wave past the respawn budget; a worker whose
  run exceeds the longest clean finisher's wall by ``CNMF_TPU_STRAGGLER_S``
  with a stale heartbeat is killed and adopted the same way. When every
  lever is spent, combine runs with ``skip_missing_files=True``.
* ``multihost`` — N processes joined by ``torch.distributed`` into one
  mesh (``parallel/multihost.py``), each with ``devices_per_host`` local
  CPU entries on the CPU (the simulated pod), or on cards its own share
  of the visible cards (``CUDA_VISIBLE_DEVICES``; shared, on gloo, when
  there are fewer cards than processes). The
  workers run ``factorize --distributed`` with the forwarded layout flags
  (``--mesh-2d`` unless ``--rowshard`` or ``--mesh-grid2d`` asks for
  another layout: with ``--rowshard`` the cells axis spans the processes).

Python API: :func:`run_pipeline`. CLI: ``python -m cnmf_torch_tpu_torch
run_parallel ...``.
"""

from __future__ import annotations

import glob
import os
import socket
import subprocess
import sys
import time
import warnings

__all__ = ["run_pipeline", "respawn_delay"]


def respawn_delay(backoff_s: float, attempt: int, worker_i: int) -> float:
    """Respawn backoff of a dead worker: ``backoff_s * 2^(attempt-1)``
    times a deterministic per-worker jitter in [1, 1.5) (a multiplicative
    hash of the worker index, so a fleet that dies at once respawns spread
    over half a backoff period)."""
    base = float(backoff_s) * (2 ** (max(int(attempt), 1) - 1))
    jitter = ((int(worker_i) * 2654435761) & 0xFFFFFFFF) % 1024 / 2048.0
    return base * (1.0 + jitter)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_cmd(output_dir: str, name: str, extra: list) -> list:
    return [sys.executable, "-m", "cnmf_torch_tpu_torch", "factorize",
            "--output-dir", output_dir, "--name", name] + list(extra)


def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _run_subprocess_workers(output_dir: str, name: str, total_workers: int,
                            factorize_flags: list, base_env: dict,
                            poll_s: float = 0.05, events=None) -> tuple:
    """Run the subprocess engine's worker fleet with its self-healing:
    per-worker wall timeouts, backoff respawns onto the worker's own
    shard, elastic adoption of dead shards once a worker finished cleanly
    (one wave past the respawn budget; a budget spent before any worker
    finished defers that wave until one does), and straggler containment
    (one conviction a shard, only with liveness evidence). Adoptions and
    convictions land as ``fault`` events (``worker_steal``,
    ``straggler``) in ``events``. Returns ``(failed, unhealthy)``: workers that
    stayed dead after every lever, and workers that exited with
    ``resilience.UNHEALTHY_EXIT_CODE`` (never respawned)."""
    from .runtime import elastic
    from .runtime.resilience import UNHEALTHY_EXIT_CODE
    from .utils.envknobs import env_float, env_int

    respawn_limit = env_int("CNMF_TPU_WORKER_RESPAWNS", 1, lo=0)
    timeout_s = env_float("CNMF_TPU_WORKER_TIMEOUT", 0.0, lo=0.0)
    backoff_s = env_float("CNMF_TPU_WORKER_BACKOFF_S", 0.5, lo=0.0)
    steal_on = elastic.elastic_enabled()
    straggler_s = elastic.straggler_deadline_s()
    hb_interval = elastic.heartbeat_s()
    straggler_on = steal_on and straggler_s > 0 and hb_interval > 0
    stale_window = max(straggler_s, 3.0 * hb_interval)
    if steal_on and straggler_s > 0 and hb_interval <= 0:
        warnings.warn(
            "CNMF_TPU_STRAGGLER_S is set but CNMF_TPU_HEARTBEAT_S is off: "
            "straggler containment needs liveness evidence to avoid "
            "killing slow-but-healthy workers (resumed runs have wildly "
            "unequal shards) — the deadline is disabled. Set "
            "CNMF_TPU_HEARTBEAT_S to arm it.", RuntimeWarning)

    def spawn(i: int, resume: bool):
        flags = ["--worker-index", str(i),
                 "--total-workers", str(total_workers)]
        if resume and "--skip-completed-runs" not in factorize_flags:
            flags.append("--skip-completed-runs")
        return subprocess.Popen(
            _worker_cmd(output_dir, name, flags + list(factorize_flags)),
            env=base_env)

    def emit(kind: str, **context):
        if events is not None:
            events.emit("fault", kind=kind, context=context)

    def read_heartbeat(i: int):
        return elastic.Heartbeat.read(os.path.join(
            output_dir, name, "cnmf_tmp", f"{name}.heartbeat.{i}.json"))

    def last_heartbeat(i: int) -> str:
        rec = read_heartbeat(i)
        if not rec:
            return ""
        try:
            age = round(max(0.0, time.time() - float(rec["ts"])), 1)
        except (KeyError, TypeError, ValueError):
            age = None
        return "; " + elastic.Heartbeat.describe(
            [{"index": i, "age_s": age, "phase": rec.get("phase"),
              "cursor": rec.get("cursor")}])

    def heartbeat_fresh(i: int, within_s: float) -> bool:
        rec = read_heartbeat(i)
        if not rec:
            return False
        try:
            return time.time() - float(rec["ts"]) <= within_s
        except (KeyError, TypeError, ValueError):
            return False

    now = time.monotonic
    procs = {i: spawn(i, False) for i in range(total_workers)}
    started = {i: now() for i in procs}
    deadline = {i: (now() + timeout_s if timeout_s > 0 else None)
                for i in procs}
    attempts = {i: 0 for i in procs}
    adoptions = {i: 0 for i in procs}
    respawn_at: dict = {}
    failed: set = set()
    unhealthy: set = set()
    finished: set = set()
    deferred: set = set()
    straggled: set = set()
    baseline_s = None

    def recover(i: int, rc) -> None:
        can_steal = steal_on and bool(finished)
        if attempts[i] < respawn_limit:
            attempts[i] += 1
            if can_steal:
                warnings.warn(
                    "factorize worker %d died (rc=%s); its unfinished "
                    "cells are adopted by the idle fleet now (work-"
                    "stealing via --skip-completed-runs, attempt %d/%d)"
                    % (i, rc, attempts[i], respawn_limit), RuntimeWarning)
                emit("worker_steal", shard=i, attempt=attempts[i],
                     reason="dead_worker")
                respawn_at[i] = now()
            else:
                delay = respawn_delay(backoff_s, attempts[i], i)
                warnings.warn(
                    "factorize worker %d died (rc=%s); respawning onto its "
                    "unfinished ledger shard in %.1fs (attempt %d/%d)"
                    % (i, rc, delay, attempts[i], respawn_limit),
                    RuntimeWarning)
                respawn_at[i] = now() + delay
        elif can_steal and adoptions[i] < 1:
            adoptions[i] += 1
            warnings.warn(
                "factorize worker %d exhausted its respawn budget; one "
                "adoption wave steals its unfinished cells before combine "
                "degrades around them" % i, RuntimeWarning)
            emit("worker_steal", shard=i,
                 attempt=respawn_limit + adoptions[i],
                 reason="respawn_budget_exhausted")
            respawn_at[i] = now()
        elif steal_on and not finished and adoptions[i] < 1:
            deferred.add(i)
            warnings.warn(
                "factorize worker %d exhausted its respawn budget before "
                "any worker finished; its adoption wave is deferred "
                "until the fleet proves the environment" % i,
                RuntimeWarning)
        else:
            failed.add(i)
            warnings.warn(
                "factorize worker %d exited with rc=%s; its replicates "
                "will be skipped at combine (the reference's dead-worker "
                "tolerance)" % (i, rc), RuntimeWarning)

    try:
        while procs or respawn_at:
            for i in [j for j, t in respawn_at.items() if now() >= t]:
                del respawn_at[i]
                procs[i] = spawn(i, True)
                started[i] = now()
                deadline[i] = now() + timeout_s if timeout_s > 0 else None
            for i in list(procs):
                p = procs[i]
                rc = p.poll()
                if rc is None:
                    if deadline[i] is not None and now() > deadline[i]:
                        warnings.warn(
                            "factorize worker %d exceeded CNMF_TPU_WORKER_"
                            "TIMEOUT=%gs; killing it" % (i, timeout_s),
                            RuntimeWarning)
                        p.kill()
                        p.wait()
                        rc = p.returncode
                    elif (straggler_on and baseline_s is not None
                            and i not in straggled
                            and (attempts[i] < respawn_limit
                                 or adoptions[i] < 1)
                            and now() - started[i] > baseline_s + straggler_s
                            and not heartbeat_fresh(i, stale_window)):
                        warnings.warn(
                            "factorize worker %d is a straggler (%.0fs "
                            "elapsed vs the fleet's %.0fs shard wall + "
                            "CNMF_TPU_STRAGGLER_S=%gs grace)%s; killing + "
                            "adopting its shard"
                            % (i, now() - started[i], baseline_s,
                               straggler_s, last_heartbeat(i)),
                            RuntimeWarning)
                        emit("straggler", worker=i, deadline_s=straggler_s,
                             elapsed_s=round(now() - started[i], 1),
                             baseline_s=round(baseline_s, 1))
                        straggled.add(i)
                        p.kill()
                        p.wait()
                        rc = p.returncode
                    else:
                        continue
                del procs[i]
                if rc == 0:
                    finished.add(i)
                    baseline_s = max(baseline_s or 0.0, now() - started[i])
                    for j in sorted(deferred):
                        adoptions[j] += 1
                        warnings.warn(
                            "factorize worker %d's deferred adoption wave "
                            "fires now (worker %d finished cleanly)"
                            % (j, i), RuntimeWarning)
                        emit("worker_steal", shard=j,
                             attempt=attempts[j] + adoptions[j],
                             reason="deferred_until_fleet_proved")
                        respawn_at[j] = now()
                    deferred.clear()
                    continue
                if rc == UNHEALTHY_EXIT_CODE:
                    unhealthy.add(i)
                    continue
                recover(i, rc)
            if procs or respawn_at:
                time.sleep(poll_s)
    finally:
        # a failure of the launcher itself stops every worker it started
        _kill_all(list(procs.values()))
    for i in sorted(deferred):
        failed.add(i)
        warnings.warn(
            "factorize worker %d's deferred adoption never ran (no worker "
            "finished cleanly); its replicates will be skipped at combine"
            % i, RuntimeWarning)
    return failed, unhealthy


def _device_envs(total_workers, devices_per_host, device, visible):
    """Each multihost process's device environment. On the CPU,
    ``devices_per_host`` simulated entries a process
    (``CNMF_SIM_CPU_DEVICES``). On cards (``visible``: the ids the
    launcher sees), each process its own ``devices_per_host`` cards
    (default: the cards split evenly) through ``CUDA_VISIBLE_DEVICES``,
    so that no two processes share a card and the mesh's sums take
    ``nccl``; with fewer cards than processes and no
    ``devices_per_host``, every process sees every card (shared cards:
    ``gloo``)."""
    import torch

    n = int(total_workers)
    if torch.device(device).type == "cpu":
        return [({"CNMF_SIM_CPU_DEVICES": str(int(devices_per_host))}
                 if devices_per_host else {}) for _ in range(n)]
    visible = [str(v) for v in visible]
    per = (int(devices_per_host) if devices_per_host
           else len(visible) // n)
    if per < 1:
        return [{} for _ in range(n)]
    if per * n > len(visible):
        raise ValueError(
            f"{n} processes x {per} cards each need {per * n} cards; "
            f"{len(visible)} are visible")
    return [{"CUDA_VISIBLE_DEVICES": ",".join(visible[p * per:
                                                      (p + 1) * per])}
            for p in range(n)]


def _visible_cards(base_env) -> list:
    """The card ids a child process would see: ``CUDA_VISIBLE_DEVICES``
    when set, else every card."""
    import torch

    ids = base_env.get("CUDA_VISIBLE_DEVICES")
    if ids is not None:
        return [v.strip() for v in ids.split(",") if v.strip()]
    return [str(i) for i in range(torch.cuda.device_count())]


def _run_multihost(output_dir, name, total_workers, devices_per_host,
                   factorize_flags, base_env, timeout_s=None,
                   device="cuda"):
    """Spawn ``total_workers`` processes joined into one mesh on a free
    localhost port, each with its devices (:func:`_device_envs`); every
    process is killed when one fails or the ``timeout_s`` wall passes."""
    visible = (_visible_cards(base_env)
               if str(device).startswith("cuda") else [])
    dev_envs = _device_envs(total_workers, devices_per_host, device,
                            visible)
    port = _free_port()
    layout = [f for f in factorize_flags
              if f in ("--rowshard", "--mesh-grid2d", "--mesh-2d")]
    extra = (["--distributed"] + ([] if layout else ["--mesh-2d"])
             + list(factorize_flags))
    procs = []
    try:
        for pid in range(total_workers):
            env = dict(base_env,
                       CNMF_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       CNMF_NUM_PROCESSES=str(total_workers),
                       CNMF_PROCESS_ID=str(pid), **dev_envs[pid])
            procs.append(subprocess.Popen(_worker_cmd(output_dir, name,
                                                      extra), env=env))
        t0 = time.monotonic()
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if timeout_s and time.monotonic() - t0 > timeout_s:
                break
            time.sleep(0.05)
    finally:
        _kill_all(procs)
    bad = [(pid, p.returncode) for pid, p in enumerate(procs)
           if p.returncode]
    if bad:
        # one mesh has no partial completion: a dead process stalls the
        # collectives of every other
        raise RuntimeError(f"multihost factorize failed on processes {bad}")


def run_pipeline(counts: str, output_dir: str, name: str, components,
                 n_iter: int = 100, total_workers: int = 1,
                 seed: int | None = None, numgenes: int = 2000,
                 genes_file: str | None = None, tpm: str | None = None,
                 beta_loss: str = "frobenius", init: str = "random",
                 max_nmf_iter: int = 1000, batch_size: int = 5000,
                 engine: str = "subprocess",
                 devices_per_host: int | None = None,
                 clean: bool = False,
                 factorize_flags: list | None = None, device="cuda",
                 timeout_s: float | None = None) -> None:
    """prepare -> parallel factorize -> combine -> ``k_selection_plot``
    (-> the clean sweep).

    ``engine='subprocess'``: ``total_workers`` processes shard the ledger.
    ``engine='multihost'``: ``total_workers`` processes form one mesh;
    ``devices_per_host`` gives each that many CPU entries on the CPU (a
    simulated pod) and that many cards of its own on cards (default: the
    visible cards split evenly; with fewer cards than processes they share
    them, and the collectives run on gloo).
    ``factorize_flags``: CLI flags forwarded to every factorize worker
    (``--mesh-2d``, ``--rowshard``, ``--sequential``, ...); ``device``
    rides along as ``--device``. ``timeout_s``: the multihost engine's
    wall limit (its processes are killed past it)."""
    factorize_flags = list(factorize_flags or [])
    total_workers = max(int(total_workers), 1)
    if engine not in ("subprocess", "multihost"):
        raise ValueError(f"unknown engine {engine!r}")
    if "--device" not in factorize_flags:
        factorize_flags += ["--device", str(device)]
    from .models.cnmf import cNMF

    obj = cNMF(output_dir=output_dir, name=name, device=device)
    obj.prepare(counts, components=components, n_iter=n_iter, seed=seed,
                num_highvar_genes=numgenes, genes_file=genes_file,
                tpm_fn=tpm, beta_loss=beta_loss, init=init,
                max_NMF_iter=max_nmf_iter, batch_size=batch_size,
                total_workers=max(total_workers, 1))

    base_env = dict(os.environ)
    # workers import this package whatever their working directory
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base_env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + ([base_env["PYTHONPATH"]]
                      if base_env.get("PYTHONPATH") else []))

    # the launcher owns the run's root trace when sampling is on; workers
    # parent their spans on it through the environment
    from .obs import tracing as obs_tracing

    run_trace = obs_tracing.new_trace()
    if run_trace is not None:
        base_env[obs_tracing.TRACE_CTX_ENV] = obs_tracing.header_value(
            run_trace)

    any_failed = False
    if engine == "subprocess":
        from .utils.telemetry import EventLog

        events = EventLog(os.path.join(
            output_dir, name, "cnmf_tmp", f"{name}.events.jsonl"))
        with obs_tracing.span(events, run_trace, "launcher.run",
                              workers=total_workers):
            failed, unhealthy = _run_subprocess_workers(
                output_dir, name, total_workers, factorize_flags, base_env,
                events=events)
        if unhealthy:
            raise RuntimeError(
                "factorize worker(s) %s reported too few healthy "
                "replicates (below CNMF_TPU_MIN_HEALTHY_FRAC; see their "
                "output above) — aborting before combine/consensus"
                % sorted(unhealthy))
        any_failed = bool(failed)
        if len(failed) == total_workers:
            raise RuntimeError(
                f"all {total_workers} factorize workers failed (respawn "
                "budget exhausted); see their output above")
    else:
        _run_multihost(output_dir, name, total_workers, devices_per_host,
                       factorize_flags, base_env, timeout_s=timeout_s,
                       device=device)

    obj.combine(skip_missing_files=any_failed)
    obj.k_selection_plot(close_fig=True)
    if clean:
        _clean_run_dir(os.path.join(output_dir, name))


def _clean_run_dir(run_dir: str):
    """The reference's removal of the per-replicate spectra once the
    merged spectra exist, plus what killed workers leave behind: pass
    checkpoints, heartbeats, atomic-write temp files (also inside the
    shard store) and the remote store's read-through cache entries. The
    shard store itself stays (a prepare artifact, and under
    ``CNMF_TPU_OOC=1`` the only copy of the matrix)."""
    for pattern in (os.path.join("cnmf_tmp", "*.iter_*.df.npz"),
                    os.path.join("cnmf_tmp", "*.ckpt.k_*.npz"),
                    os.path.join("cnmf_tmp", "*.heartbeat.*.json"),
                    os.path.join("cnmf_tmp", "*.tmp-*"),
                    os.path.join("cnmf_tmp", ".tmp_*"),
                    os.path.join("cnmf_tmp", "*.norm_counts.store",
                                 "*.tmp-*"),
                    os.path.join("cnmf_tmp", "*.norm_counts.store.cache",
                                 "*"),
                    "*.tmp-*", ".tmp_*"):
        for f in glob.glob(os.path.join(run_dir, pattern)):
            if os.path.isfile(f):
                os.remove(f)
