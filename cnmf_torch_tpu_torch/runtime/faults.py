"""Deterministic fault injection behind ``CNMF_TPU_FAULT_SPEC``.

Own copy of ``cnmf_torch_tpu/runtime/faults.py``: the same spec grammar,
the same 14 fault kinds, selector and control keys and the same errors, so
one ``CNMF_TPU_FAULT_SPEC`` means one thing to both packages. The port
calls the hooks of the layers it has:

* ``nonfinite`` -- :func:`maybe_poison_lanes` sets replicate lanes to NaN
  after a sweep returns (the quarantine and derived-seed retry path);
* ``kill`` -- :func:`maybe_kill` SIGKILLs this process at a stage hook
  (the resume path);
* ``torn`` -- :func:`maybe_tear` truncates an artifact after its atomic
  write lands (reader-side validation in resume and combine);
* ``upload`` -- :func:`maybe_fail` raises at the host-to-device staging of
  a replicate sweep;
* ``straggler`` -- :func:`maybe_straggle` sleeps at a per-task hook;
* ``stall`` -- :func:`maybe_stall` sleeps where a slab upload of the
  staging pipeline would hang (``parallel/streaming.py``), for its stall
  watchdog;
* ``shard_read`` -- :func:`maybe_shard_read` makes the shard store
  corrupt the slab it just read (``utils/shardstore.py``), for its
  digest check and re-read;
* ``netflake``, ``netslow``, ``netdown``, ``nettorn`` --
  :func:`maybe_netfault` fails, delays or tears a request of the remote
  object store (``utils/storebackend.py``) before its socket opens;
* ``hostloss`` -- :func:`maybe_hostloss` raises :class:`HostLossError` at
  a pass, replicate or 2-D sweep boundary, for the elastic re-mesh
  (``runtime/elastic.py``).

* ``replicadeath``, ``replicawedge`` -- :func:`maybe_replicadeath` and
  :func:`maybe_replicawedge` tell the fleet router's supervisor
  (``serving/fleet.py``) to SIGKILL or SIGSTOP a serve replica.

Spec grammar (semicolon-separated clauses)::

    CNMF_TPU_FAULT_SPEC="nonfinite:k=5,iter=2;kill:stage=factorize,worker=1;torn:artifact=iter_"

Each clause is ``kind`` or ``kind:key=val[,key=val...]``. Selector keys
(``k``, ``iter``, ``attempt``, ``seed``, ``stage``, ``worker``,
``artifact``, ``context``) narrow where the fault fires; control keys
modulate it: ``after=N`` skips the first N matching hook hits,
``limit=N`` caps injections per process, and ``once=PATH`` claims a
filesystem sentinel with ``O_CREAT|O_EXCL`` so exactly one process ever
injects the clause (a respawned worker must not kill itself again).

With the spec unset or empty every hook returns after one cached lookup.
The module imports only the standard library at import time.
"""

from __future__ import annotations

import os
import signal
import threading

__all__ = ["FAULT_SPEC_ENV", "FaultClause", "parse_fault_spec",
           "active_spec", "maybe_poison_lanes", "maybe_kill", "maybe_tear",
           "maybe_fail", "maybe_straggle", "maybe_stall",
           "maybe_shard_read", "maybe_netfault", "HostLossError",
           "maybe_hostloss", "maybe_replicadeath", "maybe_replicawedge"]

FAULT_SPEC_ENV = "CNMF_TPU_FAULT_SPEC"

_KINDS = ("nonfinite", "kill", "torn", "upload", "stall", "hostloss",
          "straggler", "shard_read", "netflake", "netslow", "netdown",
          "nettorn", "replicadeath", "replicawedge")
_CONTROL_KEYS = ("after", "limit", "once")


class HostLossError(RuntimeError):
    """Injected topology failure: a mesh participant (host/device) died.

    ``lost`` names the simulated lost device ids (empty = "lose the last
    ``count`` devices of whatever mesh the catcher holds"). The elastic
    controller treats this exactly like a real device-loss error; a real
    loss identifies its dead devices by probing, an injected one by
    decree."""

    def __init__(self, message: str, lost=(), count: int = 1):
        super().__init__(message)
        self.lost = tuple(int(d) for d in lost)
        self.count = int(count)


class FaultClause:
    """One parsed clause: ``kind``, its params and per-process hit
    counters. Parsed specs are cached per raw string, so the ``after`` and
    ``limit`` counters survive repeated hook calls."""

    __slots__ = ("kind", "params", "hits", "injected")

    def __init__(self, kind: str, params: dict):
        self.kind = kind
        self.params = params
        self.hits = 0
        self.injected = 0

    def __repr__(self):
        return f"FaultClause({self.kind!r}, {self.params!r})"


def parse_fault_spec(raw: str) -> list[FaultClause]:
    """Parse a spec string; raises ``ValueError`` on malformed input, so a
    mistyped spec fails loudly instead of injecting nothing."""
    clauses = []
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"{FAULT_SPEC_ENV}: unknown fault kind {kind!r} in "
                f"{part!r} (known: {', '.join(_KINDS)})")
        params: dict = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep, val = kv.partition("=")
            if not sep or not key:
                raise ValueError(
                    f"{FAULT_SPEC_ENV}: expected key=value, got {kv!r} "
                    f"in clause {part!r}")
            val = val.strip()
            params[key.strip()] = int(val) if val.lstrip("-").isdigit() \
                else val
        clauses.append(FaultClause(kind, params))
    return clauses


# parsed-spec cache keyed on the raw env value: a hook costs one getenv
# and one string compare while the spec stays the same
_cache: tuple[str, list[FaultClause]] | None = None
_cache_lock = threading.Lock()


def active_spec() -> list[FaultClause] | None:
    """The parsed clauses of ``CNMF_TPU_FAULT_SPEC``, or None when unset."""
    global _cache
    from ..utils.envknobs import env_str

    raw = env_str(FAULT_SPEC_ENV, "")
    if not raw.strip():
        return None
    cache = _cache
    if cache is None or cache[0] != raw:
        with _cache_lock:
            cache = _cache
            if cache is None or cache[0] != raw:
                cache = (raw, parse_fault_spec(raw))
                _cache = cache
    return cache[1]


def _take_once(params: dict) -> bool:
    """Claim the clause's ``once`` sentinel; True when this process may
    inject (one ``O_CREAT|O_EXCL`` open is the cross-process claim)."""
    path = params.get("once")
    if path is None:
        return True
    try:
        os.close(os.open(str(path), os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except OSError:
        return False


def _selector_match(params: dict, ctx: dict) -> bool:
    for key, want in params.items():
        if key in _CONTROL_KEYS:
            continue
        if key not in ctx:
            return False
        have = ctx[key]
        if isinstance(want, int):
            try:
                if int(have) != want:
                    return False
            except (TypeError, ValueError):
                return False
        elif str(want) != str(have):
            return False
    return True


def _clause_fires(clause: FaultClause, context, worker,
                  default_limit: int | None) -> bool:
    """``context`` substring and ``worker`` selectors, then the ``after``,
    ``limit`` and ``once`` controls (``default_limit=None``: unbounded
    unless the clause caps it). True means inject now."""
    params = clause.params
    sub = params.get("context")
    if sub is not None and str(sub) not in str(context or ""):
        return False
    if "worker" in params:
        try:
            if worker is None or int(worker) != int(params["worker"]):
                return False
        except (TypeError, ValueError):
            return False
    clause.hits += 1
    if clause.hits <= int(params.get("after", 0)):
        return False
    limit = params.get("limit", default_limit)
    if limit is not None and clause.injected >= int(limit):
        return False
    if not _take_once(params):
        return False
    clause.injected += 1
    return True


def maybe_poison_lanes(k, iters, spectra, errs, attempt: int = 0,
                       seeds=None):
    """Set the replicate lanes that match a ``nonfinite`` clause to NaN.

    ``spectra``/``errs`` are one sweep's numpy results, lane axis first.
    Selectors: ``k``, ``iter`` (one ledger iter; omitted: every lane),
    ``seed`` (no match where the hook has no seeds), ``attempt`` (default
    0, so retries run clean). Returns ``(spectra, errs)``, copied when a
    lane was poisoned; the unset spec returns the inputs untouched."""
    spec = active_spec()
    if spec is None:
        return spectra, errs
    import numpy as np

    lanes = []
    for clause in spec:
        if clause.kind != "nonfinite":
            continue
        params = clause.params
        if int(params.get("attempt", 0)) != int(attempt):
            continue
        if "k" in params and int(params["k"]) != int(k):
            continue
        if "iter" in params:
            clause_lanes = [j for j, it in enumerate(iters)
                            if int(it) == int(params["iter"])]
        elif "seed" in params:
            clause_lanes = ([] if seeds is None else
                            [j for j, s in enumerate(seeds)
                             if int(s) == int(params["seed"])])
        else:
            clause_lanes = list(range(len(iters)))
        if not clause_lanes:
            continue
        # one matching sweep observation is one hit; `limit` caps
        # injections per process (default unbounded)
        clause.hits += 1
        if clause.hits <= int(params.get("after", 0)):
            continue
        if "limit" in params and clause.injected >= int(params["limit"]):
            continue
        if not _take_once(params):
            continue
        clause.injected += 1
        lanes.extend(clause_lanes)
    if not lanes:
        return spectra, errs
    spectra = np.array(spectra, dtype=np.float32, copy=True)
    errs = np.array(errs, dtype=np.float64, copy=True)
    for j in set(lanes):
        spectra[j] = np.nan
        errs[j] = np.nan
    return spectra, errs


def maybe_kill(stage: str, worker=None) -> None:
    """SIGKILL this process when a ``kill`` clause matches the hook (the
    real preemption signal: nothing can catch it). The hooks sit after
    artifact writes, so a kill leaves what a real preemption leaves."""
    spec = active_spec()
    if spec is None:
        return
    for clause in spec:
        if clause.kind != "kill":
            continue
        if not _selector_match(clause.params,
                               {"stage": stage, "worker": worker}):
            continue
        clause.hits += 1
        if clause.hits <= int(clause.params.get("after", 0)):
            continue
        if not _take_once(clause.params):
            continue
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_tear(path) -> bool:
    """Truncate ``path`` to a third of its bytes when a ``torn`` clause's
    ``artifact`` substring matches its basename (a simulated torn write,
    for the reader-side validation of resume and combine). ``limit``
    defaults to 1 per clause. Returns True when the file was torn."""
    spec = active_spec()
    if spec is None:
        return False
    name = os.path.basename(os.fspath(path))
    for clause in spec:
        if clause.kind != "torn":
            continue
        sub = str(clause.params.get("artifact", ""))
        if sub and sub not in name:
            continue
        clause.hits += 1
        if clause.hits <= int(clause.params.get("after", 0)):
            continue
        if clause.injected >= int(clause.params.get("limit", 1)):
            continue
        if not _take_once(clause.params):
            continue
        try:
            size = os.path.getsize(path)
            # tearing the artifact in place is this injector's job
            with open(path, "r+b") as f:  # cnmf-lint: disable=artifact-nonatomic
                f.truncate(max(1, size // 3))
            clause.injected += 1
            return True
        except OSError:
            return False
    return False


def maybe_hostloss(context=None, worker=None) -> None:
    """Raise :class:`HostLossError` when a ``hostloss`` clause matches —
    the injectable form of a host/device dying mid-run. Selectors:
    ``context`` (substring match against the hook site — ``pass`` for the
    rowsharded per-pass boundary, ``replicate`` for the post-solve
    boundary, ``sweep2d`` for the 2-D sweep's slice loop), ``worker``.
    Clause params ``devices`` (``+``-separated ids, e.g. ``devices=2+3``)
    or ``count=N`` (default 1: lose the last N devices of the mesh the
    catcher holds) describe WHAT died. ``limit`` defaults to 1 — one
    topology loss per process, so the degraded continuation itself runs
    clean and the recovery is observable."""
    spec = active_spec()
    if spec is None:
        return
    for clause in spec:
        if clause.kind != "hostloss":
            continue
        if not _clause_fires(clause, context, worker, default_limit=1):
            continue
        params = clause.params
        lost = [int(d) for d in
                str(params.get("devices", "")).split("+") if d != ""]
        raise HostLossError(
            "cnmf-tpu injected fault: hostloss (context=%s, lost=%s, "
            "count=%s) — a mesh participant died"
            % (context, lost or "last-%d" % int(params.get("count", 1)),
               params.get("count", 1)),
            lost=lost, count=int(params.get("count", 1)))


def maybe_straggle(context=None, worker=None) -> float:
    """Sleep ``seconds`` (default 1) when a ``straggler`` clause matches
    (``context`` substring, ``worker``); unbounded unless ``limit`` is
    given. Returns the seconds slept."""
    spec = active_spec()
    if spec is None:
        return 0.0
    import time

    for clause in spec:
        if clause.kind != "straggler":
            continue
        if not _clause_fires(clause, context, worker, default_limit=None):
            continue
        secs = float(clause.params.get("seconds", 1.0))
        time.sleep(secs)
        return secs
    return 0.0


def maybe_fail(kind: str, **ctx) -> None:
    """Raise ``RuntimeError`` when a clause of ``kind`` matches ``ctx``
    (the ``upload`` class at the staging entry points; ``context`` selects
    by substring)."""
    spec = active_spec()
    if spec is None:
        return
    for clause in spec:
        if clause.kind != kind:
            continue
        params = clause.params
        sub = params.get("context")
        if sub is not None and str(sub) not in str(ctx.get("context", "")):
            continue
        rest = {key: val for key, val in params.items()
                if key not in _CONTROL_KEYS and key != "context"}
        if not _selector_match(rest, ctx):
            continue
        clause.hits += 1
        if clause.hits <= int(params.get("after", 0)):
            continue
        if not _take_once(params):
            continue
        raise RuntimeError(
            f"cnmf-tpu injected fault: {kind} "
            f"({', '.join(f'{key}={val}' for key, val in sorted(ctx.items()))})")


def maybe_stall(context=None) -> float:
    """Sleep ``seconds`` (default 30) when a ``stall`` clause matches
    ``context`` (substring) — a hung slab transfer; ``limit`` defaults to
    1. Returns the seconds slept."""
    spec = active_spec()
    if spec is None:
        return 0.0
    import time

    for clause in spec:
        if clause.kind != "stall":
            continue
        if not _clause_fires(clause, context, None, default_limit=1):
            continue
        secs = float(clause.params.get("seconds", 30.0))
        time.sleep(secs)
        return secs
    return 0.0


def maybe_shard_read(context=None, worker=None) -> bool:
    """True when a ``shard_read`` clause matches — a torn slab read: the
    shard store then corrupts the slab it just loaded, so its digest
    check must catch it and re-read. ``limit`` defaults to 1."""
    spec = active_spec()
    if spec is None:
        return False
    for clause in spec:
        if clause.kind != "shard_read":
            continue
        if _clause_fires(clause, context, worker, default_limit=1):
            return True
    return False


def maybe_netfault(op=None, context=None) -> str | None:
    """The network-fault hook of the remote store backend, called once a
    request before its socket opens, with ``op`` the lowercased method
    (``get``/``put``/``head``/``delete``) and ``context`` the object
    name. A clause's ``context`` selector is a substring of
    ``op:object``, so ``netdown:context=get:slab`` downs slab GETs while
    the manifest, HEAD probes and listings stay up.

    * ``netflake`` raises ``ConnectionError`` (the retry ladder heals
      it); ``limit`` defaults to 1.
    * ``netslow`` sleeps ``seconds`` (default 2), then proceeds: the
      slow request a hedged read must beat; ``limit`` defaults to 1.
    * ``netdown`` raises ``ConnectionError`` on every matching request
      (unbounded): an outage that ends in degraded service from the
      cache or a named ``RemoteStoreError``.
    * ``nettorn`` returns ``"tear"``: the backend flips a byte of the
      body it hands back, for the shard reader's digest check;
      ``limit`` defaults to 1.

    Returns ``"tear"`` when the caller must corrupt the body, else None.
    """
    spec = active_spec()
    if spec is None:
        return None
    import time

    ctx = "%s:%s" % (op or "", context or "")
    for clause in spec:
        if clause.kind not in ("netflake", "netslow", "netdown", "nettorn"):
            continue
        limit = None if clause.kind == "netdown" else 1
        if not _clause_fires(clause, ctx, None, default_limit=limit):
            continue
        if clause.kind == "netslow":
            time.sleep(float(clause.params.get("seconds", 2.0)))
            return None
        if clause.kind == "nettorn":
            return "tear"
        raise ConnectionError(
            "cnmf-tpu injected fault: %s (%s) — remote store unreachable"
            % (clause.kind, ctx))
    return None


def _replica_clause_fires(kind: str, context, worker) -> bool:
    spec = active_spec()
    if spec is None:
        return False
    for clause in spec:
        if clause.kind != kind:
            continue
        if _clause_fires(clause, context, worker, default_limit=1):
            return True
    return False


def maybe_replicadeath(context=None, worker=None) -> bool:
    """True when a ``replicadeath`` clause matches: a serve replica dies
    (OOM kill, preemption, segfault). The fleet supervisor calls it once
    per up replica per tick with ``worker`` the replica's slot and
    SIGKILLs the subprocess when it fires, so failover and respawn run
    against a real dead process. ``limit`` defaults to 1 (the respawned
    replica runs clean)."""
    return _replica_clause_fires("replicadeath", context, worker)


def maybe_replicawedge(context=None, worker=None) -> bool:
    """True when a ``replicawedge`` clause matches: a replica alive but
    unresponsive. The fleet supervisor SIGSTOPs the subprocess (connects
    succeed, replies never come, its heartbeat goes stale), the evidence
    its wedge conviction needs. ``limit`` defaults to 1."""
    return _replica_clause_fires("replicawedge", context, worker)
