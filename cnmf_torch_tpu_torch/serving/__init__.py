"""The serving tier: a persistent multi-tenant projection daemon over
published reference spectra, and the replicated fleet in front of it.

Many users project their cells onto a published reference (a usage refit
with the spectra fixed) and expect usage matrices back in milliseconds:

  * ``reference.py`` — the reference spectra loaded once and held on the
    device with their loop-invariant products;
  * ``batcher.py`` — the admission queue and micro-batching dispatcher:
    concurrent requests coalesce into ONE bucketed ``(lanes, rows,
    genes)`` usage solve, each request held to its solo refit, with
    per-lane health grading and tenant quarantine;
  * ``daemon.py`` — the stdlib HTTP/JSON front end (unix socket or
    127.0.0.1 TCP) and its client, behind ``python -m
    cnmf_torch_tpu_torch serve <run_dir>``;
  * ``fleet.py`` — the replicated fleet behind ``... fleet <run_dir>``:
    consistent-hash tenant routing over N serve replicas, per-tenant
    quotas, failover with idempotent retries and zero-downtime reference
    rollover.

Every entry point takes ``device`` (default ``"cuda"``) and raises without
a card unless asked for ``"cpu"``. Knobs: ``CNMF_TPU_SERVE_BATCH`` /
``_LINGER_MS`` / ``_BUCKETS`` / ``_TIMEOUT_S`` / ``_WARM_START`` /
``_DRAIN_S``, the ``CNMF_TPU_FLEET_*`` family and
``CNMF_TPU_WARM_DUMMY_BUDGET_BYTES``. Telemetry: ``serve_request`` /
``serve_batch`` / ``replica_death`` / ``failover`` / ``rollover`` events,
rendered by ``report``.
"""

from .batcher import (PoisonError, ProjectionService, QuarantinedError,
                      ServeError, ShedError)
from .daemon import (REQUEST_ID_HEADER, ServeClient, ServeDaemon,
                     default_socket_path, serve_forever)
from .fleet import (FleetClient, FleetDaemon, FleetRouter, HashRing,
                    SubprocessReplica, TokenBucket,
                    default_fleet_socket_path, fleet_forever)
from .reference import (ReferenceError, ResidentReference, find_references,
                        load_reference)

__all__ = [
    "ServeError",
    "ShedError",
    "PoisonError",
    "QuarantinedError",
    "ProjectionService",
    "REQUEST_ID_HEADER",
    "ServeClient",
    "ServeDaemon",
    "default_socket_path",
    "serve_forever",
    "FleetClient",
    "FleetDaemon",
    "FleetRouter",
    "HashRing",
    "SubprocessReplica",
    "TokenBucket",
    "default_fleet_socket_path",
    "fleet_forever",
    "ReferenceError",
    "ResidentReference",
    "find_references",
    "load_reference",
]
