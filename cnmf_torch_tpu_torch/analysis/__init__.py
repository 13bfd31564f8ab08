"""The port's static analysis (``python -m cnmf_torch_tpu_torch lint``).

See :mod:`.engine` for the rule engine and CLI and :mod:`.gate` for the
gate; rule families live in ``rules_sync`` (host reads and global RNG
draws on the solver paths), ``rules_knobs`` (the knob registry and its
table ``KNOBS.md``), ``rules_artifacts`` (atomic writes),
``rules_telemetry`` (the event schema at emit sites) and
``rules_concurrency`` (module-state lock discipline). ``baseline.json``
is the checked-in grandfather list, shipped empty: the port lints clean.
"""

from .engine import Finding, LintResult, lint_paths

__all__ = ["Finding", "LintResult", "lint_paths"]
