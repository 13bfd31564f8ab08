"""The lint gate: the port must produce no unbaselined finding.

    python -m cnmf_torch_tpu_torch.analysis.gate

Lints the ``cnmf_torch_tpu_torch`` package, its tutorials
(``examples/``) included (every rule family and the ``KNOBS.md`` drift
check) against the checked-in baseline
(``analysis/baseline.json``, shipped empty) and prints one line of counts,
a family each, ``LINT_GATE: <family>=<n> ... baselined=<n>
suppressed=<n> files=<n>``. Exit 0: clean; 1: findings (printed after the
line). Imports no torch.
"""

from __future__ import annotations

import os
import sys

from .engine import DEFAULT_BASELINE, PACKAGE_DIR, format_text, lint_paths


def main() -> int:
    result = lint_paths([PACKAGE_DIR], baseline_path=DEFAULT_BASELINE,
                        root=os.path.dirname(PACKAGE_DIR))
    fams = " ".join(f"{fam}={n}" for fam, n in
                    sorted(result.family_counts().items()))
    print(f"LINT_GATE: {fams} baselined={len(result.baselined)} "
          f"suppressed={result.suppressed} files={result.files}")
    if result.findings:
        print(format_text(result))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
