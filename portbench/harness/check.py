"""The verdict that decides ``correct``, from the numbers a traffic kind's
``compare`` works out against the plain reference (``reference/``) and the
limits in the cell's configuration (``limits``)."""

from __future__ import annotations

import numpy as np


def gap_summary(name: str, gaps: list) -> dict:
    """``{name_median, name_max}`` of ``gaps`` (not a number when empty)."""
    nan = float("nan")
    return {f"{name}_median": float(np.median(gaps)) if gaps else nan,
            f"{name}_max": float(max(gaps)) if gaps else nan}


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: [number, limit]})`` over the limited numbers; a
    number that is not finite fails."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        v = nums[name]
        shown[name] = [v, limit]
        if not (np.isfinite(v) and v <= limit):
            ok = False
    return ok, shown
