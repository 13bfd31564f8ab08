"""A kernel's share of its roofline over a traced job: the least time the
frozen work count allows (``workcount.py``), summed over the job's launches
each priced at its K group's ``k`` and ``R``, over the kernel's summed
device time."""

from __future__ import annotations

from . import workcount


def share_pct(record: dict, kernel: str, device_names: tuple) -> float | None:
    prof = record.get("profile")
    if not prof:
        return None
    t_dev = sum(s for name, s in prof["by_name"].items()
                if any(d in name for d in device_names))
    cfg = record["config"]
    chunks = record["chunks"]
    rows = sum(r for r, _ in chunks) / len(chunks)
    slots = sum(s for _, s in chunks) / len(chunks)
    count = workcount.KERNELS[kernel]
    least = 0.0
    for grp in record["jobs"][0]["groups"]:
        launches = grp["launches"].get(kernel, 0)
        if launches:
            ops, nbytes = count(grp["R"], slots, rows, grp["k"],
                                cfg["num_highvar_genes"], cfg["chain"])
            least += launches * workcount.least_seconds(ops, nbytes,
                                                        cfg["chain"])[0]
    if t_dev <= 0 or least <= 0:
        return None
    return 100.0 * least / t_dev
