"""Passes a replicate ran, the mean over every replicate of the window
(the sweep's per-pass objectives in ``factorize_info["trace"]``)."""


def read(record):
    passes = [p for job in record["jobs"] for p in job["passes"]]
    return sum(passes) / len(passes) if passes else None
