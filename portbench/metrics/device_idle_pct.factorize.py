"""The card's idle share of the traced job, in %: one minus the union of
its kernel and copy intervals over the job's wall."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
