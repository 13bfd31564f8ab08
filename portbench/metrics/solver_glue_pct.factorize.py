"""The share of the card's busy time, in % of the traced job's union of
device intervals, spent in kernels that are neither the port's ELL kernels
nor matrix products: torch's elementwise and reduction glue."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * prof["by_kind"].get("glue", 0.0) / prof["busy_s"]
