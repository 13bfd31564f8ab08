"""``h_stats``' share of its roofline, in %: the least time of the job's
launches by the frozen work count over the device time of
``h_stats_kernel``."""

from portbench.harness.roofline import share_pct


def read(record):
    return share_pct(record, "h_stats", ("h_stats_kernel",))
