"""``w_numer``'s share of its roofline, in %: the least time of the job's
launches by the frozen work count over the device time of
``w_numer_kernel`` and its ``w_numer_prep_kernel``."""

from portbench.harness.roofline import share_pct


def read(record):
    return share_pct(record, "w_numer",
                     ("w_numer_kernel", "w_numer_prep_kernel"))
