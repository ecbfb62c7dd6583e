"""The least time the bytes of the window's calls need at the card's
peak HBM bandwidth (each input byte read once, each output byte written
once), over the time in which at least one kernel ran, in %."""

from gpubench.lib.metric_math import kernels_roofline_pct


def read(run):
    return kernels_roofline_pct(run)
