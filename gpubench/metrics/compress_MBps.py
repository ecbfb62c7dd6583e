"""Input bytes compressed by every call over the whole window, 10^6
bytes a second."""

from gpubench.lib.metric_math import rate_mb_per_s


def read(run):
    return rate_mb_per_s(run)
