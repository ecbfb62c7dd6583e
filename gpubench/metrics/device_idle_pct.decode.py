"""The share of the traced window in which no kernel, copy or memset ran
on the device, in %."""

from gpubench.lib.metric_math import device_idle_pct


def read(run):
    return device_idle_pct(run)
