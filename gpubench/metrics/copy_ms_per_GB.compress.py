"""Device ms of host-to-device and device-to-host copies in the traced
window, per 10^9 bytes of user data."""

from gpubench.lib.metric_math import copy_ms_per_gb


def read(run):
    return copy_ms_per_gb(run)
