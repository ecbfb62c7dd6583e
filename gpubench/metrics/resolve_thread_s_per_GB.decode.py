"""Thread CPU seconds of the host resolve over the traced window (the
``cpu_ns`` counts of the ``host.bulk_prep`` and ``host.bulk_gang`` spans,
on the pool's threads) per 10^9 bytes of user data the window moved."""

from gpubench.lib.spans import cpu_seconds


def read(run):
    s = cpu_seconds(run, ("host.bulk_prep", "host.bulk_gang"))
    if s is None or not run.user_bytes:
        return None
    return s / (run.user_bytes / 1e9)
