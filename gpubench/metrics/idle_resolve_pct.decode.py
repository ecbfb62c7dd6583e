"""The share of the traced window, %, in which the device was idle while
the calling thread's innermost span was the host resolve
(``host.resolve``, ``host.merge``)."""

from gpubench.lib.spans import idle_pct


def read(run):
    return idle_pct(run, ("host.resolve", "host.merge"))
