"""The share of the traced window, %, in which the device was idle while
the calling thread's innermost span was a window's payload download
(``compress.download``)."""

from gpubench.lib.spans import idle_pct


def read(run):
    return idle_pct(run, ("compress.download",))
