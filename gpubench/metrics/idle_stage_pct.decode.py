"""The share of the traced window, %, in which the device was idle while
the calling thread's innermost span was the staging of a window's planes
(``host.pack``, ``copy.stage``)."""

from gpubench.lib.spans import idle_pct


def read(run):
    return idle_pct(run, ("host.pack", "copy.stage"))
