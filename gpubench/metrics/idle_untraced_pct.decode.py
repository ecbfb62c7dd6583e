"""The share of the traced window, %, in which the device was idle while
the calling thread had no span open inside a call: in ``decode.call``
itself, or in no call."""

from gpubench.lib.spans import UNTRACED, idle_pct


def read(run):
    return idle_pct(run, (UNTRACED,))
