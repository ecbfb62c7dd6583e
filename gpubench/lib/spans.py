"""The program's own spans over a traced window
(``turbosqueeze_tpu_torch.utils.profiling.spans``), put on the window's
clock, and each idle instant of each of the cell's cards put down to the
innermost span open at that instant on the thread that opened the call.

The window starts where ``core.run_cell`` takes ``setup_s``: process start
(``CLOCK_BOOTTIME``, from ``/proc/self/stat``) plus ``setup_s``, just
before it opens the window's mark. The spans are stamped with
``time.perf_counter_ns`` (``CLOCK_MONOTONIC`` on Linux); the two clocks
are read side by side to move one onto the other. A program without
spans, or a run without a trace, reads None.
"""

from __future__ import annotations

import time
from collections import defaultdict

from .. import core
from . import metric_math as M
from . import trace as T

# the spans of a call's own entry: idle time inside them and outside any
# call is untraced
CALLS = ("decode.call", "compress.call")
UNTRACED = "untraced"


def program_spans():
    """The program's recorded spans, or None where it records none."""
    try:
        from turbosqueeze_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def window_start_ns(setup_s: float) -> int:
    """The window's start on ``time.perf_counter_ns``'s clock: the
    process's age (``core.process_age_s``, which reads ``CLOCK_BOOTTIME``
    last) beside a reading of that clock, less ``setup_s``."""
    age = core.process_age_s()
    now = time.perf_counter_ns()
    return now - round((age - setup_s) * 1e9)


def on_window(run, spans=None):
    """[(span, start s, end s)] of the spans that overlap the traced
    window, from its start; None where there are none."""
    tr = run.trace
    if tr is None or not tr.window_s:
        return None
    spans = program_spans() if spans is None else spans
    if not spans:
        return None
    t0 = window_start_ns(run.setup_s)
    out = [(s, (s.start_ns - t0) / 1e9, (s.end_ns - t0) / 1e9)
           for s in spans]
    out = [(s, a, b) for s, a, b in out if b > 0 and a < tr.window_s]
    return out or None


def idle_by_span(run, spans=None):
    """Idle seconds of the cell's cards in the traced window by the name
    of the innermost span open on the calling thread (``UNTRACED`` for a
    call's own span or no call), summed over the cards; the values sum to
    the cards' idle time together. None where the window has no spans."""
    placed = on_window(run, spans)
    if placed is None:
        return None
    tr = run.trace
    tids = {s.call: s.tid for s, _, _ in placed if s.id == s.call}
    mine = [(s, max(a, 0.0), min(b, tr.window_s)) for s, a, b in placed
            if tids.get(s.call) == s.tid]
    mine = [m for m in mine if m[2] > m[1]]
    # boundaries in time order, ends before starts at one instant and a
    # parent's start before its child's (ids are given in order); the
    # innermost open span is the one opened last
    events = sorted([(a, 1, s.id, i) for i, (s, a, _) in enumerate(mine)]
                    + [(b, 0, 0, i) for i, (_, _, b) in enumerate(mine)])
    labelled, open_, t = [], [], 0.0
    for at, starts, _, i in events:
        if at > t:
            name = mine[open_[-1]][0].name if open_ else UNTRACED
            labelled.append((t, at, UNTRACED if name in CALLS else name))
            t = at
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    if tr.window_s > t:
        labelled.append((t, tr.window_s, UNTRACED))
    idle = defaultdict(float)
    for card in M.cell_cards(run):
        gaps = T.gaps(tr.device(card), tr.window_s)
        k = 0
        for a, b, name in labelled:
            while k < len(gaps) and gaps[k][1] <= a:
                k += 1
            j = k
            while j < len(gaps) and gaps[j][0] < b:
                idle[name] += min(b, gaps[j][1]) - max(a, gaps[j][0])
                j += 1
    return dict(idle)


def idle_pct(run, names):
    """The share of the traced window, %, in which a card was idle and
    the innermost span on the calling thread was one of ``names``, as a
    mean over the cell's cards."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    cards = len(M.cell_cards(run))
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / (
        cards * run.trace.window_s)


def cpu_seconds(run, names):
    """The summed thread CPU time (the ``cpu_ns`` count) of the spans
    named ``names`` that overlap the traced window, s; None where the
    window has no spans."""
    placed = on_window(run)
    if placed is None:
        return None
    return sum(s.counts.get("cpu_ns", 0) for s, _, _ in placed
               if s.name in names) / 1e9
