"""Arithmetic the metric readers share. A reader returns None where the
run has nothing for it to read."""

from __future__ import annotations

import math

from . import roofline
from . import trace as T


def rate_mb_per_s(run):
    """User bytes over the whole window, 10^6 bytes a second."""
    if not run.window_s or not run.user_bytes:
        return None
    return run.user_bytes / run.window_s / 1e6


def p95(values):
    """The 95th percentile, nearest rank."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def cell_cards(run):
    """The cell's cards in the run's trace (``trace.cell_cards``): the
    run's ``cards``, or one where the run does not say."""
    return T.cell_cards(run.trace, getattr(run, "cards", 1))


def device_idle_pct(run):
    """The mean of the cell's cards' idle shares of the traced window: 1
    less the seconds each card ran an operation, summed over the cards,
    over the cards' number times the window, in %."""
    tr = run.trace
    if tr is None or not tr.device() or not tr.window_s:
        return None
    busy = [T.covered(tr.device(c)) for c in cell_cards(run)]
    return 100.0 * (1.0 - sum(busy) / (len(busy) * tr.window_s))


def kernels_roofline_pct(run):
    """The least time the window's bytes need at the peak of the cell's
    cards together, over the mean card's time in which at least one
    kernel ran on it: the bytes' least time at one card's peak over the
    kernel time summed over the cards."""
    tr = run.trace
    if tr is None or not tr.kernels or not run.roofline_bytes:
        return None
    kernel_s = sum(T.covered(tr.kernels_on(c)) for c in cell_cards(run))
    return 100.0 * roofline.least_seconds(run.roofline_bytes) / kernel_s


def copy_ms_per_gb(run):
    tr = run.trace
    if tr is None or not tr.copies or not run.user_bytes:
        return None
    return T.copy_seconds(tr) * 1e3 / (run.user_bytes / 1e9)
