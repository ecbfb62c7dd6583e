"""Device intervals of a traced window, read from the Chrome trace that
``torch.profiler`` exports, each with the card it ran on, and the interval
arithmetic the per-layer readers share."""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WINDOW_MARK = "gpubench.window"   # the record_function around the window

Interval = Tuple[str, float, float]   # (name, start s, end s)


@dataclass
class Trace:
    """Kernels, copies and memsets of one window, in seconds from the
    window's start, clipped to ``[0, window_s]``. ``kernel_cards``,
    ``copy_cards`` and ``memset_cards`` hold the card of each interval of
    the list of that name, in its order; an interval past the end of its
    card list ran on card 0."""
    window_s: float
    kernels: List[Interval] = field(default_factory=list)
    copies: List[Interval] = field(default_factory=list)
    memsets: List[Interval] = field(default_factory=list)
    kernel_cards: List[int] = field(default_factory=list)
    copy_cards: List[int] = field(default_factory=list)
    memset_cards: List[int] = field(default_factory=list)

    def _on(self, kind: str, card: Optional[int]) -> List[Interval]:
        intervals = getattr(self, kind)
        if card is None:
            return intervals
        return [i for i, c in zip(intervals, self._card_list(kind))
                if c == card]

    def _card_list(self, kind: str) -> List[int]:
        n = len(getattr(self, kind))
        cards = getattr(self, _CARDS[kind])[:n]
        return cards + [0] * (n - len(cards))

    def cards(self) -> List[int]:
        """The sorted indices of the cards that ran something."""
        return sorted({c for kind in _CARDS for c in self._card_list(kind)})

    def kernels_on(self, card: Optional[int] = None) -> List[Interval]:
        """The kernels that ran on ``card``, or on any card where it is
        None."""
        return self._on("kernels", card)

    def device(self, card: Optional[int] = None) -> List[Interval]:
        """Every interval in which the device ran an operation: on
        ``card``, or on any card where it is None."""
        return (self._on("kernels", card) + self._on("copies", card)
                + self._on("memsets", card))


_CARDS = {"kernels": "kernel_cards", "copies": "copy_cards",
          "memsets": "memset_cards"}
_KINDS = {"kernel": "kernels", "gpu_memcpy": "copies",
          "gpu_memset": "memsets"}


def cell_cards(tr: Trace, n: int) -> List[int]:
    """The cell's cards: those that ran something in the trace, and as
    many more of the lowest unseen indices as make ``n``. A card that ran
    nothing is still one of the cell's, idle the whole window."""
    seen = tr.cards()
    rest = (c for c in itertools.count() if c not in seen)
    return seen + list(itertools.islice(rest, max(0, n - len(seen))))


def _card(e: dict) -> int:
    """The card an event ran on: ``args.device``, else the event's
    ``pid``, else 0."""
    args = e.get("args") or {}
    card = args.get("device", e.get("pid", 0))
    try:
        return int(card)
    except (TypeError, ValueError):
        return 0


def from_chrome(trace, mark: str = WINDOW_MARK) -> Trace:
    """A ``Trace`` of the window marked ``mark`` in a Chrome trace (a path
    or the loaded object)."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == mark
             and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise ValueError(f"{len(marks)} window marks '{mark}' in the trace")
    t0 = float(marks[0]["ts"])
    out = Trace(float(marks[0]["dur"]) / 1e6)
    for e in events:
        kind = _KINDS.get(e.get("cat"))
        if kind is None:
            continue
        a = (float(e["ts"]) - t0) / 1e6
        b = a + float(e.get("dur", 0)) / 1e6
        a, b = max(a, 0.0), min(b, out.window_s)
        if b > a:
            getattr(out, kind).append((e.get("name", "?"), a, b))
            getattr(out, _CARDS[kind]).append(_card(e))
    return out


def union(intervals) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of ``(name, start, end)`` intervals."""
    merged: List[Tuple[float, float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def covered(intervals) -> float:
    """Seconds covered by at least one interval."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, window_s: float) -> List[Tuple[float, float]]:
    """The parts of ``[0, window_s]`` that no interval covers."""
    out, t = [], 0.0
    for a, b in union(intervals):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window_s > t:
        out.append((t, window_s))
    return out


def copy_seconds(tr: Trace) -> float:
    """Device seconds of host-to-device and device-to-host copies."""
    return sum(b - a for n, a, b in tr.copies
               if "HtoD" in n or "DtoH" in n)
