"""Device intervals of a traced window, read from the Chrome trace that
``torch.profiler`` exports, and the interval arithmetic the per-layer
readers share."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW_MARK = "gpubench.window"   # the record_function around the window

Interval = Tuple[str, float, float]   # (name, start s, end s)


@dataclass
class Trace:
    """Kernels, copies and memsets of one window, in seconds from the
    window's start, clipped to ``[0, window_s]``."""
    window_s: float
    kernels: List[Interval] = field(default_factory=list)
    copies: List[Interval] = field(default_factory=list)
    memsets: List[Interval] = field(default_factory=list)

    def device(self) -> List[Interval]:
        """Every interval in which the device ran an operation."""
        return self.kernels + self.copies + self.memsets


_KINDS = {"kernel": "kernels", "gpu_memcpy": "copies",
          "gpu_memset": "memsets"}


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
