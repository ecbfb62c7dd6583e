"""Observability: spans of the port's calls, their summary by name, and
``device_trace``, which writes them into a ``torch.profiler`` Chrome trace.

A span records its name, its own id, the id of the span that caused it
(0 for none), the id of the call it belongs to, the thread's native id,
its start and end on ``time.perf_counter_ns``'s clock, and a few counts
(bytes, blocks, groups, declined, overflowed; a call's route and a
window's; pool work's thread CPU time, ``cpu_ns``).

Spans are recorded only while a ``torch.profiler`` session collects on the
thread that calls a public entry (``pipeline.decompress``,
``decompress_to_file``, ``decompress_to_words``, ``compress``,
``tsqx.decompress``): the entry checks once, at its start
(``call``). Otherwise every span is the shared no-op ``OFF``, one check of
the thread's open span. Work handed to a thread pool records under the
caller's span through ``pooled``, since a pool thread inherits nothing.
Spans are kept in memory, the newest ``MAX_SPANS``, and read back by
``spans()``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

# the most spans kept; the oldest go first
MAX_SPANS = 1 << 18
# the record_function that puts the spans on a Chrome trace's clock
ANCHOR = "tsq.anchor"


class Span(NamedTuple):
    name: str
    id: int
    parent: int
    call: int
    tid: int
    start_ns: int
    end_ns: int
    counts: dict


_ids = itertools.count(1)
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_tls = threading.local()


class _Open:
    """A span being recorded: the innermost open span of its thread from
    ``__enter__`` to ``__exit__``; ``add`` adds to its counts, ``set``
    replaces them."""

    __slots__ = ("name", "id", "parent", "call", "counts", "start", "prev")

    def __init__(self, name: str, parent: int, call: Optional[int],
                 counts: dict):
        self.name, self.id, self.parent = name, next(_ids), parent
        self.call = self.id if call is None else call
        self.counts = counts

    def add(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def set(self, **counts) -> None:
        self.counts.update(counts)

    def __enter__(self):
        self.prev = getattr(_tls, "span", None)
        _tls.span = self
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _tls.span = self.prev
        _spans.append(Span(self.name, self.id, self.parent, self.call,
                           threading.get_native_id(), self.start, end,
                           self.counts))
        return False


class _Off:
    """The span of a call that records nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **counts) -> None:
        pass

    def set(self, **counts) -> None:
        pass


OFF = _Off()


def call(name: str, **counts):
    """The span of one call of a public entry, under the thread's open span
    if any: recorded only while a ``torch.profiler`` session collects on
    this thread, else ``OFF``. Its spans share its id as their call id."""
    if not torch.autograd._profiler_enabled():
        return OFF
    parent = getattr(_tls, "span", None)
    return _Open(name, parent.id if parent else 0, None, counts)


def span(name: str, **counts):
    """A span under the innermost span open on this thread; ``OFF`` when
    none is (no call records)."""
    parent = getattr(_tls, "span", None)
    if parent is None:
        return OFF
    return _Open(name, parent.id, parent.call, counts)


def pooled(name: str, fn, nbytes=None):
    """``fn`` for a thread pool's ``map``: each call of it recorded as a
    span ``name`` under the span open on the calling thread now, with
    ``nbytes(arg)`` as its bytes and the pool thread's CPU time as
    ``cpu_ns`` (a pool with more threads than cores waits, so its spans'
    durations overstate the CPU); ``fn`` itself when nothing records."""
    parent = getattr(_tls, "span", None)
    if parent is None:
        return fn

    def run(arg):
        counts = {"bytes": nbytes(arg)} if nbytes else {}
        with _Open(name, parent.id, parent.call, counts) as sp:
            cpu = time.thread_time_ns()
            out = fn(arg)
            sp.add(cpu_ns=time.thread_time_ns() - cpu)
            return out

    return run


def spans() -> List[Span]:
    """The recorded spans, oldest first."""
    return list(_spans)


def _covered(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi)`` that the (start, end) intervals cover."""
    total, t = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, t), min(b, hi)
        if b > a:
            total += b - a
            t = b
    return total


def summary(recorded=None) -> Dict[str, dict]:
    """By span name: ``count``, ``total_s``, ``self_s`` (each span's
    duration less the part of it its children cover) and ``bytes``, over
    ``recorded`` (default: every recorded span)."""
    recorded = spans() if recorded is None else list(recorded)
    kids = collections.defaultdict(list)
    for s in recorded:
        kids[s.parent].append((s.start_ns, s.end_ns))
    out: Dict[str, dict] = {}
    for s in recorded:
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0, "bytes": 0})
        dur = s.end_ns - s.start_ns
        row["count"] += 1
        row["total_s"] += dur / 1e9
        row["self_s"] += (dur - _covered(kids.get(s.id, ()), s.start_ns,
                                         s.end_ns)) / 1e9
        row["bytes"] += s.counts.get("bytes", 0)
    return out


def _chrome_events(recorded, anchor_ts_us: float, anchor_ns: int,
                   pid) -> list:
    """The spans as Chrome ``X`` events of category ``tsq_span``, each on
    its thread's row, ``anchor_ns`` on the trace's ``anchor_ts_us``."""
    return [{"ph": "X", "cat": "tsq_span", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": anchor_ts_us + (s.start_ns - anchor_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "call": s.call,
                      **s.counts}} for s in recorded]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace a section with ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is present) and write it as a Chrome trace
    (``trace.json``) into ``log_dir``, with the spans the section recorded
    beside the kernels and copies. No-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with record_function(ANCHOR):  # warm: the first one opens slowly
        pass
    first = next(_ids)
    with profile(activities=activities) as prof:
        with record_function(ANCHOR):
            anchor_ns = time.perf_counter_ns()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = Path(log_dir) / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    anchor = next(e for e in trace["traceEvents"] if e.get("name") == ANCHOR
                  and e.get("cat") == "user_annotation")
    trace["traceEvents"] += _chrome_events(
        [s for s in spans() if s.id > first], float(anchor["ts"]), anchor_ns,
        anchor.get("pid", os.getpid()))
    path.write_text(json.dumps(trace))
