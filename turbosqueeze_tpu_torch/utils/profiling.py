"""Observability: wall-clock section timers with byte-throughput
accounting, and device trace capture on ``torch.profiler``; the port of
``turbosqueeze_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class Section:
    name: str
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0

    @property
    def mbps(self) -> float:
        return self.bytes / 1e6 / self.seconds if self.seconds else 0.0


@dataclass
class Profiler:
    """Accumulating section timers.

    >>> prof = Profiler()
    >>> with prof.section("decode", nbytes=len(data)):
    ...     out = decompress(data)
    >>> prof.report()
    """

    sections: Dict[str, Section] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, nbytes: int = 0) -> Iterator[Section]:
        s = self.sections.setdefault(name, Section(name))
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.seconds += time.perf_counter() - t0
            s.bytes += nbytes
            s.calls += 1

    def report(self) -> str:
        lines = []
        for s in self.sections.values():
            rate = f"{s.mbps:,.0f} MB/s" if s.bytes else ""
            lines.append(f"{s.name:<24} {s.seconds * 1e3:9.1f} ms "
                         f"x{s.calls:<4} {rate}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace a section with ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is present) and write it as a Chrome trace
    (``trace.json``) into ``log_dir``. No-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def throughput(nbytes: int, fn, *args, reps: int = 3, warmup: int = 1,
               sync=None):
    """Wall-clock throughput of ``fn(*args)`` in MB/s, and its last
    result. ``sync(result)`` waits for the device to finish (a card
    caller passes ``sync=lambda r: torch.cuda.synchronize()``); None for
    host functions."""
    for _ in range(warmup):
        r = fn(*args)
        if sync:
            sync(r)
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn(*args)
        if sync:
            sync(r)
    dt = (time.perf_counter() - t0) / reps
    return nbytes / 1e6 / dt, r
