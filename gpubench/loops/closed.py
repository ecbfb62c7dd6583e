"""A closed loop: ``callers`` threads, each making calls back to back
from the window's start until ``seconds`` have passed. The call in flight
at the deadline runs to its end and counts; the window ends when the last
one does. Mix: ``"loop": {"kind": "closed", "callers": <n>}``."""

from __future__ import annotations

import threading
import time


def run(call, seconds: float, loop: dict, record) -> float:
    """Run the loop; ``record(start, end, output, error)`` after each
    call. The window's length."""
    if set(loop) != {"kind", "callers"} or int(loop["callers"]) < 1:
        raise ValueError(f"a closed loop is {{kind, callers >= 1}}, not "
                         f"{loop}")
    t0 = time.perf_counter()

    def caller() -> None:
        while True:
            start = time.perf_counter() - t0
            if start >= seconds:
                return
            try:
                out, err = call(), None
            except Exception as e:  # noqa: BLE001 - a failed call counts
                out, err = None, e
            record(start, time.perf_counter() - t0, out, err)

    threads = [threading.Thread(target=caller)
               for _ in range(1, int(loop["callers"]))]
    for t in threads:
        t.start()
    caller()
    for t in threads:
        t.join()
    return time.perf_counter() - t0
