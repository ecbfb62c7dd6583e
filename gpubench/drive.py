"""The one general traffic generator. A traffic mix is a JSON file of
``gpubench/traffic/`` with exactly these keys, all read here:

- ``input``: the steps that make the calls' argument in set-up, from the
  configuration's bytes, each ``{"entry": ..., "args": {...}}`` applied to
  what the step before made (none: the bytes themselves);
- ``entry``: the program's entry point the window drives, a dotted name
  under ``turbosqueeze_tpu_torch`` (``runtime.api.decompress``), and
  ``args``, its keyword arguments;
- ``loop``: the arrival process, ``{"kind": <name>, ...}``: the module
  ``gpubench/loops/<name>.py``, found by name, whose ``run`` reads the
  rest;
- ``counts``: ``input`` or ``output``, the bytes of user data a call moves;
- ``roofline``: the byte count of ``lib/roofline.py`` a call needs
  (``decode`` or ``compress``);
- ``check``: the comparison after the window, the module
  ``gpubench/checks/<name>.py``, found by name.

An argument written ``"$key"`` is the configuration's ``key``. A mix with
another key, or without one of these, is refused. Times are seconds from
the window's start.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from .lib import roofline

PACKAGE = "turbosqueeze_tpu_torch"
MIX_KEYS = {"input", "entry", "args", "loop", "counts", "roofline", "check"}
# at most this many bytes of outputs are kept for the check; past it a
# uniform sample of the calls, drawn from the seed
KEEP_BYTES = 16 * 10**9


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nbytes(x) -> int:
    """Bytes of a call's argument or answer: bytes, an array or a
    tensor."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return len(x)
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    return int(x.numel() * x.element_size())


def load_part(kind: str, name: str, bench_dir: Path):
    """The module ``<bench_dir>/<kind>/<name>.py``."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Call:
    """One call: its index, start and end, the bytes it took and
    returned, and whether it returned."""
    index: int
    start: float
    end: float
    in_bytes: int
    out_bytes: int
    ok: bool


class _Keep:
    """A uniform sample of the outputs of a run of calls, at most ``cap``
    of them (reservoir sampling from ``rng``)."""

    def __init__(self, cap: int, rng):
        self.cap, self.rng, self.items = max(1, cap), rng, []

    def add(self, i: int, out) -> None:
        if len(self.items) < self.cap:
            self.items.append((i, out))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.cap:
                self.items[j] = (i, out)


class Traffic:
    """One traffic mix over one configuration's bytes."""

    def __init__(self, mix: dict, cfg: dict, data: bytes, seed: int,
                 bench_dir: Path = Path(__file__).resolve().parent):
        if set(mix) != MIX_KEYS:
            raise ValueError(f"a traffic mix has the keys {sorted(MIX_KEYS)}"
                             f", not {sorted(mix)}")
        if mix["counts"] not in ("input", "output"):
            raise ValueError(f"counts {mix['counts']!r}")
        self.mix, self.cfg, self.data, self.seed = mix, cfg, data, seed
        self.loop = load_part("loops", mix["loop"]["kind"], bench_dir)
        self.checker = load_part("checks", mix["check"], bench_dir)
        self.count = roofline.BYTES[mix["roofline"]]
        self.module, self.attr = self._resolve(mix["entry"])
        self.kwargs = self._args(mix["args"])
        self.rng = np.random.default_rng([seed, 1])
        self.calls: List[Call] = []
        self.keep = None
        self.arg = data

    @staticmethod
    def _resolve(dotted: str):
        mod, _, attr = dotted.rpartition(".")
        return importlib.import_module(f"{PACKAGE}.{mod}"), attr

    def _args(self, args: dict) -> dict:
        return {k: self.cfg[v[1:]] if isinstance(v, str) and v[:1] == "$"
                else v for k, v in args.items()}

    @contextmanager
    def wrapped(self, wrap):
        """The entry point replaced by ``wrap(original, cfg)`` (controls,
        faults, and the tests' native core), or left as it is."""
        original = getattr(self.module, self.attr)
        if wrap is not None:
            setattr(self.module, self.attr, wrap(original, self.cfg))
        try:
            yield
        finally:
            setattr(self.module, self.attr, original)

    def setup(self) -> None:
        for step in self.mix["input"]:
            t = time.perf_counter()
            mod, attr = self._resolve(step["entry"])
            self.arg = getattr(mod, attr)(self.arg, **self._args(
                step["args"]))
            log(f"input step {step['entry']}: {nbytes(self.arg)} bytes in "
                f"{time.perf_counter() - t:.3f} s, "
                f"{nbytes(self.arg) / len(self.data):.6f} of the input")

    def call(self):
        return getattr(self.module, self.attr)(self.arg, **self.kwargs)

    def warm(self) -> None:
        t = time.perf_counter()
        out = self.call()
        log(f"warm-up call: {time.perf_counter() - t:.3f} s, "
            f"{nbytes(out)} bytes")

    def window(self, seconds: float) -> float:
        """The mix's loop over ``seconds``; the window's length."""
        in_bytes = nbytes(self.arg)
        out_guess = len(self.data)
        self.keep = _Keep(KEEP_BYTES // max(out_guess, in_bytes, 1),
                          self.rng)
        lock = threading.Lock()

        def record(start, end, out, err):
            with lock:
                i = len(self.calls)
                if err is not None and self.failed < 3:
                    log(f"call {i} failed: {err!r}")
                self.calls.append(Call(i, start, end, in_bytes,
                                       0 if err else nbytes(out),
                                       err is None))
                self.keep.add(i, out)

        window_s = self.loop.run(self.call, seconds, self.mix["loop"],
                                 record)
        log("call seconds: " + " ".join(f"{c.end - c.start:.3f}"
                                        for c in self.calls))
        return window_s

    # -- what the window did ----------------------------------------------

    @property
    def attempted(self) -> int:
        return len(self.calls)

    @property
    def failed(self) -> int:
        return sum(not c.ok for c in self.calls)

    def user_bytes(self) -> int:
        out = self.mix["counts"] == "output"
        return sum(c.out_bytes if out else c.in_bytes for c in self.calls
                   if c.ok)

    def roofline_bytes(self) -> int:
        return sum(self.count(c.in_bytes, c.out_bytes) for c in self.calls
                   if c.ok)

    def spans(self):
        return [(f"call {c.index}", c.start, c.end) for c in self.calls]

    def check(self, workers: int) -> dict:
        kept = self.keep.items if self.keep else []
        log(f"checking {len(kept)} of {len(self.calls)} calls' outputs")
        return self.checker.check(kept, self.data, self.cfg, self.seed,
                                  workers)
