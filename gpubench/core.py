"""One run of one cell: find the cell's files by name, set up, measure one
window, check what the window returned, read the metrics.

Everything a cell needs is found from its name in ``BENCHMARK.json``:

- ``gpubench/cells/<cell>.json``: the cell's configuration and traffic
  mix (they must agree with ``BENCHMARK.json``);
- ``gpubench/configs/<config>.json``: the input's generator
  (``gpubench/gen/<generator>.py``) and its arguments, the level, ext;
- ``gpubench/traffic/<mix>.json``: the mix that ``drive.py`` runs, which
  names its loop (``gpubench/loops/``) and its check
  (``gpubench/checks/``);
- ``gpubench/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  returning a number or None where it finds nothing to read.

The end-to-end metrics of a cell are those of ``end_to_end`` whose
``workloads`` list it, or that have none; its per-layer metrics are those
of ``per_layer`` whose ``workloads`` list it, or that have none and move
one of its end-to-end metrics.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

from . import drive
from .lib import trace as T

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "turbosqueeze_tpu")
CHECK_WORKERS = 8
log = drive.log


class NoCard(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


class ForbiddenModule(RuntimeError):
    """A module of the JAX stack or the JAX package was loaded."""


# -- the cell's files ------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / kind / f"{name}.json").read_text())


def find_cell(spec: dict, name: str, bench_dir: Path = BENCH_DIR):
    """(workload entry, cell file, configuration, traffic mix) of a cell."""
    work = [w for w in spec["workloads"] if w["name"] == name]
    if len(work) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = work[0]
    cell = read_json("cells", name, bench_dir)
    if set(cell) != {"config", "traffic"}:
        raise ValueError(f"cells/{name}.json has the keys config and "
                         f"traffic, not {sorted(cell)}")
    for key in ("config", "traffic"):
        if cell[key] != work[key]:
            raise ValueError(f"cells/{name}.json names {key} {cell[key]!r}, "
                             f"BENCHMARK.json {work[key]!r}")
    return (work, cell, read_json("configs", work["config"], bench_dir),
            read_json("traffic", work["traffic"], bench_dir))


def metrics_for(spec: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` (``end_to_end`` or ``per_layer``)
    that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_generator(name: str):
    return importlib.import_module(f"{__package__}.gen.{name}").generate


# -- the process and the card ----------------------------------------------

def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def visible_cards(n: int, count: int, env):
    """The ``CUDA_VISIBLE_DEVICES`` that leaves exactly ``n`` cards
    visible, where ``count`` are visible under ``env`` (the variable as it
    is, None where it is unset): None where exactly ``n`` are, the first
    ``n`` of them where more are; ``NoCard`` where fewer are."""
    if count == 0:
        raise NoCard("no CUDA device: this benchmark runs on the card only")
    if count < n:
        raise NoCard(f"{count} CUDA devices, the cell needs {n}")
    if count == n:
        return None
    if env is None:
        return ",".join(str(i) for i in range(n))
    return ",".join(e.strip() for e in env.split(",")[:n])


def visible_count() -> int:
    """The CUDA devices this process sees, counted through NVML where
    torch can, which leaves CUDA uninitialised, so that
    ``CUDA_VISIBLE_DEVICES`` still holds when it is set after."""
    import torch

    if not torch.backends.cuda.is_built():
        return 0
    nvml = getattr(torch.cuda, "_device_count_nvml", lambda: -1)()
    return nvml if nvml >= 0 else torch.cuda.device_count()


def uuid_key(uuid) -> str:
    """A card's UUID as torch and ``nvidia-smi`` both give it."""
    u = str(uuid).strip().lower()
    return u[4:] if u.startswith("gpu-") else u


def power_limits() -> dict:
    """Every card's power limit as ``nvidia-smi`` gives it, by
    ``uuid_key``; empty where it cannot be read."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        rows = [line.split(",", 1) for line in r.stdout.splitlines()
                if "," in line]
    except (OSError, subprocess.TimeoutExpired):
        rows = []
    return {uuid_key(u): p.strip() for u, p in rows}


def card(chips: int) -> dict:
    """Exactly the cell's ``chips`` cards made visible, before CUDA
    starts; their kind, number and power limit. ``NoCard`` where there
    are fewer, or where they are not all of one kind."""
    count = visible_count()
    pinned = visible_cards(chips, count,
                           os.environ.get("CUDA_VISIBLE_DEVICES"))
    if pinned is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = pinned
        log(f"CUDA_VISIBLE_DEVICES={pinned}: the first {chips} of "
            f"{count} cards")
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark runs on the card only")
    n = torch.cuda.device_count()
    if n != chips:
        raise NoCard(f"{n} CUDA devices visible, the cell needs exactly "
                     f"{chips}")
    by_uuid = power_limits()
    names = [torch.cuda.get_device_name(d) for d in range(n)]
    limits = [by_uuid.get(uuid_key(getattr(
        torch.cuda.get_device_properties(d), "uuid", "")), "?")
        for d in range(n)]
    for d in range(n):
        log(f"card {d}: {names[d]}; power limit: {limits[d]}")
    if len(set(names)) != 1:
        raise NoCard(f"the cell's cards are not of one kind: {names}")
    return {"kind": names[0], "count": n,
            "power_limit": ", ".join(sorted(set(limits)))}


def synchronize(n: int) -> None:
    """Wait for each of the first ``n`` cards."""
    import torch

    for d in range(n):
        torch.cuda.synchronize(d)


def reset_peaks(n: int) -> None:
    import torch

    for d in range(n):
        torch.cuda.reset_peak_memory_stats(d)


def memory_peaks(n: int) -> list:
    """Each of the first ``n`` cards' peak of allocated bytes since its
    last reset."""
    import torch

    return [torch.cuda.max_memory_allocated(d) for d in range(n)]


def fullest(setup_peaks, window_peaks) -> dict:
    """The peaks of a run's cards: each card's over set-up and window, the
    fullest card's, and the fullest card's in the window alone."""
    by_card = [max(a, b) for a, b in zip(setup_peaks, window_peaks)]
    return {"memory_peak_bytes": max(by_card, default=0),
            "memory_peak_bytes_by_card": by_card,
            "window_peak_bytes": max(window_peaks, default=0)}


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- one run ----------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             root: Path = ROOT, bench_dir: Path = BENCH_DIR,
             on_card: bool = True, overrides: dict = None,
             wrap=None) -> dict:
    """One run of cell ``name``: the result's dict. ``wrap`` replaces the
    entry point the traffic mix drives by ``wrap(original, cfg)`` from the
    warm-up on (controls, faults, and the tests' native core).
    ``on_card`` False skips the look for a card and every CUDA call
    (tests, with ``wrap``); ``overrides`` merges into the configuration
    and the traffic mix (tests, at a tiny size)."""
    spec = load_spec(root)
    work, cell, cfg, mix = find_cell(spec, name, bench_dir)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    seed = seed % (1 << 64)

    import torch

    info = (card(work["chips"]) if on_card else
            {"kind": "cpu", "count": 0, "power_limit": "-"})
    n_cards = info["count"]
    log(f"card: {info['kind']}; devices: {info['count']}; power limit: "
        f"{info['power_limit']}")
    log(f"cell {name}: config {work['config']}, traffic {work['traffic']}, "
        f"seed {seed}, {seconds} s, trace {int(traced)}")

    t = time.perf_counter()
    data = load_generator(cfg["generator"])(seed,
                                            **cfg.get("generator_args", {}))
    log(f"input: {len(data)} bytes in {time.perf_counter() - t:.3f} s")
    op = drive.Traffic(mix, cfg, data, seed, bench_dir)
    op.setup()

    with op.wrapped(wrap):
        op.warm()
        synchronize(n_cards)
        setup_peaks = memory_peaks(n_cards)
        reset_peaks(n_cards)
        gc.collect()
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if on_card else [])
            prof = profile(activities=acts)
            prof.start()
        setup_s = process_age_s()
        cpu0 = cpu_seconds()
        if prof is not None:
            with torch.profiler.record_function(T.WINDOW_MARK):
                window_s = op.window(seconds)
        else:
            window_s = op.window(seconds)
        cpu_s = cpu_seconds() - cpu0
        synchronize(n_cards)
    log(f"set-up {setup_s:.3f} s; window {window_s:.3f} s, "
        f"{op.attempted} calls, {op.failed} failed")
    peaks = fullest(setup_peaks, memory_peaks(n_cards))

    bad = forbidden_loaded()
    if bad:
        raise ForbiddenModule(f"loaded in this process: {', '.join(bad)}")

    tr = None
    if prof is not None:
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = T.from_chrome(path)
        finally:
            os.unlink(path)
        prof = None
    op.arg = None
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    found = op.check(CHECK_WORKERS)
    log(f"check: {time.perf_counter() - t:.3f} s (outside set-up and the "
        "window)")
    checks = {k: {"value": v, "limit": 0} for k, v in found.items()}
    correct = op.failed == 0 and all(c["value"] <= c["limit"]
                                     for c in checks.values())

    run = SimpleNamespace(
        cell=name, seconds=seconds, setup_s=setup_s, window_s=window_s,
        cpu_s=cpu_s, user_bytes=op.user_bytes(),
        roofline_bytes=op.roofline_bytes(), trace=tr,
        window_peak_bytes=peaks["window_peak_bytes"], cards=work["chips"],
        power_limit=info["power_limit"])
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, name, kind):
        v = load_reader(m["name"], bench_dir)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu", "kind": info["kind"],
              "count": work["chips"] if on_card else 0,
              "memory_peak_bytes": peaks["memory_peak_bytes"],
              "memory_peak_bytes_by_card":
                  peaks["memory_peak_bytes_by_card"]}
    result = {"correct": correct, "attempted": op.attempted,
              "failed": op.failed, "metrics": metrics, "device": device}
    if tr is not None:
        busy = [T.covered(tr.device(c))
                for c in T.cell_cards(tr, work["chips"])]
        device["busy_s"] = sum(busy) / len(busy)
        device["busy_s_by_card"] = busy
        device["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr, op.spans(), work["chips"])
    for k, v in metrics.items():
        log(f"metric {k}: {v['value']} {v['unit']}")
    result["checks"] = checks
    return result


def breakdown(tr: T.Trace, spans, cards: int = 1) -> dict:
    """The ten device operations that took most time, by name, and the
    ten longest idle gaps of the cell's ``cards`` cards, each named by the
    host span open at its middle (the earliest, where several are), and
    by its card where there are several."""
    by_name = defaultdict(float)
    for n, a, b in tr.device():
        by_name[n] += b - a
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    each = T.cell_cards(tr, cards)
    gaps = sorted([(a, b, c) for c in each
                   for a, b in T.gaps(tr.device(c), tr.window_s)],
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b, c in gaps:
        mid = (a + b) / 2
        open_ = [s for s in spans if s[1] <= mid < s[2]]
        label = (f"{open_[0][0]} ({len(open_)} open)" if open_
                 else "no call open")
        if len(each) > 1:
            label = f"card {c}: {label}"
        named.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
