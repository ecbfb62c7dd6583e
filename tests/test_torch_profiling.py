"""The port's span recorder (``turbosqueeze_tpu_torch/utils/profiling.py``):
when it records, what a span holds, ``summary()``, and ``device_trace`` on
the CPU writing a Chrome trace with the spans on its clock."""

import collections
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from turbosqueeze_tpu_torch.utils import profiling
from turbosqueeze_tpu_torch.utils.profiling import Span, device_trace


def _new(fn):
    """The spans ``fn()`` records."""
    seen = {s.id for s in profiling.spans()}
    fn()
    return [s for s in profiling.spans() if s.id not in seen]


def test_nothing_is_recorded_without_a_profiler():
    def work():
        with profiling.call("decode.call") as c:
            c.add(blocks=1)
            with profiling.span("decode.scan") as s:
                s.add(bytes=3)
        assert profiling.call("compress.call") is profiling.OFF
        assert profiling.span("host.pack") is profiling.OFF
        fn = len
        assert profiling.pooled("host.bulk_prep", fn) is fn

    assert _new(work) == []


def test_a_call_records_under_a_profiler_on_its_thread_only():
    def work():
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.call("decode.call", route="gang") as c:
                with profiling.span("decode.scan", bytes=7):
                    pass
                c.add(blocks=2)
                c.add(blocks=1)
            # another thread has no profiler session: its call is off
            got = []
            t = threading.Thread(target=lambda: got.append(
                profiling.call("compress.call")))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive() and got == [profiling.OFF]

    call, scan = sorted(_new(work), key=lambda s: s.id)
    assert (call.name, call.parent, call.call) == ("decode.call", 0, call.id)
    assert call.counts == {"route": "gang", "blocks": 3}
    assert (scan.name, scan.parent, scan.call) == ("decode.scan", call.id,
                                                   call.id)
    assert scan.counts == {"bytes": 7}
    assert call.start_ns <= scan.start_ns <= scan.end_ns <= call.end_ns
    assert call.tid == scan.tid == threading.get_native_id()
    # once the session ends, nothing records
    assert profiling.call("decode.call") is profiling.OFF


def test_pooled_work_records_under_the_callers_span():
    def work():
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.call("decode.call"):
                with profiling.span("host.resolve"):
                    fn = profiling.pooled("host.bulk_prep", lambda x: 2 * x,
                                          nbytes=lambda x: x)
                    with ThreadPoolExecutor(2) as pool:
                        assert list(pool.map(fn, [1, 2, 3])) == [2, 4, 6]

    got = _new(work)
    call = next(s for s in got if s.name == "decode.call")
    resolve = next(s for s in got if s.name == "host.resolve")
    preps = [s for s in got if s.name == "host.bulk_prep"]
    assert sorted(s.counts["bytes"] for s in preps) == [1, 2, 3]
    assert all(0 <= s.counts["cpu_ns"] <= s.end_ns - s.start_ns
               for s in preps)
    assert all(s.parent == resolve.id and s.call == call.id for s in preps)
    assert all(s.tid != call.tid for s in preps)


def test_the_span_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.call("decode.call"):
            for k in range(5):
                with profiling.span(f"s{k}"):
                    pass
    assert [s.name for s in profiling.spans()] == ["s3", "s4", "decode.call"]


def test_profiler_sections():
    """``summary()``, which replaced the section timers, on a hand-made
    tree: a call of 100 ns with overlapping children (as pool work
    overlaps) and a grandchild. Each span's self time is its duration
    less the union of its children's intervals within it."""
    tree = [Span("a", 1, 0, 1, 10, 0, 100, {}),
            Span("b", 2, 1, 1, 10, 10, 40, {"bytes": 5}),
            Span("c", 3, 1, 1, 11, 30, 60, {"bytes": 6}),
            Span("d", 4, 2, 1, 10, 20, 25, {}),
            Span("c", 5, 1, 1, 12, 90, 120, {"bytes": 1})]
    got = profiling.summary(tree)
    assert got["a"]["count"] == 1
    assert got["a"]["total_s"] == pytest.approx(100e-9)
    # children cover [10, 60) and [90, 100) of a
    assert got["a"]["self_s"] == pytest.approx(40e-9)
    assert got["b"]["self_s"] == pytest.approx(25e-9)
    assert got["c"] == {"count": 2, "total_s": pytest.approx(60e-9),
                        "self_s": pytest.approx(60e-9), "bytes": 7}
    assert got["d"]["self_s"] == pytest.approx(5e-9)
    assert got["b"]["bytes"] == 5 and got["a"]["bytes"] == 0


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)):
        torch.arange(1 << 12).sum()
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("sum" in n for n in names), sorted(names)[:20]
    with device_trace(None):  # no-op: nothing written, nothing traced
        pass
    assert sorted(p.name for p in log_dir.iterdir()) == ["trace.json"]


def test_device_trace_puts_the_spans_on_the_trace_clock(tmp_path,
                                                        monkeypatch):
    """Each span becomes a ``tsq_span`` event on its thread's row, pool
    threads included; a span opened beside a ``record_function`` lands
    within 1 ms of it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with device_trace(str(tmp_path)):
        with profiling.call("decode.call"):
            for _ in range(3):
                with record_function("beside"):
                    with profiling.span("probe"):
                        torch.arange(1 << 16).sum()
            fn = profiling.pooled("host.bulk_prep", lambda x: x)
            with ThreadPoolExecutor(1) as pool:
                list(pool.map(fn, [1]))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    beside = sorted((e for e in events if e.get("name") == "beside"
                     and e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    mine = [e for e in events if e.get("cat") == "tsq_span"]
    probes = sorted((e for e in mine if e["name"] == "probe"),
                    key=lambda e: e["ts"])
    assert len(beside) == len(probes) == 3
    for b, p in zip(beside, probes):
        assert abs(p["ts"] - b["ts"]) < 1000
        assert abs(p["ts"] + p["dur"] - b["ts"] - b["dur"]) < 1000
    call = next(e for e in mine if e["name"] == "decode.call")
    prep = next(e for e in mine if e["name"] == "host.bulk_prep")
    assert call["tid"] == threading.get_native_id() != prep["tid"]
    assert prep["args"]["call"] == call["args"]["id"]
    assert {e["ph"] for e in mine} == {"X"}
