"""The port's observability utilities (``turbosqueeze_tpu_torch/utils/
profiling.py``): the cases of ``tests/test_profiling.py``, and
``device_trace`` on the CPU writing a Chrome trace."""

import json
import time

import torch

from turbosqueeze_tpu_torch.utils.profiling import (Profiler, device_trace,
                                                    throughput)


def test_profiler_sections():
    prof = Profiler()
    with prof.section("work", nbytes=1_000_000):
        time.sleep(0.01)
    with prof.section("work", nbytes=1_000_000):
        time.sleep(0.01)
    s = prof.sections["work"]
    assert s.calls == 2 and s.bytes == 2_000_000
    assert s.seconds >= 0.02
    assert "work" in prof.report() and "MB/s" in prof.report()


def test_throughput():
    rate, result = throughput(10_000_000, lambda: sum(range(1000)))
    assert result == sum(range(1000))
    assert rate > 0
    synced = []
    rate, result = throughput(1_000, lambda x: x + 1, 41, reps=2, warmup=3,
                              sync=synced.append)
    assert result == 42 and synced == [42] * 5 and rate > 0


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
