"""The per-layer readers and the breakdown on a canned profiler trace."""

import json
import math
from types import SimpleNamespace

import pytest

from gpubench import core
from gpubench.lib import roofline
from gpubench.lib import trace as T

# a window of 2 s at ts 1000 us; kernels 0.1-0.5 s and 0.3-0.9 s (one
# overlap), a copy each way, a memset, a device-to-device copy, and events
# outside the window or of other categories
CANNED = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": T.WINDOW_MARK,
     "ts": 1000.0, "dur": 2e6},
    {"ph": "X", "cat": "kernel", "name": "gang_w", "ts": 1000 + 1e5,
     "dur": 4e5},
    {"ph": "X", "cat": "kernel", "name": "gang_u", "ts": 1000 + 3e5,
     "dur": 6e5},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
     "ts": 1000 + 1.0e6, "dur": 1e5},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
     "ts": 1000 + 1.2e6, "dur": 5e4},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
     "ts": 1000 + 1.3e6, "dur": 5e4},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
     "ts": 1000 + 1.5e6, "dur": 1e5},
    {"ph": "X", "cat": "kernel", "name": "before", "ts": 0, "dur": 500},
    {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 2000, "dur": 9},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3000},
]}


def _run(**kw):
    base = dict(cell="c", seconds=2.0, setup_s=12.5,
                window_s=2.0, cpu_s=3.0, user_bytes=10**9,
                roofline_bytes=1_451_000_000, trace=None,
                window_peak_bytes=0, power_limit="700.00 W")
    base.update(kw)
    return SimpleNamespace(**base)


def test_trace_reads_the_window(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(CANNED))
    tr = T.from_chrome(str(p))
    assert tr.window_s == pytest.approx(2.0)
    assert [k[0] for k in tr.kernels] == ["gang_w", "gang_u"]
    assert len(tr.copies) == 3 and len(tr.memsets) == 1
    assert T.covered(tr.kernels) == pytest.approx(0.8)
    assert T.covered(tr.device()) == pytest.approx(1.1)
    assert T.copy_seconds(tr) == pytest.approx(0.15)
    flat = [t for g in T.gaps(tr.device(), tr.window_s) for t in g]
    assert flat == pytest.approx([0.0, 0.1, 0.9, 1.0, 1.1, 1.2, 1.25, 1.3,
                                  1.35, 1.5, 1.6, 2.0])
    with pytest.raises(ValueError):
        T.from_chrome({"traceEvents": CANNED["traceEvents"][1:]})


def test_readers_on_the_canned_trace():
    tr = T.from_chrome(CANNED)
    run = _run(trace=tr)
    read = {n: core.load_reader(n) for n in (
        "device_idle_pct.decode", "decode_kernels_roofline",
        "copy_ms_per_GB.decode", "decode_MBps", "host_cpu_s_per_GB",
        "setup_s")}
    assert read["device_idle_pct.decode"](run) == pytest.approx(45.0)
    assert read["decode_kernels_roofline"](run) == pytest.approx(
        100 * roofline.least_seconds(1_451_000_000) / 0.8)
    assert read["copy_ms_per_GB.decode"](run) == pytest.approx(150.0)
    assert read["decode_MBps"](run) == pytest.approx(500.0)
    assert read["host_cpu_s_per_GB"](run) == pytest.approx(3.0)
    assert read["setup_s"](run) == 12.5


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing():
    spec = core.load_spec()
    empty = _run(user_bytes=0, roofline_bytes=0, window_s=0.0)
    for m in spec["end_to_end"] + spec["per_layer"]:
        value = core.load_reader(m["name"])(empty)
        assert value is None or m["name"] == "setup_s", m["name"]
    assert core.load_reader("peak_device_GiB.compress")(
        _run(window_peak_bytes=5 << 30)) == 5.0


def test_breakdown_names_gaps_by_the_open_span():
    tr = T.from_chrome(CANNED)
    spans = [("call 0", 0.0, 1.05), ("call 1", 1.05, 2.0)]
    b = core.breakdown(tr, spans)
    assert b["device_ops"][0] == ["gang_u", pytest.approx(0.6)]
    assert len(b["device_ops"]) == 6
    assert b["idle_gaps"][0] == ["call 1 (1 open)", pytest.approx(0.4)]
    assert b["idle_gaps"][1] == ["call 1 (1 open)", pytest.approx(0.15)]
    assert b["idle_gaps"][2][0] == "call 0 (1 open)"
    assert len(b["idle_gaps"]) == 6
    assert all(math.isfinite(s) for _, s in b["idle_gaps"])
    assert core.breakdown(tr, [])["idle_gaps"][0][0] == "no call open"
