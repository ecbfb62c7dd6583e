"""The per-layer readers and the breakdown on canned profiler traces of
one card and of two."""

import json
import math
from types import SimpleNamespace

import pytest

from gpubench import core
from gpubench.lib import roofline
from gpubench.lib import spans as S
from gpubench.lib import trace as T
from turbosqueeze_tpu_torch.utils.profiling import Span

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


# CANNED's events on card 0 (``args.device``), and card 1: kernels 0.2-0.7
# and 1.4-1.8 s, a copy each way (0.7-0.8 naming its card by ``pid``
# alone, 1.75-1.85) and a device-to-device copy; card 1 is busy in
# [0.2, 0.8] and [1.4, 1.85]: 1.05 s, card 0 1.1 s
TWO_CARDS = {"traceEvents": [
    {**e, "args": {"device": 0}} if e.get("cat") != "user_annotation"
    else e for e in CANNED["traceEvents"]] + [
    {"ph": "X", "cat": "kernel", "name": "gang_w", "ts": 1000 + 2e5,
     "dur": 5e5, "pid": 0, "args": {"device": 1, "stream": 7}},
    {"ph": "X", "cat": "kernel", "name": "gang_u", "ts": 1000 + 1.4e6,
     "dur": 4e5, "args": {"device": 1}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
     "ts": 1000 + 7e5, "dur": 1e5, "pid": 1, "args": {"stream": 7}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
     "ts": 1000 + 1.75e6, "dur": 1e5, "args": {"device": 1}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
     "ts": 1000 + 1.45e6, "dur": 1e5, "pid": 1},
]}

# one call on thread 100 over the window: the resolve in [0, 1], the
# packing in [1, 1.25], the assembly in [1.25, 1.7], the call's own span
# after it
SPANS = [Span("decode.call", 1, 0, 1, 100, round(-0.5e9), round(2.5e9), {}),
         Span("host.resolve", 2, 1, 1, 100, 0, round(1.0e9), {}),
         Span("host.pack", 3, 1, 1, 100, round(1.0e9), round(1.25e9), {}),
         Span("decode.assemble", 4, 1, 1, 100, round(1.25e9), round(1.7e9),
              {})]
IDLE = ("device_idle_pct.decode", "idle_resolve_pct.decode",
        "idle_stage_pct.decode", "idle_assemble_pct.decode",
        "idle_untraced_pct.decode")


@pytest.fixture
def spans(monkeypatch):
    """SPANS as the program's, on a window that starts at 0 ns."""
    monkeypatch.setattr(S, "window_start_ns", lambda setup_s: 0)
    monkeypatch.setattr(S, "program_spans", lambda: SPANS)
    return SPANS


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


def test_one_card_reads_what_it_read_before(spans):
    """Every reader, the idle time by span, the busy time and the
    breakdown on the one-card trace, to the last bit as the harness read
    them before it kept each event's card."""
    tr = T.from_chrome(CANNED)
    run = _run(trace=tr, cards=1)
    read = {n: core.load_reader(n)(run) for n in IDLE + (
        "decode_kernels_roofline", "copy_ms_per_GB.decode")}
    assert read == {
        "device_idle_pct.decode": 44.99999999999999,
        "idle_resolve_pct.decode": 10.000000000000005,
        "idle_stage_pct.decode": 4.999999999999993,
        "idle_assemble_pct.decode": 14.999999999999991,
        "idle_untraced_pct.decode": 15.000000000000002,
        "decode_kernels_roofline": 0.05414179104477613,
        "copy_ms_per_GB.decode": 150.00000000000014}
    assert S.idle_by_span(run) == {
        "host.resolve": 0.2000000000000001, "host.pack": 0.09999999999999987,
        "decode.assemble": 0.2999999999999998,
        "untraced": 0.30000000000000004}
    assert [T.covered(tr.device(c)) for c in T.cell_cards(tr, 1)] == [1.1]
    assert core.breakdown(tr, [("call 0", 0.0, 1.05),
                               ("call 1", 1.05, 2.0)]) == {
        "device_ops": [["gang_u", 0.5999999999999999], ["gang_w", 0.4],
                       ["Memcpy HtoD (Pinned -> Device)", 0.10000000000000009],
                       ["Memset (Device)", 0.10000000000000009],
                       ["Memcpy DtoH (Device -> Pinned)",
                        0.050000000000000044],
                       ["Memcpy DtoD (Device -> Device)",
                        0.050000000000000044]],
        "idle_gaps": [["call 1 (1 open)", 0.3999999999999999],
                      ["call 1 (1 open)", 0.1499999999999999],
                      ["call 0 (1 open)", 0.10000000000000009],
                      ["call 0 (1 open)", 0.1],
                      ["call 1 (1 open)", 0.09999999999999987],
                      ["call 1 (1 open)", 0.050000000000000044]]}
    # a run that does not name its cards is a one-card run
    assert {n: core.load_reader(n)(_run(trace=tr)) for n in read} == read


def test_the_trace_keeps_each_events_card():
    tr = T.from_chrome(TWO_CARDS)
    one = T.from_chrome(CANNED)
    assert tr.cards() == [0, 1] and one.cards() == [0]
    assert tr.device(0) == one.device() and tr.kernels_on(0) == one.kernels
    assert [k[0] for k in tr.kernels_on(1)] == ["gang_w", "gang_u"]
    assert T.covered(tr.kernels_on(1)) == pytest.approx(0.9)
    assert [T.covered(tr.device(c)) for c in (0, 1)] == pytest.approx(
        [1.1, 1.05])
    flat = [t for g in T.gaps(tr.device(1), tr.window_s) for t in g]
    assert flat == pytest.approx([0.0, 0.2, 0.8, 1.4, 1.85, 2.0])
    # the interval lists themselves are as before, every card's together
    assert len(tr.kernels) == 4 and len(tr.copies) == 6
    assert T.copy_seconds(tr) == pytest.approx(0.35)
    # a card the cell names that ran nothing is idle all the window
    assert T.cell_cards(tr, 4) == [0, 1, 2, 3]
    assert [T.covered(tr.device(c)) for c in T.cell_cards(tr, 3)] == \
        pytest.approx([1.1, 1.05, 0.0])
    assert T.cell_cards(T.Trace(1.0), 2) == [0, 1]


def test_the_readers_take_each_card(spans):
    """Idle shares are the mean of the cards' (card 0 45 %, card 1
    47.5 %), the roofline divides by the kernel time summed over the
    cards, and the idle time by span is each card's, summed."""
    tr = T.from_chrome(TWO_CARDS)
    run = _run(trace=tr, cards=2)
    read = {n: core.load_reader(n)(run) for n in IDLE + (
        "decode_kernels_roofline", "copy_ms_per_GB.decode")}
    assert read["device_idle_pct.decode"] == pytest.approx(46.25)
    assert read["device_idle_pct.decode"] == pytest.approx(
        (45.0 + 47.5) / 2)
    assert read["decode_kernels_roofline"] == pytest.approx(
        100 * roofline.least_seconds(1_451_000_000) / (0.8 + 0.9))
    assert read["copy_ms_per_GB.decode"] == pytest.approx(350.0)
    # card 0: resolve 0.1 + 0.1, pack 0.1, assembly 0.05 + 0.15 + 0.1,
    # untraced 0.3; card 1: resolve 0.2 + 0.2, pack 0.25, assembly 0.15,
    # untraced 0.15
    idle = S.idle_by_span(run)
    assert idle == {"host.resolve": pytest.approx(0.6),
                    "host.pack": pytest.approx(0.35),
                    "decode.assemble": pytest.approx(0.45),
                    "untraced": pytest.approx(0.45)}
    assert read["idle_resolve_pct.decode"] == pytest.approx(15.0)
    assert read["idle_stage_pct.decode"] == pytest.approx(8.75)
    assert read["idle_assemble_pct.decode"] == pytest.approx(11.25)
    assert read["idle_untraced_pct.decode"] == pytest.approx(11.25)
    assert sum(read[n] for n in IDLE[1:]) == pytest.approx(
        read["device_idle_pct.decode"], abs=1e-12)
    # the union of the cards would read busier: idle 27.5 %
    assert 100 * (1 - T.covered(tr.device()) / 2.0) == pytest.approx(27.5)


def test_a_card_that_ran_nothing_counts_as_idle(spans):
    tr = T.from_chrome(TWO_CARDS)
    run = _run(trace=tr, cards=3)
    read = {n: core.load_reader(n)(run) for n in IDLE + (
        "decode_kernels_roofline",)}
    assert read["device_idle_pct.decode"] == pytest.approx(
        (45.0 + 47.5 + 100.0) / 3)
    assert read["decode_kernels_roofline"] == pytest.approx(
        100 * roofline.least_seconds(1_451_000_000) / 1.7)
    # card 2 adds the whole window: 1.0, 0.25, 0.45 and 0.3 s
    assert S.idle_by_span(run) == {"host.resolve": pytest.approx(1.6),
                                   "host.pack": pytest.approx(0.6),
                                   "decode.assemble": pytest.approx(0.9),
                                   "untraced": pytest.approx(0.75)}
    assert sum(read[n] for n in IDLE[1:]) == pytest.approx(
        read["device_idle_pct.decode"], abs=1e-12)


def test_the_breakdown_names_each_gaps_card():
    tr = T.from_chrome(TWO_CARDS)
    spans = [("call 0", 0.0, 1.05), ("call 1", 1.05, 2.0)]
    b = core.breakdown(tr, spans, 2)
    assert b["device_ops"][0] == ["gang_u", pytest.approx(1.0)]
    assert b["idle_gaps"][:3] == [
        ["card 1: call 1 (1 open)", pytest.approx(0.6)],
        ["card 0: call 1 (1 open)", pytest.approx(0.4)],
        ["card 1: call 0 (1 open)", pytest.approx(0.2)]]
    assert len(b["idle_gaps"]) == 9
    # a card that ran nothing has one gap, the whole window
    b = core.breakdown(tr, spans, 3)
    assert b["idle_gaps"][0] == ["card 2: call 0 (1 open)",
                                 pytest.approx(2.0)]


def test_the_memory_peak_is_the_fullest_cards(monkeypatch):
    import torch

    peak = {0: 5 << 20, 1: 9 << 20, 2: 1 << 20, 3: 7 << 20}
    seen = []
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peak[d])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        seen.append)
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    setup = core.memory_peaks(4)
    core.reset_peaks(4)
    core.synchronize(4)
    assert seen == [0, 1, 2, 3, 0, 1, 2, 3]
    peak.update({0: 8 << 20, 1: 2 << 20})
    got = core.fullest(setup, core.memory_peaks(4))
    assert got == {"memory_peak_bytes": 9 << 20,
                   "memory_peak_bytes_by_card": [8 << 20, 9 << 20, 1 << 20,
                                                 7 << 20],
                   "window_peak_bytes": 8 << 20}
    assert core.fullest([3], [4]) == {"memory_peak_bytes": 4,
                                      "memory_peak_bytes_by_card": [4],
                                      "window_peak_bytes": 4}
    assert core.fullest([], [])["memory_peak_bytes"] == 0
