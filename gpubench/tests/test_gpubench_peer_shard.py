"""The reader of the idle a card spends while the calling thread works on
another card's shard (``idle_peer_shard_pct.decode``), on hand-placed
spans and device intervals, and the four-card decode cell among the
benchmark's cells."""

import json
from types import SimpleNamespace

import pytest

from gpubench import core
from gpubench.lib import spans as S
from gpubench.lib import trace as T
from turbosqueeze_tpu_torch.utils.profiling import Span

from .test_gpubench_spec import REPO, _keeps_to_the_rules, _with_cells

PEER = "idle_peer_shard_pct.decode"
CELL = "tsqb-text-l0-4card.decode"
s = round(1e9)

# one call on thread 100 over a 10 s window: card 0's shard in [0, 2]
# (its resolve in [0, 1.5], with a pool span on thread 200), cards 1-3's
# in [2, 4], [4, 5] and [5, 6]; the assembly in [6, 9], waiting on card
# 1's download in [6, 6.5]; the call's own span in [9, 10]
SPANS = [
    Span("decode.call", 1, 0, 1, 100, -s, 10 * s, {"shards": 4}),
    Span("decode.window", 2, 1, 1, 100, 0, 2 * s, {"blocks": 2, "card": 0}),
    Span("host.resolve", 3, 2, 1, 100, 0, round(1.5e9), {}),
    Span("host.bulk_prep", 9, 3, 1, 200, 0, round(1.5e9), {"cpu_ns": 1}),
    Span("decode.window", 4, 1, 1, 100, 2 * s, 4 * s, {"card": 1}),
    Span("decode.window", 5, 1, 1, 100, 4 * s, 5 * s, {"card": 2}),
    Span("decode.window", 6, 1, 1, 100, 5 * s, 6 * s, {"card": 3}),
    Span("decode.assemble", 7, 1, 1, 100, 6 * s, 9 * s, {}),
    Span("decode.drain", 8, 7, 1, 100, 6 * s, round(6.5e9), {"card": 1})]

# each card's one busy interval
BUSY = [(1.5, 3.0), (4.0, 6.5), (5.0, 7.0), (6.0, 8.0)]


def _run(spans, busy, monkeypatch):
    monkeypatch.setattr(S, "window_start_ns", lambda setup_s: 0)
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    tr = T.Trace(10.0, kernels=[("k", a, b) for a, b in busy],
                 kernel_cards=list(range(len(busy))))
    return SimpleNamespace(setup_s=12.0, trace=tr, window_s=10.0,
                           cards=len(busy))


def test_four_cards_on_hand_placed_spans(monkeypatch):
    """Card 0 idles through cards 1-3's shards ([3, 6]) and card 1's wait
    ([6, 6.5]): 3.5 s; card 1 through card 0's shard: 2 s; card 2 through
    cards 0-1's: 4 s; card 3 through cards 0-2's: 5 s. The assembly and
    the call's own time name no card: 14.5 s of 40."""
    run = _run(SPANS, BUSY, monkeypatch)
    read = core.load_reader(PEER)
    assert read(run) == pytest.approx(100 * 14.5 / 40)
    # a view across the shares by span: at most the idle share, and those
    # shares still sum to it
    idle = core.load_reader("device_idle_pct.decode")(run)
    assert idle == pytest.approx(100 * (40 - 1.5 - 2.5 - 2 - 2) / 40)
    assert read(run) < idle
    assert 100 * sum(S.idle_by_span(run).values()) / 40 == pytest.approx(
        idle, abs=1e-9)


def test_one_card_reads_zero(monkeypatch):
    one = [sp._replace(counts={**sp.counts, "card": 0})
           if "card" in sp.counts else sp for sp in SPANS]
    assert core.load_reader(PEER)(_run(one, BUSY[:1], monkeypatch)) == 0.0


def test_nothing_to_read_reads_none(monkeypatch):
    read = core.load_reader(PEER)
    assert read(_run([], BUSY, monkeypatch)) is None
    # a program that names no card (spans without the count)
    bare = [sp._replace(counts={k: v for k, v in sp.counts.items()
                                if k != "card"}) for sp in SPANS]
    assert read(_run(bare, BUSY, monkeypatch)) is None
    assert read(SimpleNamespace(trace=None, setup_s=0.0, cards=4)) is None
    run = _run(SPANS, BUSY, monkeypatch)
    monkeypatch.setattr(S, "program_spans", lambda: None)
    assert read(run) is None


def test_the_four_card_cell_is_one_of_three():
    text = (REPO / "BENCHMARK.json").read_text()
    spec = json.loads(text)
    _keeps_to_the_rules(spec, text, core.BENCH_DIR)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    assert len(chips) == 3 and chips[CELL] == 4
    assert sum(n == 4 for n in chips.values()) == 1
    work, cell, cfg, mix = core.find_cell(spec, CELL)
    base = core.read_json("configs", "tsqb-text-l0")
    assert {k: v for k, v in cfg.items() if k not in ("name", "assumed")} \
        == {k: v for k, v in base.items() if k not in ("name", "assumed")}
    assert mix == core.read_json("traffic", "decode") and mix["args"] == {}
    assert {m["name"] for m in core.metrics_for(spec, CELL, "per_layer")} \
        == {"device_idle_pct.decode", "decode_kernels_roofline",
            "copy_ms_per_GB.decode", "idle_resolve_pct.decode",
            "idle_stage_pct.decode", "idle_assemble_pct.decode",
            "idle_untraced_pct.decode", "resolve_thread_s_per_GB.decode",
            PEER}
    assert [m["name"] for m in core.metrics_for(spec, CELL, "end_to_end")] \
        == ["decode_MBps", "host_cpu_s_per_GB", "setup_s"]


def test_a_second_four_card_cell_is_refused(tmp_path):
    spec, text, bench = _with_cells(tmp_path, (4,))
    with pytest.raises(AssertionError):
        _keeps_to_the_rules(spec, text, bench)
