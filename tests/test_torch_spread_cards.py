"""A decode spread over four devices in one process (``device=["cpu"] *
4``, the kernels' plain versions) names each shard's card on its spans:
``decode.window`` and ``decode.drain`` carry ``card``, ``decode.call``
carries ``shards``. An 11-block container at ``window_blocks`` 8 gives
two windows, four shards of 2 blocks and then shards of 1/1/1/0. Without
a profiler session nothing records and the shards launch in the same
order. Tolerance: equal bytes."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turbosqueeze_tpu_torch import tsqx
from turbosqueeze_tpu_torch.format import (ContainerHeader, pack_block_header,
                                           scan_block_table)
from turbosqueeze_tpu_torch.parallel import pipeline as PP
from turbosqueeze_tpu_torch.utils import profiling
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import port_core  # noqa: E402

from gpubench.reference import tsq_codec  # noqa: E402

FOUR = ["cpu"] * 4
# 11 blocks of 9-19 KB: the container's blocks need not be full
BLOCKS = [synthetic_text(9000 + 1000 * b, seed=230 + b) for b in range(11)]
DATA = b"".join(BLOCKS)


@pytest.fixture(scope="module")
def stream():
    """BLOCKS as one level-0 container, ext on, each block's payload from
    the port's native core."""
    native = port_core()
    parts = [ContainerHeader(len(BLOCKS), len(DATA)).pack()]
    for block in BLOCKS:
        one = native.compress(block, True, level=0)
        (off, size, ext), = scan_block_table(one)[1]
        parts += [pack_block_header(size, ext), one[off:off + size]]
    return b"".join(parts)


def _traced(fn):
    """fn()'s result and the spans it recorded under a profiler."""
    seen = {s.id for s in profiling.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.spans() if s.id not in seen]


def _decode(stream):
    return PP.decompress(stream, device=FOUR, window_blocks=8)


def test_four_shards_decode_to_the_reference(stream):
    n, total, table = tsq_codec.parse_container(stream)
    want = b"".join(tsq_codec.decode_block(stream[off:off + size], ext)
                    for off, size, ext in table)
    assert (n, total) == (11, len(DATA)) and want == DATA
    assert _decode(stream) == want


def test_each_shard_names_its_card(stream):
    out, got = _traced(lambda: _decode(stream))
    assert out == DATA
    (call,) = [s for s in got if s.name == "decode.call"]
    assert call.counts["shards"] == 4 and call.counts["blocks"] == 11
    windows = sorted((s for s in got if s.name == "decode.window"),
                     key=lambda s: s.id)
    assert [(s.counts["card"], s.counts["blocks"]) for s in windows] == [
        (0, 2), (1, 2), (2, 2), (3, 2), (0, 1), (1, 1), (2, 1)]
    assert all(s.parent == call.id and s.tid == call.tid for s in windows)
    # the CPU copy needs no wait: no drain
    assert not [s for s in got if s.name == "decode.drain"]


def test_a_shards_wait_names_its_card():
    """A CUDA shard's wait for its download: ``decode.drain`` with the
    card ``_Pending`` was given."""
    pending = PP._Pending(torch.zeros((2, 4, 128), dtype=torch.int32),
                          [5, 7], card=2)
    pending.done = SimpleNamespace(synchronize=lambda: None)

    def drain():
        with profiling.call("decode.call"):
            return pending.views()

    views, got = _traced(drain)
    assert [len(v) for v in views] == [5, 7]
    (wait,) = [s for s in got if s.name == "decode.drain"]
    assert wait.counts == {"card": 2}


def test_the_other_entries_name_cards_alike(stream):
    (words, sizes, _), got = _traced(lambda: PP.decompress_to_words(
        stream, device=FOUR, impl="stream", window_blocks=2))
    assert b"".join(
        words.shards[b // 3].data[b % 3].view(torch.uint8).reshape(-1)[:n]
        .numpy().tobytes() for b, n in enumerate(sizes)) == DATA
    cards = [s.counts["card"] for s in sorted(
        (s for s in got if s.name == "decode.window"), key=lambda s: s.id)]
    # 3 rows a shard (12 padded), windows of 2: rows 0-1, then row 2 (the
    # last shard's is padding)
    assert cards == [0, 1, 2, 3, 0, 1, 2]
    assert [s.counts["shards"] for s in got if s.name == "decode.call"] == [4]
    out, got = _traced(lambda: tsqx.decompress(tsqx.pack(stream),
                                               device=FOUR))
    assert out == DATA
    (call,) = [s for s in got if s.name == "decode.call"]
    assert call.counts["shards"] == 4
    # three groups of four blocks over four shards: the last is empty
    assert [s.counts["card"] for s in sorted(
        (s for s in got if s.name == "decode.window"),
        key=lambda s: s.id)] == [0, 1, 2]


def test_cards_are_ordinals_or_positions(monkeypatch):
    assert PP._Spread(FOUR, 11, 8, PP.WINDOW_BLOCKS).cards == [0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for devices, cards in ((["cuda:1", "cuda:3"], [1, 3]), ("cuda:2", [2]),
                           (["cuda:0", "cuda:0"], [0, 1]),
                           (["cuda:2", "cuda:0", "cuda:2"], [0, 1, 2])):
        assert PP._Spread(devices, 11, 0, PP.WINDOW_BLOCKS).cards == cards


def test_without_a_session_nothing_records_and_the_order_holds(
        stream, monkeypatch):
    starts = [off for off, _, _ in scan_block_table(stream)[1]]
    order, route = [], PP._WINDOW_ROUTES["gang"]

    def counted(s, win, *a):
        order.append((starts.index(win[0][0]), len(win)))
        return route(s, win, *a)

    monkeypatch.setitem(PP._WINDOW_ROUTES, "gang", counted)
    before = [s.id for s in profiling.spans()]
    assert _decode(stream) == DATA
    assert [s.id for s in profiling.spans()] == before
    # window-major, card-minor: window 1's four shards, then window 2's
    assert order == [(0, 2), (2, 2), (4, 2), (6, 2), (8, 1), (9, 1), (10, 1)]
