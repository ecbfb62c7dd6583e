"""The decode's default route, ``impl="auto"``, chosen for each shard by
its device (``pipeline._route``): the stream kernel on a CUDA device, the
host resolve and gang kernel on any other. A CUDA device is stubbed here:
the routes it is handed run their plain versions on the CPU. Every
traced ``decode.window`` names the route that decoded it. Tolerance:
equal bytes."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turbosqueeze_tpu_torch.format import ContainerHeader, pack_block_header
from turbosqueeze_tpu_torch.format import scan_block_table
from turbosqueeze_tpu_torch.parallel import pipeline as PP
from turbosqueeze_tpu_torch.utils import profiling
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import port_core  # noqa: E402

# 5 blocks of 6-10 KB, so that a small window gives several windows
BLOCKS = [synthetic_text(6000 + 1000 * b, seed=240 + b) for b in range(5)]
DATA = b"".join(BLOCKS)
# decompress_to_file writes block b at b << 22: two blocks, the first full
FILE_DATA = (synthetic_text(20_000, seed=245) + bytes((4 << 20) - 20_000)
             + synthetic_text(10_000, seed=246))
EXPLICIT = list(PP._WINDOW_ROUTES)
CPU, CARD = torch.device("cpu"), torch.device("cuda", 1)


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


@pytest.fixture(scope="module")
def file_stream():
    return port_core().compress(FILE_DATA, True, level=0)


def _traced(fn):
    """fn()'s result and the spans it recorded under a profiler."""
    seen = {s.id for s in profiling.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.spans() if s.id not in seen]


def _windows(spans):
    return sorted((s for s in spans if s.name == "decode.window"),
                  key=lambda s: s.id)


@pytest.mark.parametrize("device, want", [
    (torch.device("cuda", 0), "stream"), (CARD, "stream"),
    (torch.device("cuda"), "stream"), (CPU, "gang")])
def test_auto_is_the_stream_kernel_on_a_card_and_gang_elsewhere(device,
                                                                want):
    assert PP._route("auto", device) == want


@pytest.mark.parametrize("device", [CPU, CARD])
@pytest.mark.parametrize("impl", EXPLICIT)
def test_an_explicit_route_is_itself_on_every_device(impl, device):
    assert PP._route(impl, device) == impl


@pytest.fixture
def counted(monkeypatch):
    """Counts the windows each entry of the route table decodes, by the
    device it was handed; every route runs on the CPU."""
    seen = []
    for name in ("gang", "stream"):
        real = PP._WINDOW_ROUTES[name]

        def run(s, win, dev, *a, real=real, name=name):
            seen.append((name, dev.type, len(win)))
            return real(s, win, CPU, *a)

        monkeypatch.setitem(PP._WINDOW_ROUTES, name, run)
    return seen


def _file(stream, tmp_path, **kw):
    """decompress_to_file's file, after checking the size it returns."""
    out = tmp_path / "out"
    assert PP.decompress_to_file(stream, out, **kw) == out.stat().st_size
    return out.read_bytes()


def _decode(entry, stream, file_stream, tmp_path, **kw):
    """(the entry's output, what it should be, its windows' block counts)
    at windows of 2 blocks (decompress) or 1 (decompress_to_file)."""
    if entry == "decompress":
        return (PP.decompress(stream, window_blocks=2, **kw), DATA,
                [2, 2, 1])
    return (_file(file_stream, tmp_path, window_blocks=1, **kw), FILE_DATA,
            [1, 1])


@pytest.mark.parametrize("entry", ["decompress", "decompress_to_file"])
def test_both_entries_map_auto_through_the_route(stream, file_stream,
                                                 tmp_path, counted,
                                                 monkeypatch, entry):
    """On the CPU ``auto`` decodes through gang; with the helper mapping
    the CPU as a card, the same call goes through the stream kernel."""
    out, want, blocks = _decode(entry, stream, file_stream, tmp_path,
                                device="cpu")
    assert out == want
    assert counted == [("gang", "cpu", n) for n in blocks]
    counted.clear()
    route = PP._route
    monkeypatch.setattr(PP, "_route", lambda impl, dev: route(impl, CARD))
    out, want, blocks = _decode(entry, stream, file_stream, tmp_path,
                                device="cpu")
    assert out == want
    assert counted == [("stream", "cpu", n) for n in blocks]


def test_each_shard_takes_the_route_of_its_own_device(stream, counted,
                                                      monkeypatch):
    """A spread over the CPU and a (stubbed) card: each window's first
    shard resolves for the gang kernel, its second goes to the stream
    kernel, and each traced window names its route."""
    monkeypatch.setattr(PP.mesh_mod, "block_devices",
                        lambda device: [CPU, CARD])
    out, got = _traced(lambda: PP.decompress(stream, window_blocks=4))
    assert out == DATA
    assert counted == [("gang", "cpu", 2), ("stream", "cuda", 2),
                       ("gang", "cpu", 1)]
    assert [(w.counts["card"], w.counts["route"]) for w in _windows(got)] \
        == [(0, "gang"), (1, "stream"), (0, "gang")]
    (call,) = [s for s in got if s.name == "decode.call"]
    assert call.counts["route"] == "auto" and call.counts["shards"] == 2


# the stream kernel's plain version on a full block is slow under a
# profiler: decompress_to_file's windows are held to it untraced above
@pytest.mark.parametrize("entry, impl", [
    *[("decompress", i) for i in ("auto", "gang", "stream", "bulk2")],
    *[("decompress_to_file", i) for i in ("auto", "gang", "bulk2")]])
def test_every_traced_window_names_its_route(stream, file_stream, tmp_path,
                                             impl, entry):
    (out, want, blocks), got = _traced(lambda: _decode(
        entry, stream, file_stream, tmp_path, device="cpu", impl=impl))
    assert out == want
    assert [w.counts["route"] for w in _windows(got)] == [
        "gang" if impl == "auto" else impl] * len(blocks)


def test_a_declined_window_names_the_stream_kernel(stream, monkeypatch):
    """The resolver declines the last block: its window reads ``stream``
    and ``declined``, the others ``gang``."""
    native = port_core()
    real = native.bulk_prep
    last = len(BLOCKS[-1])

    def declines_the_last(payload, ext, dictionary=None):
        size = payload[0] | payload[1] << 8 | payload[2] << 16
        return None if size == last else real(payload, ext, dictionary)

    monkeypatch.setattr(native, "bulk_prep", declines_the_last)
    out, got = _traced(lambda: PP.decompress(stream, device="cpu",
                                             window_blocks=2))
    assert out == DATA
    assert [(w.counts["route"], w.counts.get("declined", 0))
            for w in _windows(got)] == [("gang", 0), ("gang", 0),
                                        ("stream", 1)]


def test_set_replaces_a_count_and_records_nothing_off_a_call():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.call("decode.call", route="gang") as c:
            c.set(route="stream")
            c.add(blocks=1)
            c.set(blocks=4)
    (call,) = [s for s in profiling.spans() if s.id == c.id]
    assert call.counts == {"route": "stream", "blocks": 4}
    off = profiling.call("decode.call", route="gang")
    assert off is profiling.OFF
    off.set(route="stream")  # a no-op outside a profiler session


@pytest.mark.parametrize("entry", [PP.decompress, PP.decompress_to_words])
def test_an_unknown_route_is_refused_before_any_decode(stream, counted,
                                                       entry):
    for impl in ("nonesuch", "", "AUTO"):
        with pytest.raises(ValueError, match="unknown impl"):
            entry(stream, device="cpu", impl=impl)
    # the words entry keeps its own two routes: auto is not one of them
    if entry is PP.decompress_to_words:
        with pytest.raises(ValueError, match="unknown impl"):
            entry(stream, device="cpu", impl="auto")
    assert counted == []
