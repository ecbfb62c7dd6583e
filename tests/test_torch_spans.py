"""The spans the port's entry points record under ``torch.profiler``
(``device="cpu"``: the kernels' plain versions), and the benchmark's
reader that puts each idle instant of a traced window down to the
innermost span on the calling thread (``gpubench/lib/spans.py``)."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turbosqueeze_tpu_torch import tsqx
from turbosqueeze_tpu_torch.format import scan_block_table
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
from turbosqueeze_tpu_torch.parallel import pipeline
from turbosqueeze_tpu_torch.utils import profiling
from turbosqueeze_tpu_torch.utils.profiling import Span

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import port_core  # noqa: E402

from gpubench import core  # noqa: E402
from gpubench.lib import spans as S  # noqa: E402
from gpubench.lib import trace as T  # noqa: E402

DATA = (b"the quick brown fox jumps over the lazy dog, " * 1500
        + bytes(range(256)) * 8) * 2


@pytest.fixture(scope="module")
def native():
    return port_core()


@pytest.fixture(scope="module")
def stream(native):
    return native.compress(DATA, True, level=0)


def _traced(fn):
    """fn()'s result and the spans it recorded under a profiler."""
    seen = {s.id for s in profiling.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s for s in profiling.spans() if s.id not in seen]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _one_call(spans, name):
    """The call span ``name``, after checking every span is of its call
    and every parent is one of the call's spans."""
    calls = [s for s in spans if s.name == name]
    assert len(calls) == 1
    call = calls[0]
    ids = {s.id for s in spans}
    assert all(s.call == call.id for s in spans)
    assert all(s.parent in ids for s in spans if s is not call)
    return call


def test_decompress_records_the_gang_route(stream):
    out, got = _traced(lambda: pipeline.decompress(stream, device="cpu"))
    assert out == DATA
    call = _one_call(got, "decode.call")
    n = _by_name(got)
    # the call names the route asked for, the window the one that ran
    assert call.counts == {"route": "auto", "shards": 1,
                           "bytes_in": len(stream), "bytes_out": len(DATA),
                           "blocks": 1}
    (window,) = n["decode.window"]
    assert window.counts == {"blocks": 1, "card": 0, "route": "gang"}
    assert n["decode.scan"][0].parent == call.id
    assert {s.parent for s in n["decode.assemble"]} == {call.id}
    assert sum(s.counts.get("bytes", 0) for s in n["decode.assemble"]) \
        == len(DATA)
    for name in ("host.resolve", "host.merge", "host.pack", "copy.stage"):
        assert [s.parent for s in n[name]] == [window.id], name
    (resolve,), (merge,) = n["host.resolve"], n["host.merge"]
    (prep,), (gang,) = n["host.bulk_prep"], n["host.bulk_gang"]
    assert prep.parent == resolve.id and gang.parent == merge.id
    assert prep.counts["bytes"] == scan_block_table(stream)[1][0][1]
    # the pool's thread CPU time, at most the span's wall time
    for s in (prep, gang):
        assert 0 < s.counts["cpu_ns"] <= s.end_ns - s.start_ns
    # the pool's spans run on its threads, with the caller's ids
    assert prep.tid != call.tid and gang.tid != call.tid
    assert {s.tid for s in got} - {prep.tid, gang.tid} == {call.tid}
    assert n["host.pack"][0].counts["bytes"] == n["copy.stage"][0].counts[
        "bytes"] > 0


@pytest.mark.parametrize("impl,host", [
    ("bulk2", ["host.resolve", "host.merge", "host.pack", "copy.stage"]),
    ("stream", ["host.pack", "copy.stage"]),
    ("pallas", ["host.tokenize", "host.pack", "copy.stage"]),
])
def test_each_route_records_its_host_layers(stream, impl, host):
    out, got = _traced(lambda: pipeline.decompress(stream, device="cpu",
                                                   impl=impl))
    assert out == DATA
    call = _one_call(got, "decode.call")
    assert call.counts["route"] == impl
    (window,) = _by_name(got)["decode.window"]
    assert window.counts["route"] == impl
    under = sorted({s.name for s in got if s.parent == window.id})
    assert under == sorted(host)


def test_a_declined_window_counts_and_takes_the_stream_kernel(
        stream, native, monkeypatch):
    monkeypatch.setattr(native, "bulk_prep", lambda *a: None)
    out, got = _traced(lambda: pipeline.decompress(stream, device="cpu"))
    assert out == DATA
    (window,) = _by_name(got)["decode.window"]
    assert window.counts == {"blocks": 1, "card": 0, "route": "stream",
                             "declined": 1}
    under = {s.name for s in got if s.parent == window.id}
    assert under == {"host.resolve", "host.pack", "copy.stage"}


def test_compress_records_its_spans(native):
    out, got = _traced(lambda: pipeline.compress(DATA, True, level=0,
                                                 device="cpu"))
    assert out == native.compress(DATA, True, level=0)
    call = _one_call(got, "compress.call")
    n = _by_name(got)
    assert call.counts == {"bytes_in": len(DATA), "level": 0, "blocks": 1,
                           "bytes_out": len(out)}
    (window,) = n["compress.window"]
    assert window.counts == {"blocks": 1, "overflowed": 0}
    assert n["compress.split"][0].parent == call.id
    assert [s.parent for s in n["copy.stage"]] == [window.id]
    assert [s.parent for s in n["compress.download"]] == [window.id]
    joins = n["compress.join"]
    assert {s.parent for s in joins} == {call.id}
    assert joins[-1].counts == {"bytes": len(out)}
    assert "compress.share" not in n and "host.emit" not in n


def test_host_emission_records_on_the_pool(native):
    out, got = _traced(lambda: pipeline.compress(DATA, True, level=2,
                                                 device="cpu"))
    assert out == native.compress(DATA, True, level=2)
    call = _one_call(got, "compress.call")
    (window,) = _by_name(got)["compress.window"]
    (emit,) = _by_name(got)["host.emit"]
    assert emit.parent == window.id and emit.tid != call.tid


def test_tsqx_and_the_file_and_words_entries_record_a_call(stream,
                                                           tmp_path):
    packed = tsqx.pack(stream)
    out, got = _traced(lambda: tsqx.decompress(packed, device="cpu"))
    assert out == DATA
    call = _one_call(got, "decode.call")
    assert call.counts["route"] == "tsqx"
    n = _by_name(got)
    (window,) = n["decode.window"]
    assert {s.name for s in got if s.parent == window.id} == {
        "host.pack", "copy.stage"}
    path = tmp_path / "out.bin"
    size, got = _traced(lambda: pipeline.decompress_to_file(
        stream, path, device="cpu"))
    assert size == len(DATA) and path.read_bytes() == DATA
    call = _one_call(got, "decode.call")
    assert call.counts["bytes_out"] == len(DATA)
    assert sum(s.counts.get("bytes", 0) for s in got
               if s.name == "decode.assemble") == len(DATA)
    _, got = _traced(lambda: pipeline.decompress_to_words(
        stream, device="cpu", impl="stream"))
    _one_call(got, "decode.call")
    assert "decode.window" in _by_name(got)


@pytest.fixture
def fake_card(monkeypatch):
    """The CPU build standing in for a CUDA one, which it cannot pin or
    upload to: ``torch.empty(pin_memory=True)``, ``torch.zeros(pin_memory=
    True)`` and ``pin_memory()`` give host tensors that ``is_pinned``
    reports as pinned, and a copy to a CUDA device leaves a tensor where it
    is, so the kernels' plain versions run. Returns the pinned tensors,
    kept alive so that no other tensor reuses their memory."""
    pinned = []
    to = torch.Tensor.to

    def pinning(make):
        def made(*args, pin_memory=False, **kw):
            t = make(*args, **kw)
            if pin_memory:
                pinned.append(t)
            return t
        return made

    def pin(self):
        pinned.append(self.clone())
        return pinned[-1]

    def is_pinned(self):
        ptr = self.untyped_storage().data_ptr()
        return any(t.untyped_storage().data_ptr() == ptr for t in pinned)

    def upload(self, *args, **kw):
        dev = args[0] if args else kw.get("device")
        if isinstance(dev, (str, torch.device)) and \
                torch.device(dev).type == "cuda":
            return self
        return to(self, *args, **kw)

    monkeypatch.setattr(torch, "empty", pinning(torch.empty))
    monkeypatch.setattr(torch, "zeros", pinning(torch.zeros))
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    monkeypatch.setattr(torch.Tensor, "is_pinned", is_pinned)
    monkeypatch.setattr(torch.Tensor, "to", upload)
    return pinned


def _under_a_call(fn):
    """fn()'s result and the spans it recorded inside a call span."""
    def called():
        with profiling.call("test.call"):
            return fn()
    return _traced(called)


def test_copy_stage_restages_only_planes_not_pinned(fake_card):
    arrays = [np.arange(16 * 128, dtype=np.int32).reshape(16, 128),
              np.full((2, 32), 0xFFFFFFFF, np.uint32)]
    nbytes = sum(a.nbytes for a in arrays)
    held = [torch.empty(a.shape, dtype=torch.int32, pin_memory=True)
            for a in arrays]
    for t, a in zip(held, arrays):
        t.numpy()[...] = a.view(np.int32)
    for planes, restaged in ((arrays, nbytes), (held, 0)):
        out, got = _under_a_call(lambda: planes_to_torch(*planes,
                                                         device="cuda"))
        (stage,) = _by_name(got)["copy.stage"]
        assert stage.counts == {"bytes": nbytes, "restaged": restaged}
        for t, a in zip(out, arrays):
            assert t.dtype == torch.int32 and t.is_pinned()
            assert np.array_equal(t.numpy(), a.view(np.int32))
    # the pinned planes go up from where they are: no copy on the host
    assert [t.data_ptr() for t in out] == [t.data_ptr() for t in held]
    _, got = _under_a_call(lambda: planes_to_torch(*arrays, device="cpu"))
    assert _by_name(got)["copy.stage"][0].counts["restaged"] == 0


@pytest.mark.parametrize("route, restaged", [
    ("gang", False), ("bulk2", True), ("stream", False), ("pallas", False),
    ("xla", True)])
def test_the_gang_and_stream_routes_upload_their_planes_as_packed(
        stream, fake_card, monkeypatch, route, restaged):
    """On a CUDA device (faked) the gang and stream routes pack their
    planes on the pool into pinned memory inside ``host.pack``, and
    ``copy.stage`` restages none of them; the stream route's ``host.pack``
    counts the rows its payload plane was cut to. The token route packs
    into pinned memory too and restages nothing; the bulk and xla routes
    restage every plane byte."""
    from turbosqueeze_tpu_torch.kernels import decode_stream as PS
    from turbosqueeze_tpu_torch.kernels import decode_tokens as PT

    fills = []
    fill = PT.fill_row

    def timed_fill(row, data):
        t0 = time.perf_counter_ns()
        fill(row, data)
        fills.append((threading.get_native_id(), t0, time.perf_counter_ns()))

    monkeypatch.setattr(PT, "fill_row", timed_fill)
    _, table = scan_block_table(stream)
    with ThreadPoolExecutor(4) as pool:
        (words, base), got = _under_a_call(
            lambda: pipeline._WINDOW_ROUTES[route](
                stream, table, torch.device("cuda"), pool))
    assert PT.words_to_bytes(words[0], base + len(DATA))[base:] == DATA
    n = _by_name(got)
    (pack,), (stage,) = n["host.pack"], n["copy.stage"]
    assert stage.counts["bytes"] == pack.counts["bytes"] > 0
    assert stage.counts["restaged"] == (stage.counts["bytes"] if restaged
                                        else 0)
    # gang: a literal row and a record row a block; stream: a payload row
    n_fills = {"gang": 2, "stream": len(table)}.get(route, 0)
    assert len(fills) == n_fills and all(
        tid != pack.tid and pack.start_ns <= t0 <= t1 <= pack.end_ns
        for tid, t0, t1 in fills)
    if route == "stream":
        assert pack.counts["pay_rows"] == PS.payload_rows(
            max(psz for _, psz, _ in table)) < PT.PAY_ROWS
    else:
        assert "pay_rows" not in pack.counts


@pytest.mark.parametrize("dictionary", [None, b"a preset dictionary " * 50])
def test_a_compress_window_stages_its_rows_as_packed(fake_card, dictionary):
    """On a CUDA device (faked) a compress window packs its rows into
    pinned memory inside its one ``copy.stage`` span, which counts the
    rows' bytes and restages none of them."""
    from turbosqueeze_tpu_torch.kernels.encode_emit import IN_ROWS

    win = [DATA[:70_000], DATA[70_000:]]
    batch, got = _under_a_call(lambda: pipeline._upload_window(
        win, dictionary, torch.device("cuda")))
    (stage,) = _by_name(got)["copy.stage"]
    assert stage.counts == {"restaged": 0,
                            "bytes": len(win) * IN_ROWS * 512}
    assert batch.is_pinned() and batch.shape == (len(win), IN_ROWS * 512)
    d = dictionary or b""
    for row, blk in zip(batch.numpy(), win):
        assert row[:len(d) + len(blk)].tobytes() == d + blk
        assert not row[len(d) + len(blk):].any()


# -- the benchmark's reader -------------------------------------------------

def _canned(t0, setup_s=12.0):
    """A 10 s window with the device busy in [1, 2] and [5, 6], and the
    spans of one decode call on thread 100 (pool threads 200, 201), with
    a span of an earlier call before the window."""
    ns = lambda s: t0 + round(s * 1e9)  # noqa: E731
    sp = [Span("decode.call", 1, 0, 1, 100, ns(-2), ns(-1), {}),
          Span("decode.scan", 11, 10, 10, 100, ns(0.5), ns(0.6), {}),
          Span("host.bulk_prep", 14, 13, 10, 200, ns(0.6), ns(2.9),
               {"cpu_ns": 2 * 10**9}),
          Span("host.resolve", 13, 12, 10, 100, ns(0.6), ns(2.9), {}),
          Span("host.bulk_gang", 16, 15, 10, 201, ns(2.9), ns(3.0),
               {"cpu_ns": 10**8}),
          Span("host.merge", 15, 12, 10, 100, ns(2.9), ns(3.0), {}),
          Span("host.pack", 17, 12, 10, 100, ns(3.0), ns(3.5), {}),
          Span("copy.stage", 18, 12, 10, 100, ns(3.5), ns(4.0), {}),
          Span("decode.window", 12, 10, 10, 100, ns(0.6), ns(4.0), {}),
          Span("decode.drain", 19, 10, 10, 100, ns(6.5), ns(7.0), {}),
          Span("decode.assemble", 20, 10, 10, 100, ns(7.0), ns(9.0), {}),
          Span("decode.call", 10, 0, 10, 100, ns(0.5), ns(9.5), {})]
    tr = T.Trace(10.0, kernels=[("k", 1.0, 2.0), ("k", 5.0, 6.0)])
    return sp, SimpleNamespace(setup_s=setup_s, trace=tr, window_s=10.0,
                               user_bytes=2 * 10**9)


def test_the_reader_puts_idle_time_down_to_the_innermost_span(monkeypatch):
    run = _canned(0)[1]
    spans, _ = _canned(S.window_start_ns(run.setup_s))
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    idle = S.idle_by_span(run)
    assert idle == {
        S.UNTRACED: pytest.approx(0.5 + 1.5 + 0.5 + 0.5, abs=1e-3),
        "decode.scan": pytest.approx(0.1, abs=1e-3),
        "host.resolve": pytest.approx(1.3, abs=1e-3),
        "host.merge": pytest.approx(0.1, abs=1e-3),
        "host.pack": pytest.approx(0.5, abs=1e-3),
        "copy.stage": pytest.approx(0.5, abs=1e-3),
        "decode.drain": pytest.approx(0.5, abs=1e-3),
        "decode.assemble": pytest.approx(2.0, abs=1e-3)}
    read = {m: core.load_reader(m)(run) for m in (
        "idle_resolve_pct.decode", "idle_stage_pct.decode",
        "idle_assemble_pct.decode", "idle_untraced_pct.decode",
        "device_idle_pct.decode", "resolve_thread_s_per_GB.decode")}
    assert read["idle_resolve_pct.decode"] == pytest.approx(14.0, abs=0.02)
    assert read["idle_stage_pct.decode"] == pytest.approx(10.0, abs=0.02)
    assert read["idle_assemble_pct.decode"] == pytest.approx(20.0, abs=0.02)
    assert read["idle_untraced_pct.decode"] == pytest.approx(30.0, abs=0.02)
    assert read["device_idle_pct.decode"] == pytest.approx(80.0)
    # every name's share and the untraced share sum to the idle share
    assert 100 * sum(idle.values()) / 10.0 == pytest.approx(
        read["device_idle_pct.decode"], abs=1e-9)
    # 2.0 CPU s of bulk_prep and 0.1 of bulk_gang over 2 GB
    assert read["resolve_thread_s_per_GB.decode"] == pytest.approx(1.05)


def test_the_compress_readers_on_canned_spans(monkeypatch):
    run = _canned(0)[1]
    t0 = S.window_start_ns(run.setup_s)
    ns = lambda s: t0 + round(s * 1e9)  # noqa: E731
    spans = [Span("compress.split", 2, 1, 1, 7, ns(0.0), ns(0.5), {}),
             Span("copy.stage", 4, 3, 1, 7, ns(0.5), ns(1.0), {}),
             Span("compress.download", 5, 3, 1, 7, ns(6.0), ns(6.5), {}),
             Span("compress.window", 3, 1, 1, 7, ns(0.5), ns(6.5), {}),
             Span("compress.join", 6, 1, 1, 7, ns(6.5), ns(7.5), {}),
             Span("compress.call", 1, 0, 1, 7, ns(-0.5), ns(12.0), {})]
    monkeypatch.setattr(S, "program_spans", lambda: spans)
    read = {m: core.load_reader(m)(run) for m in (
        "idle_stage_pct.compress", "idle_download_pct.compress",
        "idle_join_pct.compress", "idle_untraced_pct.compress")}
    assert read == {"idle_stage_pct.compress": pytest.approx(10.0, abs=0.02),
                    "idle_download_pct.compress": pytest.approx(5.0,
                                                                 abs=0.02),
                    "idle_join_pct.compress": pytest.approx(10.0, abs=0.02),
                    "idle_untraced_pct.compress": pytest.approx(
                        25.0, abs=0.02)}
    # compress.window's own idle time, [2, 5] of [1, 6]: 3 s
    assert S.idle_by_span(run)["compress.window"] == pytest.approx(3.0,
                                                                   abs=1e-3)


def test_the_readers_read_nothing_without_the_programs_spans(monkeypatch):
    run = _canned(0)[1]
    monkeypatch.delattr(profiling, "spans")
    assert S.program_spans() is None
    for m in ("idle_resolve_pct.decode", "idle_untraced_pct.compress",
              "resolve_thread_s_per_GB.decode"):
        assert core.load_reader(m)(run) is None
    monkeypatch.undo()
    monkeypatch.setattr(S, "program_spans", lambda: [])
    assert core.load_reader("idle_stage_pct.decode")(run) is None
    assert core.load_reader("idle_stage_pct.decode")(
        SimpleNamespace(trace=None, setup_s=0.0)) is None


def test_the_window_mapping_puts_its_start_at_zero():
    """A span open while ``setup_s`` is taken, as ``core.run_cell`` takes
    it just before the window opens, maps onto an interval that holds the
    window's start, 0, within 1 ms (its ends are 0 within 1 ms unless the
    thread was held up inside it)."""
    def work():
        with profiling.call("decode.call"):
            return core.process_age_s()

    setup_s, (span,) = _traced(work)
    t0 = S.window_start_ns(setup_s)
    start, end = (span.start_ns - t0) / 1e9, (span.end_ns - t0) / 1e9
    assert start - 1e-3 < 0 < end + 1e-3
    run = SimpleNamespace(setup_s=setup_s, trace=T.Trace(1.0))
    assert [p[0] for p in S.on_window(run, [span])] == [span]
