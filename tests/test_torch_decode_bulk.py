"""The port's bulk record-stream decode (turbosqueeze_tpu_torch/kernels/
decode_bulk.py and the pipeline's ``impl="bulk"``, ``"bulk2"`` and
``"bulkn"`` routes) on the CPU, where the wrappers run their plain
version: held against the JAX package's three Pallas kernels, run
interpreted, on the same numpy planes, against its ``prep_batch*`` and
pipeline, and against the native core. Tolerance zero over each block's
first ``size`` bytes (``[dict_len, dict_len + size)`` with a dictionary)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import decode_bulk as RB
from turbosqueeze_tpu.parallel import mesh as ref_mesh
from turbosqueeze_tpu.parallel import pipeline as ref_pipeline
from turbosqueeze_tpu_torch.format import iter_container, scan_block_table
from turbosqueeze_tpu_torch.kernels import decode_bulk as PB
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
from turbosqueeze_tpu_torch.parallel import pipeline
from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                 synthetic_text)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import (BULK_CASES, CORRUPT, bulk_hand_planes,  # noqa: E402
                          check_corrupt_difference)
from test_torch_host_copies import jax_core, port_core  # noqa: E402

MiB = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def native():
    jax_core()  # the JAX package's prep_batch* and pipeline run on it
    return port_core()


def _ref(abi, nblk, planes, **kw):
    if abi == "bulk":
        out = RB.decode_bulk_batch(*planes, interpret=True, **kw)
    elif abi == "bulk2":
        out = RB.decode_bulk2_batch(*planes, interpret=True, **kw)
    else:
        out = RB.decode_bulkn_batch(*planes, nblk=nblk, interpret=True, **kw)
    return np.asarray(out)


def _port(abi, nblk, planes, **kw):
    out = PB.decode_bulk(abi, nblk, *planes_to_torch(*planes, device="cpu"),
                         **kw)
    assert out.dtype == torch.int32
    return out.numpy()


def _block(words, b, base, size):
    return words[b].reshape(-1).view("u1")[base:base + size].tobytes()


def _both(abi, nblk, payloads, datas, base=0, **kw):
    """The same planes through the JAX kernel (interpreted) and the port;
    every block's bytes equal, and equal to its input."""
    ref_planes = {"bulk": lambda: RB.prep_batch(payloads),
                  "bulk2": lambda: RB.prep_batch2(payloads),
                  "bulkn": lambda: RB.prep_batchn(payloads, nblk)}[abi]()
    planes = PB.pack_batch(PB.resolve_blocks(payloads), abi, nblk)
    for a, b in zip(ref_planes, planes):  # the port's host glue agrees
        assert np.array_equal(np.asarray(a), np.asarray(b))
    ref = _ref(abi, nblk, planes[:3], **kw)
    got = _port(abi, nblk, planes[:3], **kw)
    assert got.shape == ref.shape
    for k, d in enumerate(datas):
        assert _block(ref, k, base, len(d)) == d, f"reference block {k}"
        assert _block(got, k, base, len(d)) == d, f"{abi} block {k}"
    return got


def _mixed(native):
    """Text, zeros, structured binary and random bytes at levels 0-2, ext
    on and off: (payload, ext) and the inputs."""
    datas = [synthetic_text(90_000, seed=41), bytes(40_000),
             synthetic_binary(60_000, seed=43),
             np.random.default_rng(7).bytes(30_000),
             synthetic_text(16_000, seed=44)]
    levels, exts = (0, 1, 2, 1, 2), (True, True, False, True, False)
    return [(native.compress(d, e, level=lv)[19:], e)
            for d, lv, e in zip(datas, levels, exts)], datas


@pytest.mark.parametrize("abi, nblk", [("bulk", 1), ("bulk2", 2),
                                       ("bulkn", 1), ("bulkn", 2),
                                       ("bulkn", 3), ("bulkn", 4)])
def test_plain_matches_jax_kernel(native, abi, nblk):
    """Five blocks: bulk2 and bulkn pad the last group with empty blocks,
    which decode to nothing."""
    payloads, datas = _mixed(native)
    got = _both(abi, nblk, payloads, datas)
    assert got.shape[0] == -(-len(datas) // nblk) * nblk
    assert not got[len(datas):].any()


def test_two_windows_tail_reach(native):
    """A 2 MiB + 200 KB block: the second window's U records read the
    first window's last 130 rows, matches reaching back across the edge."""
    base = synthetic_text(64 * 1024, seed=11)
    data = (base * ((3 << 20) // len(base) + 1))[:(1 << 21) + 200_000]
    _both("bulk", 1, [(native.compress(data, True, level=1)[19:], True)],
          [data])


def test_anchor_before_window_edge(native):
    """A pair whose anchor lies just before a window edge while its second
    symbol's bytes land after it (the tail's 64-byte extension)."""
    rng = np.random.default_rng(23)
    data = rng.bytes(1 << 21) + bytes(100_000) + rng.bytes(50_000)
    _both("bulk2", 2, [(native.compress(data, True, level=2)[19:], True)],
          [data])


def test_dictionary_three_windows(native):
    """A full block with a 33 KB dictionary: the dict-extended output
    spans three 2 MiB windows, and matches reach into the dictionary."""
    d = synthetic_text(33_000, seed=113)
    data = (synthetic_text(200_000, seed=114) + bytes((1 << 22) - 300_000)
            + synthetic_text(100_000, seed=115))
    (_, payload, ext), = iter_container(native.compress_dict(data, d, True))
    lit, rec, meta = native.bulk_prep(payload, ext, d)
    assert meta[1] == 3
    planes = PB.pack_batch([(lit, rec, meta)], "bulk")
    kw = {"out_rows": 3 * PB.WIN_ROWS, "max_win": 3}
    ref = _ref("bulk", 1, planes[:3], **kw)
    got = _port("bulk", 1, planes[:3], **kw)
    assert _block(ref, 0, len(d), len(data)) == data
    assert _block(got, 0, len(d), len(data)) == data
    assert PB.decode_bulk_block(payload, ext, device="cpu",
                                dictionary=d) == data


def test_block_helper_defaults_to_the_card(native, monkeypatch):
    """``decode_bulk_block`` decodes on the card unless asked for the CPU:
    with no GPU it raises rather than run the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = synthetic_text(20_000, seed=61)
    (_, payload, ext), = iter_container(native.compress(data, True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.decode_bulk_block(payload, ext)
    assert PB.decode_bulk_block(payload, ext, device="cpu") == data


def test_prep_batches_equal_reference(native):
    payloads, _ = _mixed(native)
    for port, ref in ((PB.prep_batch(payloads), RB.prep_batch(payloads)),
                      (PB.prep_batch2(payloads), RB.prep_batch2(payloads)),
                      *[(PB.prep_batchn(payloads, n),
                         RB.prep_batchn(payloads, n)) for n in (1, 2, 3, 4)]):
        assert len(port) == len(ref) == 4
        for a, b in zip(port[:3], ref[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert port[3] == ref[3]


def test_coschedule_rule_equals_reference():
    for lit_rows in (8, 64, 3392, 3456, 8256, 8384, 11_000, 20_000):
        assert PB.best_coschedule(lit_rows) == RB.best_coschedule(lit_rows)
        for n in (1, 2, 3, 4):
            assert (PB.coschedule_fit(lit_rows, n)
                    == RB.coschedule_fit(lit_rows, n))


@pytest.mark.parametrize("case, msg", [
    ("odd_pairs", "even block count"),
    ("nblk5", "nblk"),
    ("lit_rows", "multiples of 8"),
    ("rec_rows", "multiples of 8"),
])
def test_wrapper_checks_match_reference(case, msg):
    B, lit_rows, rec_rows, nblk = 2, 8, 8, 1
    if case == "odd_pairs":
        B = 3
    elif case == "lit_rows":
        lit_rows = 12
    elif case == "rec_rows":
        rec_rows = 20
    elif case == "nblk5":
        B, nblk = 5, 5
    abi = "bulk2" if case == "odd_pairs" else "bulkn"
    G = max(B // (2 if abi == "bulk2" else nblk), 1)
    planes = (np.zeros((B, lit_rows, 128), np.int32),
              np.zeros((G, rec_rows, 128), np.int32),
              np.zeros((G, 8 if abi == "bulk2" else 16), np.int32))
    with pytest.raises(ValueError):
        _ref(abi, nblk, planes)
    with pytest.raises(ValueError, match=msg):
        _port(abi, nblk, planes)


def test_wrapper_refuses_bad_planes():
    lit = torch.zeros((2, 8, 128), dtype=torch.int32)
    rec = torch.zeros((2, 8, 128), dtype=torch.int32)
    meta = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        PB.decode_bulk_batch(lit, rec.to(torch.int64), meta)
    with pytest.raises(ValueError, match="meta"):
        PB.decode_bulk_batch(lit, rec, meta[:, :4])
    with pytest.raises(ValueError, match="meta"):
        PB.decode_bulkn_batch(lit, rec[:1], meta[:1], nblk=2)  # 8, not 16
    with pytest.raises(ValueError, match="out_rows"):
        PB.decode_bulk_batch(lit, rec, meta, out_rows=4096, max_win=2)
    with pytest.raises(ValueError, match="max_win"):
        PB.decode_bulk_batch(lit, rec, meta, max_win=4)
    with pytest.raises(ValueError, match="meta is on meta"):
        PB.decode_bulk_batch(lit, rec, meta.to("meta"))
    with pytest.raises(ValueError, match="ABI"):
        PB.decode_bulk("bulk3", 1, lit, rec, meta)
    before = dict(PB.launches)
    PB.decode_bulk_batch(lit, rec, meta)
    assert PB.launches == before  # CPU: the plain version, no launch


def test_garbage_planes_stay_in_bounds():
    """Random words as stream and meta: the plain version walks them to
    the end of the stream, and writes only inside the block's windows."""
    rng = np.random.default_rng(9)
    lit = rng.integers(-2**31, 2**31, (4, 16, 128), dtype=np.int32)
    rec = rng.integers(0, 2**32, (2, 32, 128), dtype=np.uint32)
    rec[:, ::2, ::2] &= 0xFFF  # rows inside the window, small counts
    rec[:, ::2, 1::2] &= 0x00030003
    meta = rng.integers(0, 2**32, (2, 16), dtype=np.uint32)
    meta[:, 4:8] = 3
    meta[:, 9:12] = [[100, 3000, 9000], [0, 4096, 4096]]
    out = _port("bulkn", 2, (lit, rec, meta), out_rows=3 * PB.WIN_ROWS,
                max_win=3)
    assert out.shape == (4, 3 * PB.WIN_ROWS, 128) and out.any()


@pytest.mark.parametrize("case", list(BULK_CASES))
def test_hand_built_streams_match_reference(case):
    """Entries whose records overlap (``gang_streams.BULK_CASES``): an
    entry applies U gangs of 8, U singles, W gangs of 8 and W singles in
    turn, each replacing the bytes it covers with the OR of its records'.
    Every byte a record covers equals the interpreted kernel's; the rest
    stays zero (the reference's window starts as scratch there)."""
    abi, nblk, lit, rec, meta, covered = bulk_hand_planes(case)
    ref = _ref(abi, nblk, (lit, rec, meta), max_win=1)
    got = _port(abi, nblk, (lit, rec, meta), max_win=1)
    ref, got = (x.view(np.uint8).reshape(nblk, -1, 512) for x in (ref, got))
    win = got[:, :PB.WIN_ROWS]
    assert np.array_equal(win[covered], ref[:, :PB.WIN_ROWS][covered])
    assert not win[~covered].any() and not got[:, PB.WIN_ROWS:].any()


# --- the pipeline's bulk routes ----------------------------------------------

def _jax(stream, **kw):
    return ref_pipeline.decompress(
        stream, mesh=ref_mesh.block_mesh(jax.devices()[:1]), **kw)


@pytest.fixture
def routes(monkeypatch):
    """The kernel wrappers each decode ran, in order."""
    calls = []
    for name in ("decode_bulk_batch", "decode_bulk2_batch",
                 "decode_bulkn_batch"):
        fn = getattr(PB, name)
        monkeypatch.setattr(PB, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("nblk"))), _f(*a, **k))[1])
    fn = PS.decode_stream_batch
    monkeypatch.setattr(PS, "decode_stream_batch", lambda *a, **k: (
        calls.append(("decode_stream_batch", None)), fn(*a, **k))[1])
    return calls


_BULK_ROUTES = [("bulk", "decode_bulk_batch", None),
                ("bulk2", "decode_bulk2_batch", None),
                ("bulkn", "decode_bulkn_batch", 4)]


@pytest.mark.parametrize("impl, wrapper, nblk", _BULK_ROUTES)
def test_routes_match_native_and_jax(native, routes, impl, wrapper, nblk):
    """A one-block container, without and with a dictionary: equal to the
    input, ``native.decompress`` / ``decompress_dict`` and the JAX
    pipeline with the same impl."""
    data = synthetic_text(70_000, seed=51) + synthetic_binary(50_000, seed=52)
    d = synthetic_text(20_000, seed=53)
    for dictionary in (None, d):
        stream = (native.compress_dict(data, d, True) if dictionary
                  else native.compress(data, True, level=1))
        routes.clear()
        got = pipeline.decompress(stream, device="cpu", impl=impl,
                                  dictionary=dictionary)
        assert got == data
        assert got == (native.decompress_dict(stream, d) if dictionary
                       else native.decompress(stream))
        assert got == _jax(stream, impl=impl, dictionary=dictionary)
        assert routes == [(wrapper, nblk)]


@pytest.mark.parametrize("impl, wrapper, nblk", _BULK_ROUTES)
def test_routes_in_windows_match_native(native, routes, impl, wrapper, nblk):
    """Two full blocks (mostly zeros, to keep the plain version short) and
    a short one in windows of two: the second window pads its group."""
    data = b"".join(head + bytes((4 * MiB) - len(head)) for head in (
        synthetic_text(70_000, seed=56), synthetic_binary(50_000, seed=57)))
    data += synthetic_text(30_000, seed=58)
    stream = native.compress(data, True, level=1)
    assert pipeline.decompress(stream, device="cpu", impl=impl,
                               window_blocks=2) == data
    assert native.decompress(stream) == data
    assert routes == [(wrapper, nblk)] * 2


def test_bulkn_width_follows_the_literal_planes(native, routes):
    """A random block fills its literal plane: 2 MiB of literals no longer
    fit four blocks to a group on the TPU, so the route takes pairs."""
    rng = np.random.default_rng(12)
    data = rng.bytes(2 * MiB)
    stream = native.compress(data, True, level=0)
    assert pipeline.decompress(stream, device="cpu", impl="bulkn") == data
    assert routes == [("decode_bulkn_batch", 2)]


def test_declined_window_falls_back_to_stream(native, routes, monkeypatch):
    """A block the resolver declines sends its window through the stream
    kernel; the other window still takes the bulk kernel."""
    data = synthetic_text((1 << 22) + 150_000, seed=54)
    stream = native.compress(data, True, level=2)
    real = native.bulk_prep
    _, table = scan_block_table(stream)

    def declines_short_blocks(payload, ext, dictionary=None):
        size = payload[0] | payload[1] << 8 | payload[2] << 16
        return None if size < (1 << 22) else real(payload, ext, dictionary)

    monkeypatch.setattr(native, "bulk_prep", declines_short_blocks)
    for impl in ("bulk", "bulk2"):
        routes.clear()
        assert pipeline.decompress(stream, device="cpu", impl=impl,
                                   window_blocks=1) == data
        assert [name for name, _ in routes] == [
            f"decode_{impl}_batch", "decode_stream_batch"]
    assert len(table) == 2


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_documented_differences_from_reference(native, case):
    """Corrupt containers that ``native.decompress`` accepts
    (``gang_streams.CORRUPT``, ROADMAP §3): a match reads output bytes no
    token wrote, where the JAX route's kernel gives its scratch (0x80 in
    interpret mode) and the port 0. The two differ on exactly the listed
    bytes."""
    check_corrupt_difference(case, "bulk", native)
