"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, the input and the native core (tolerance zero over each block's
first ``size`` bytes). Every test here needs an NVIDIA GPU and skips
without one. On a machine with the card, from the repository root (JAX is
not needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu_torch.format import iter_container
from turbosqueeze_tpu_torch.kernels import decode_bulk as PB
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels import encode_bulk as PEB
from turbosqueeze_tpu_torch.kernels import encode_emit as PE
from turbosqueeze_tpu_torch.kernels import encode_flat as PEF
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
from turbosqueeze_tpu_torch.parallel import pipeline
from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                 synthetic_text)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from emit_cases import table_cases  # noqa: E402
from gang_streams import (BULK_CASES, CASES, CLASSES,  # noqa: E402
                          CORRUPT, DIFFERENCES, bulk_hand_planes,
                          class_blocks, corrupt_container, garbage_planes,
                          hand_planes, open_slot_blocks)

pytestmark = pytest.mark.cuda

_MIXED = ((lambda: synthetic_text(90_000, seed=41), 0),
          (lambda: bytes(40_000), 1),
          (lambda: synthetic_binary(60_000, seed=43), 2),
          (lambda: np.random.default_rng(7).bytes(40_000), 1))


@pytest.fixture(scope="module")
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from turbosqueeze_tpu_torch.runtime import native

    # build/ may hold a core built with -march=native for another CPU
    native.build(force=True)
    assert native.available()
    return native


def _words_bytes(words, b, lo, n):
    return PT.words_to_bytes(words[b], lo + n)[lo:]


@pytest.mark.parametrize("nblk, slot_recs", [(1, 8), (2, 16), (3, 32)])
def test_gang_kernel_matches_plain(native, nblk, slot_recs):
    datas = [make() for make, _ in _MIXED]
    pe = [(native.compress(d, True, level=lv)[19:], True)
          for d, (_, lv) in zip(datas, _MIXED)]
    lw, gw, gm, sizes = PG.prep_gang(pe, nblk, slot_recs)
    before = PG.launches
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                               nblk=nblk, slot_recs=slot_recs)
    torch.cuda.synchronize()
    assert PG.launches == before + 1
    ref = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=nblk, slot_recs=slot_recs)
    assert got.device.type == "cuda" and got.shape == ref.shape
    for k, d in enumerate(datas):
        assert _words_bytes(got, k, 0, sizes[k]) == d, f"block {k}"
        assert _words_bytes(ref, k, 0, sizes[k]) == d, f"plain block {k}"


@pytest.mark.parametrize("slot_recs", [8, 16, 32])
@pytest.mark.parametrize("case", list(CASES) + list(DIFFERENCES))
def test_gang_kernel_hand_built_streams_match_plain(native, case, slot_recs):
    """Overlapping records, a W gang reading its own row, odd segment
    bounds, sources outside the planes, rounds past the stream: 50
    launches, each equal to the plain version (a race between a gang's
    reads and its stores would show as a differing launch)."""
    lw, gw, gm, _ = hand_planes(case, slot_recs)
    ref = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=1, slot_recs=slot_recs)
    dev = planes_to_torch(lw, gw, gm, device="cuda")
    outs = [PG.decode_gang_batch(*dev, nblk=1, slot_recs=slot_recs)
            for _ in range(50)]
    assert ref.any()
    for i, got in enumerate(outs):
        assert torch.equal(got.cpu(), ref), f"launch {i}"


@pytest.mark.parametrize("seed", [51, 52, 53])
def test_gang_kernel_garbage_planes_match_plain(native, seed):
    """Garbage records, window counts and segment bounds: the kernels stay
    inside their planes and give the plain version's words exactly."""
    lw, gw, gm, nblk, slot_recs, max_win = garbage_planes(seed)
    kw = dict(nblk=nblk, slot_recs=slot_recs, max_win=max_win,
              out_rows=max_win * pipeline.DBK.WIN_ROWS)
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                               **kw)
    ref = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               **kw)
    assert torch.equal(got.cpu(), ref)
    assert ref.any()


@pytest.fixture(scope="module")
def class_payloads(native):
    blocks = class_blocks()
    return blocks, [(native.compress(d, True, level=1)[19:], True)
                    for d in blocks]


@pytest.mark.parametrize("nblk", [1, 2, 3])
def test_gang_kernel_full_class_blocks_match_plain(class_payloads, nblk):
    """One full level-1 block of each of the eight classes, at the slot
    size the pipeline's table gives each width."""
    blocks, pe = class_payloads
    slot_recs = pipeline.GANG_SRECS[nblk]
    lw, gw, gm, sizes = PG.prep_gang(pe, nblk, slot_recs)
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                               nblk=nblk, slot_recs=slot_recs)
    ref = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=nblk, slot_recs=slot_recs)
    assert torch.equal(got.cpu(), ref)
    for k, d in enumerate(blocks):
        assert _words_bytes(ref, k, 0, sizes[k]) == d, f"block {k}"


@pytest.mark.parametrize("ext", [True, False])
def test_stream_kernel_matches_plain(native, ext):
    datas = [make()[:30_000] for make, _ in _MIXED]
    pw = np.stack([PT.pack_payload_words(
        native.compress(d, ext, level=lv)[19:], 96)
        for d, (_, lv) in zip(datas, _MIXED)])
    # the last block declares a size far past its output plane: the
    # parse stops at the plane's end, and its own bytes stay right
    sizes = [len(d) for d in datas[:-1]] + [2**31 - 1]
    meta = PS.pack_meta([ext] * len(datas), sizes)
    before = PS.launches
    got = PS.decode_stream_batch(*planes_to_torch(pw, meta, device="cuda"),
                                 out_rows=64)
    torch.cuda.synchronize()
    assert PS.launches == before + 1
    ref = PS.decode_stream_batch(*planes_to_torch(pw, meta, device="cpu"),
                                 out_rows=64)
    for k, d in enumerate(datas):
        assert _words_bytes(got, k, 0, len(d)) == d, f"block {k}"
        assert _words_bytes(ref, k, 0, len(d)) == d, f"plain block {k}"


def test_pipeline_mixes_both_kernels(native, monkeypatch):
    """Windows of one block, the short tail block declined by the
    resolver: full blocks take the gang kernel, the tail the stream
    kernel, and the container decodes exactly."""
    data = synthetic_text(2 * (1 << 22) + 54_321, seed=19)
    stream = native.compress(data, True, level=1)
    real = native.bulk_prep

    def declines_short_blocks(payload, ext, dictionary=None):
        size = payload[0] | payload[1] << 8 | payload[2] << 16
        return None if size < (1 << 22) else real(payload, ext, dictionary)

    monkeypatch.setattr(native, "bulk_prep", declines_short_blocks)
    PG.launches = PS.launches = 0
    out = pipeline.decompress(stream, device="cuda", impl="gang",
                              window_blocks=1)
    assert (PG.launches, PS.launches) == (2, 1)
    assert out == data


def test_auto_takes_the_stream_kernel_on_the_card(native, monkeypatch):
    """The default route on a CUDA device parses each raw payload on the
    card: one stream launch a window, no gang launch, no host resolve."""
    data = synthetic_text(2 * (1 << 22) + 54_321, seed=19)
    stream = native.compress(data, True, level=0)
    resolved, real = [], native.bulk_prep
    monkeypatch.setattr(native, "bulk_prep",
                        lambda *a: resolved.append(1) or real(*a))
    PG.launches = PS.launches = 0
    assert pipeline.decompress(stream, window_blocks=1) == data
    assert (PG.launches, PS.launches, resolved) == (0, 3, [])


@pytest.mark.parametrize("with_dict", [False, True])
def test_stream_route_uploads_packed_planes(native, with_dict):
    """The stream route on the card decodes the benchmark's text stand-in
    (three full level-0 blocks and a short one) and a dictionary container
    as the native core does, each window's planes packed into pinned
    memory at the rows of its longest payload: ``copy.stage`` restages
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    from gpubench.gen import text_standin
    from turbosqueeze_tpu_torch.utils import profiling

    data = text_standin.generate(2026, 3 * (1 << 22) + 300_001)
    d = synthetic_text(33_000, seed=113) if with_dict else None
    stream = (native.compress_dict(data, d, True) if d
              else native.compress(data, True, level=0))
    seen = {s.id for s in profiling.spans()}
    PS.launches = 0
    with profile(activities=[ProfilerActivity.CPU]):
        got = pipeline.decompress(stream, device="cuda", impl="stream",
                                  window_blocks=2, dictionary=d)
    assert got == (native.decompress_dict(stream, d) if d
                   else native.decompress(stream)) == data
    spans = [s for s in profiling.spans() if s.id not in seen]
    packs = [s for s in spans if s.name == "host.pack"]
    stages = [s for s in spans if s.name == "copy.stage"]
    assert PS.launches == len(packs) == len(stages) == 2
    assert all(s.counts["restaged"] == 0 < s.counts["bytes"]
               for s in stages)
    assert all(0 < s.counts["pay_rows"] < PT.PAY_ROWS for s in packs)


@pytest.mark.parametrize("matcher", ["cand", "table"])
@pytest.mark.parametrize("ext", [True, False])
def test_emit_kernel_matches_plain(native, matcher, ext):
    """Both matchers on text, zeros, binary, random bytes, a 5-byte and an
    empty block, and (cand) a dictionary base: kernel, plain version and
    the native core give the same payloads."""
    blocks = [make() for make, _ in _MIXED] + [b"abcab", b""]
    for d in (b"", synthetic_text(33_000, seed=113)):
        if d and matcher == "table":
            continue
        planes = [np.stack([PE.pack_input_words(d + b) for b in blocks]),
                  np.stack([PE.pack_cand_words(native.build_candidates(d + b))
                            for b in blocks]),
                  PE.pack_meta([len(b) for b in blocks], len(d))]
        if matcher == "table":
            planes[1] = None
        before = PE.launches[matcher]
        got, gsz = PE.emit_batch(*(None if p is None else
                                   planes_to_torch(p, device="cuda")[0]
                                   for p in planes), ext=ext, matcher=matcher)
        torch.cuda.synchronize()
        assert PE.launches[matcher] == before + 1
        ref, rsz = PE.emit_batch(*(None if p is None else torch.from_numpy(p)
                                   for p in planes), ext=ext, matcher=matcher)
        assert torch.equal(gsz.cpu(), rsz)
        for k, b in enumerate(blocks):
            payload = PE.payload_from_words(got[k], int(rsz[k, 0]))
            assert payload == PE.payload_from_words(ref[k], int(rsz[k, 0]))
            if not b:
                continue
            if d:
                want = native.encode_block_dict(
                    b, d, native.build_candidates(d + b), ext)
            elif matcher == "cand":
                want = native.encode_block_candidates(
                    b, native.build_candidates(b), ext)
            else:
                want = next(iter_container(native.compress(b, ext, 0)))[1]
            assert payload == want, f"block {k}"


def _emit_both(native, blocks, matcher, ext, launches=1):
    """The emit kernel (``launches`` times) and its plain version on
    ``blocks``; asserts every launch equals the plain version and the
    native core (level 0 for ``table``, level 1 for ``cand``)."""
    cand = matcher == "cand"
    planes = [np.stack([PE.pack_input_words(b) for b in blocks]),
              np.stack([PE.pack_cand_words(native.build_candidates(b))
                        for b in blocks]) if cand else None,
              PE.pack_meta([len(b) for b in blocks])]
    dev = [None if p is None else torch.from_numpy(p).cuda() for p in planes]
    ref, rsz = PE.emit_batch(*(None if p is None else torch.from_numpy(p)
                               for p in planes), ext=ext, matcher=matcher)
    want = [PE.payload_from_words(ref[k], int(rsz[k, 0]))
            for k in range(len(blocks))]
    for k, b in enumerate(blocks):
        assert want[k] == (native.encode_block_candidates(
            b, native.build_candidates(b), ext) if cand else
            next(iter_container(native.compress(b, ext, 0)))[1]), k
    for _ in range(launches):
        got, gsz = PE.emit_batch(*dev, ext=ext, matcher=matcher)
        assert torch.equal(gsz.cpu(), rsz)
        assert [PE.payload_from_words(got[k], int(rsz[k, 0]))
                for k in range(len(blocks))] == want


@pytest.fixture(scope="module")
def full_class_blocks(native):
    return class_blocks(len(CLASSES))


@pytest.mark.parametrize("matcher", ["cand", "table"])
@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_emit_kernel_class_blocks(native, full_class_blocks, cls, matcher):
    """One full 4 MiB block of each class of ``chip_smoke.py``'s input,
    ext on and off: kernel, plain version and native core agree."""
    blk = full_class_blocks[cls]
    for ext in (True, False):
        _emit_both(native, [blk], matcher, ext)


@pytest.mark.parametrize("matcher", ["cand", "table"])
@pytest.mark.parametrize("case", list(table_cases()))
def test_emit_kernel_table_cases(native, case, matcher):
    """``tests/emit_cases.py``'s hand-made blocks for the 32-lane batch,
    50 launches each (a race between the lanes' table reads and stores
    would show as a launch that differs), ext on and off."""
    blocks = table_cases()[case]
    for ext in (True, False):
        _emit_both(native, blocks, matcher, ext, launches=50)


def test_compress_matches_native(native):
    """``compress(backend="cuda")`` at levels 0, 1 and 2 and with a
    dictionary: the native core's containers, decoded back on the card."""
    import turbosqueeze_tpu_torch as tsq

    data = b"".join(make() for make, _ in _MIXED) * 20  # 2 blocks
    for level in (0, 1, 2):
        stream = tsq.compress(data, backend="cuda", level=level)
        assert stream == native.compress(data, True, level=level), level
        assert tsq.decompress(stream, backend="cuda") == data
    d = synthetic_text(33_000, seed=113)
    assert tsq.compress(data, backend="cuda", dictionary=d) == \
        native.compress_dict(data, d, True)


def test_wrapper_refuses_planes_on_two_devices(native):
    lit, gang = (torch.zeros((1, 8, 128), dtype=torch.int32, device="cuda")
                 for _ in range(2))
    gmeta = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="gmeta is on cpu"):
        PG.decode_gang_batch(lit, gang, gmeta, nblk=1)
    with pytest.raises(ValueError, match="meta is on cpu"):
        PS.decode_stream_batch(lit, torch.zeros((1, 8), dtype=torch.int32))
    iw = torch.zeros((1, PE.IN_ROWS, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="meta is on cpu"):
        PE.emit_batch(iw, None, torch.zeros((1, 8), dtype=torch.int32),
                      matcher="table")


def _token_planes(native, datas, ext, dictionary=None):
    """Token and payload planes of ``datas`` compressed at the _MIXED
    levels (with ``dictionary``: by ``compress_dict``); returns (planes,
    out_rows, base, sizes)."""
    from turbosqueeze_tpu_torch import block

    if dictionary:
        payloads = [next(iter_container(native.compress_dict(
            d, dictionary, ext)))[1] for d in datas]
    else:
        payloads = [native.compress(d, ext, level=lv)[19:]
                    for d, (_, lv) in zip(datas, _MIXED)]
    parsed = [block.tokenize_with_dict(p, ext, dictionary) for p in payloads]
    with ThreadPoolExecutor() as pool:
        planes, out_rows = pipeline._token_planes(parsed, pool, False)
    return planes, out_rows, parsed[0][6], [p[5] for p in parsed]


@pytest.mark.parametrize("ext, with_dict", [(True, False), (False, False),
                                            (True, True)])
def test_token_kernel_matches_plain(native, ext, with_dict):
    """Mixed classes and levels, ext on and off, and a dictionary staged
    by prefix tokens: the kernel equals its plain version and the input."""
    datas = [make()[:30_000] for make, _ in _MIXED]
    d = synthetic_text(16_400, seed=36) if with_dict else None
    planes, out_rows, base, sizes = _token_planes(native, datas, ext, d)
    assert sizes == list(map(len, datas))
    before = PT.launches
    got = PT.decode_tokens_batch(*(p.cuda() for p in planes),
                                 out_rows=out_rows)
    torch.cuda.synchronize()
    assert PT.launches == before + 1
    ref = PT.decode_tokens_batch(*planes, out_rows=out_rows)
    assert got.device.type == "cuda" and got.shape == ref.shape
    for k, x in enumerate(datas):
        assert _words_bytes(got, k, base, len(x)) == x, f"block {k}"
        assert _words_bytes(ref, k, base, len(x)) == x, f"plain block {k}"


def test_token_kernel_garbage_planes_match_plain(native):
    """Random counts, destinations and sources: the kernel stays inside
    its planes and gives its plain version's words exactly."""
    rng = np.random.default_rng(40)
    pay_rows, out_rows = 16, 24
    pw = rng.integers(-2**31, 2**31, (3, pay_rows, 128), dtype=np.int32)
    ta = rng.integers(-2**31, 2**31, (3, 2, 8, 128), dtype=np.int32)
    tb = rng.integers(-2**31, 2**31, (3, 2, 8, 128), dtype=np.int32)
    # small counts, and addresses near the planes so that bytes land
    ta.reshape(3, -1)[:, ::1024] = [[5000, 7], [-3, 301], [1022, 1023]]
    near = rng.integers(0, (pay_rows + out_rows) * 512, (3, 2, 8, 128))
    ta[1] = (near[1] | rng.integers(0, 128, near[1].shape) << 24).astype(
        np.int32)
    ta.reshape(3, -1)[1, ::1024] = (-3, 301)
    tb[1:] = near[1:].astype(np.int32)
    got = PT.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cuda"),
                                 out_rows=out_rows)
    ref = PT.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cpu"),
                                 out_rows=out_rows)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_token_and_stream_kernels_class_blocks(native, full_class_blocks,
                                               cls, level):
    """One full 4 MiB block of each class at levels 0 and 1, one block a
    launch at the main path's plane shapes: both kernels give the
    input."""
    from turbosqueeze_tpu_torch import block

    data = full_class_blocks[cls]
    payload = native.compress(data, True, level=level)[19:]
    parsed = block.tokenize_with_dict(payload, True, None)
    with ThreadPoolExecutor() as pool:
        planes, out_rows = pipeline._token_planes([parsed], pool, False)
    got = PT.decode_tokens_batch(*(p.cuda() for p in planes),
                                 out_rows=out_rows)
    assert _words_bytes(got, 0, 0, len(data)) == data
    got = PS.decode_stream_batch(*planes_to_torch(
        PT.pack_payload_words(payload)[None],
        PS.pack_meta([True], [len(data)]), device="cuda"))
    assert _words_bytes(got, 0, 0, len(data)) == data


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stream_kernel_garbage_payloads_match_plain(native, seed):
    """Random payloads of 8-32 KiB, declared sizes inside and past the
    output plane, ext on and off (seed 3 with a preset dictionary): the
    parse and the pair mover stay inside their planes and give the plain
    version's words over the whole output plane."""
    rng = np.random.default_rng(500 + seed)
    pay_rows, out_rows = 16 * (1 + seed), 96
    pw = rng.integers(-2**31, 2**31, (4, pay_rows, 128), dtype=np.int32)
    sizes = [int(rng.integers(1, out_rows * 512)), out_rows * 512 + 1,
             2**31 - 1, int(rng.integers(1, 4000))]
    planes = [pw]
    if seed == 3:
        d = rng.bytes(5000)
        planes += [PS.pack_meta([True, False] * 2, sizes, dict_len=len(d)),
                   PS.pack_dict_words(d)]
    else:
        planes.append(PS.pack_meta([True, False, seed % 2 == 0, seed < 2],
                                   sizes))
    got = PS.decode_stream_batch(*planes_to_torch(*planes, device="cuda"),
                                 out_rows=out_rows)
    ref = PS.decode_stream_batch(*planes_to_torch(*planes, device="cpu"),
                                 out_rows=out_rows)
    assert torch.equal(got.cpu(), ref)
    assert ref.any()


def test_gang_kernel_three_windows_matches_plain(native):
    """A full 4 MiB block with a 33 KB dictionary spans three 2 MiB
    windows of the dict-extended space (max_win = 3)."""
    d = synthetic_text(33_000, seed=113)
    data = synthetic_text(1 << 22, seed=114)
    (_, payload, ext), = iter_container(native.compress_dict(data, d, True))
    lw, gw, gm, _ = PG.prep_gang([(payload, ext)], 1, 8, dictionary=d)
    assert gm[0, 8] == 3
    kw = dict(nblk=1, slot_recs=8, out_rows=3 * pipeline.DBK.WIN_ROWS,
              max_win=3)
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                               **kw)
    ref = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               **kw)
    assert _words_bytes(got, 0, len(d), len(data)) == data
    assert _words_bytes(ref, 0, len(d), len(data)) == data


@pytest.mark.parametrize("impl", ["pallas", "xla", "stream", "gang"])
def test_dictionary_routes_match_native(native, impl):
    """Each route with a dictionary, on a container with a full block (the
    gang route's third window) and a short one."""
    import turbosqueeze_tpu_torch as tsq

    d = synthetic_text(33_000, seed=113)
    data = synthetic_text((1 << 22) + 70_000, seed=115)
    stream = native.compress_dict(data, d, True)
    PT.launches = PG.launches = PS.launches = 0
    got = pipeline.decompress(stream, device="cuda", impl=impl, dictionary=d)
    assert got == native.decompress_dict(stream, d) == data
    launched = {"pallas": PT.launches, "gang": PG.launches,
                "stream": PS.launches}
    assert launched.get(impl, 1) > 0
    if impl == "gang":
        assert tsq.decompress(stream, backend="cuda", dictionary=d) == data


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_tokenized_routes_match_native(native, impl):
    data = b"".join(make() for make, _ in _MIXED) * 30
    for level in (0, 1, 2):
        stream = native.compress(data, True, level=level)
        PT.launches = 0
        assert pipeline.decompress(stream, device="cuda", impl=impl) == data
        assert (PT.launches > 0) == (impl == "pallas")


@pytest.mark.parametrize("impl", ["pallas", "stream"])
def test_decompress_to_words_on_the_card(native, impl):
    data = synthetic_text((1 << 22) + 90_000, seed=116)
    stream = native.compress(data, True, level=1)
    PT.launches = 0
    result, sizes, hdr = pipeline.decompress_to_words(
        stream, device="cuda:0", impl=impl, window_blocks=1)
    [shard] = result.shards
    words = shard.data
    assert words.device.type == "cuda" and hdr.n_blocks == 2
    assert result.shape == tuple(words.shape) == (2, PT.OUT_ROWS, 128)
    assert b"".join(_words_bytes(words, b, 0, n)
                    for b, n in enumerate(sizes)) == data
    assert (PT.launches == 2) == (impl == "pallas")


_BULK = [("bulk", 1), ("bulk2", 2), ("bulkn", 1), ("bulkn", 2), ("bulkn", 3),
         ("bulkn", 4)]


def _bulk_decode(abi, nblk, planes, device, **kw):
    return PB.decode_bulk(abi, nblk, *planes_to_torch(*planes, device=device),
                          **kw)


@pytest.mark.parametrize("abi, nblk", _BULK)
def test_bulk_kernel_matches_plain(native, abi, nblk):
    """Each stream ABI on mixed classes and levels, ext on and off, and a
    block of two windows whose matches reach across the window edge: the
    kernel equals its plain version and the input; groups are padded with
    empty blocks."""
    base = synthetic_text(64 * 1024, seed=11)
    two_win = (base * ((3 << 20) // len(base) + 1))[:(1 << 21) + 200_000]
    datas = [make() for make, _ in _MIXED] + [two_win]
    levels = [lv for _, lv in _MIXED] + [1]
    exts = [True, False, True, False, True]
    pe = [(native.compress(d, e, level=lv)[19:], e)
          for d, lv, e in zip(datas, levels, exts)]
    planes = PB.pack_batch(PB.resolve_blocks(pe), abi, nblk)
    before = PB.launches[abi]
    got = _bulk_decode(abi, nblk, planes[:3], "cuda")
    torch.cuda.synchronize()
    assert PB.launches[abi] == before + 1
    ref = _bulk_decode(abi, nblk, planes[:3], "cpu")
    assert got.device.type == "cuda" and got.shape == ref.shape
    for k, d in enumerate(datas):
        assert _words_bytes(got, k, 0, len(d)) == d, f"block {k}"
        assert _words_bytes(ref, k, 0, len(d)) == d, f"plain block {k}"
    assert torch.equal(got.cpu(), ref)  # zero past every block's bytes


def test_bulk_kernel_three_windows_matches_plain(native):
    """A full 4 MiB block with a 33 KB dictionary spans three 2 MiB
    windows of the dict-extended space, through each ABI."""
    d = synthetic_text(33_000, seed=113)
    data = synthetic_text(1 << 22, seed=114)
    (_, payload, ext), = iter_container(native.compress_dict(data, d, True))
    preps = PB.resolve_blocks([(payload, ext)], dictionary=d)
    assert preps[0][2][1] == 3
    kw = dict(out_rows=3 * PB.WIN_ROWS, max_win=3)
    for abi, nblk in (("bulk", 1), ("bulk2", 2), ("bulkn", 3)):
        planes = PB.pack_batch(preps, abi, nblk)[:3]
        got = _bulk_decode(abi, nblk, planes, "cuda", **kw)
        ref = _bulk_decode(abi, nblk, planes, "cpu", **kw)
        assert _words_bytes(got, 0, len(d), len(data)) == data, abi
        assert torch.equal(got.cpu(), ref), abi


def _garbage_bulk(rng, n_groups, nblk, meta_words, nwin_base, end_base):
    """Streams of entries with random rows, counts and records (sources
    anywhere, some past their planes), random words between them, and
    meta with random window counts and ends past the stream."""
    rec_rows = 24
    rec = np.zeros((n_groups, rec_rows * 128), np.uint32)
    for g in range(n_groups):
        p = 0
        while p < rec.shape[1] - 40:
            n = int(rng.integers(0, 12))
            n_u = int(rng.integers(0, n + 1))
            rec[g, p] = rng.integers(0, 4200)
            rec[g, p + 1] = n_u << 16 | (n - n_u)
            r = rng.integers(0, 2**32, 2 * n, dtype=np.uint32)
            r[1::2] &= rng.choice(np.array(
                [0x800000FF, 0x203FFFFF, 0xFFFFFFFF], np.uint32), n)
            rec[g, p + 2:p + 2 + 2 * n] = r
            p += 2 + 2 * n
        rec[g, -5:] = rng.integers(0, 2**32, 5, dtype=np.uint32)
    meta = rng.integers(0, 2**32, (n_groups, meta_words), dtype=np.uint32)
    meta[:, nwin_base:nwin_base + nblk] = rng.integers(0, 5, (n_groups, nblk))
    meta[:, end_base:end_base + 3] = np.sort(
        rng.integers(0, rec.shape[1] + 600, (n_groups, 3)), axis=1)
    lit = rng.integers(-2**31, 2**31, (n_groups * nblk, 16, 128),
                       dtype=np.int32)
    return lit, rec.reshape(n_groups, rec_rows, 128), meta


@pytest.mark.parametrize("abi, nblk", [("bulk", 1), ("bulk2", 2),
                                       ("bulkn", 3)])
def test_bulk_kernel_garbage_planes_match_plain(native, abi, nblk):
    """Garbage streams and meta: the kernel stays inside its planes and
    gives its plain version's words exactly, in three windows."""
    rng = np.random.default_rng(41 + nblk)
    meta_words, nwin_base, end_base = PB._ABIS[abi]
    planes = _garbage_bulk(rng, 2, nblk, meta_words, nwin_base, end_base)
    kw = dict(out_rows=3 * PB.WIN_ROWS, max_win=3)
    got = _bulk_decode(abi, nblk, planes, "cuda", **kw)
    ref = _bulk_decode(abi, nblk, planes, "cpu", **kw)
    assert torch.equal(got.cpu(), ref)
    assert ref.any()


@pytest.mark.parametrize("case", list(BULK_CASES))
def test_bulk_kernel_hand_built_streams_match_plain(native, case):
    """Entries whose records overlap, through each ABI's case
    (``gang_streams.BULK_CASES``): the kernel applies an entry's units in
    the plain version's order and gives its words exactly."""
    abi, nblk, *planes, _ = bulk_hand_planes(case)
    got = _bulk_decode(abi, nblk, planes, "cuda", max_win=1)
    ref = _bulk_decode(abi, nblk, planes, "cpu", max_win=1)
    assert torch.equal(got.cpu(), ref)
    assert ref.any()


@pytest.mark.parametrize("case", [c for c, (abi, _, _) in BULK_CASES.items()
                                  if abi == "bulk"])
def test_assemble_kernel_hand_built_streams_match_plain(native, case):
    """The single-stream overlap cases through the assemble entry, their
    literal rows as the input plane's first rows beside a random side
    plane: the kernel gives its plain version's words exactly."""
    _, _, lit, rec, meta, _ = bulk_hand_planes(case)
    rng = np.random.default_rng(72)
    planes = [np.zeros((1, rows, 128), np.int32) for rows in
              (PE.IN_ROWS, PEB.SIDE_ROWS, PEB.REC_ROWS)]
    planes[0][:, :lit.shape[1]] = lit
    planes[1][:] = rng.integers(-2**31, 2**31, planes[1].shape,
                                dtype=np.int32)
    planes[2][:, :rec.shape[1]] = rec
    planes.append(meta)
    before = PEB.launches["assemble"]
    got = PEB.assemble_batch(*planes_to_torch(*planes, device="cuda"))
    torch.cuda.synchronize()
    assert PEB.launches["assemble"] == before + 1
    ref = PEB.assemble_batch(*planes_to_torch(*planes, device="cpu"))
    assert torch.equal(got.cpu(), ref)
    assert ref.any()


@pytest.mark.parametrize("impl, kernel", [("pallas", "decode_tokens"),
                                          ("bulk", "decode_bulk"),
                                          ("stream", "decode_stream")])
@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_decode_kernels_corrupt_containers_match_plain(native, case, impl,
                                                       kernel):
    """The corrupt containers on which the port differs from the JAX
    routes (``gang_streams.CORRUPT``): the token, bulk and stream kernels
    give their plain versions' bytes exactly."""
    _, stream = corrupt_container(case, native)
    counts = {"decode_tokens": lambda: PT.launches,
              "decode_bulk": lambda: PB.launches["bulk"],
              "decode_stream": lambda: PS.launches}[kernel]
    before = counts()
    got = pipeline.decompress(stream, device="cuda", impl=impl)
    assert counts() > before
    assert got == pipeline.decompress(stream, device="cpu", impl=impl)


@pytest.mark.parametrize("impl", ["bulk", "bulk2", "bulkn"])
def test_bulk_routes_match_native(native, impl):
    """Each bulk route on a container of two full blocks and a short one,
    with and without a dictionary (the full blocks take three windows)."""
    d = synthetic_text(33_000, seed=113)
    data = synthetic_text(2 * (1 << 22) + 70_000, seed=117)
    for dictionary in (None, d):
        stream = (native.compress_dict(data, d, True) if dictionary
                  else native.compress(data, True, level=1))
        PB.launches.update(dict.fromkeys(PB.launches, 0))
        got = pipeline.decompress(stream, device="cuda", impl=impl,
                                  dictionary=dictionary)
        assert got == data
        assert sum(PB.launches.values()) == 1


def _encode_planes(native, blocks, d=b""):
    """Input, candidate and meta planes of a batch (numpy)."""
    return [np.stack([PE.pack_input_words(d + b) for b in blocks]),
            np.stack([PE.pack_cand_words(native.build_candidates(d + b))
                      for b in blocks]),
            PE.pack_meta([len(b) for b in blocks], len(d))]


def _encode_blocks():
    rng = np.random.default_rng(3)
    alt = b"".join(rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
                   + b"QWERTYUI" for _ in range(1200))
    return [make() for make, _ in _MIXED] + [alt, b"abcab", b""]


def _want(native, blk, ext, d=b""):
    cand = native.build_candidates(d + blk)
    if d:
        return native.encode_block_dict(blk, d, cand, ext)
    return native.encode_block_candidates(blk, cand, ext)


@pytest.mark.parametrize("ext", [True, False])
def test_decide_and_assemble_kernels_match_plain(native, ext):
    """The decide kernel's side plane, record stream and osz, and the
    assemble kernel's payload planes, equal their plain versions word for
    word; the payloads equal the native core's, with and without a
    dictionary base."""
    for d, blocks in ((b"", _encode_blocks()),
                      (synthetic_text(33_000, seed=113),
                       [synthetic_text(50_000, seed=114), bytes(3_000)])):
        host = planes_to_torch(*_encode_planes(native, blocks, d),
                               device="cpu")
        host.insert(2, PEB.next_valid(host[1]))
        dev = [t.cuda() for t in host]
        before = dict(PEB.launches)
        got = PEB.decide_batch(*dev, ext=ext)
        pay = PEB.assemble_batch(dev[0], *got)
        torch.cuda.synchronize()
        assert PEB.launches == {k: n + 1 for k, n in before.items()}
        ref = PEB.decide_batch(*host, ext=ext)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)
        assert torch.equal(pay.cpu(), PEB.assemble_batch(host[0], *ref))
        assert not ref[2][:, 2].any()
        for k, b in enumerate(blocks):
            payload = PE.payload_from_words(pay[k], int(ref[2][k, 0]))
            if b:
                assert payload == _want(native, b, ext, d), f"block {k}"


@pytest.mark.parametrize("ext, nblk", [(True, 1), (False, 1), (True, 2)])
def test_flat_decide_kernel_matches_plain(native, ext, nblk):
    """The flat decide kernel's descriptors and stats equal its plain
    version's; the flat emitter's payloads on the card equal the native
    core's."""
    blocks = _encode_blocks()[:-1]
    host = planes_to_torch(*_encode_planes(native, blocks), device="cpu")
    host.insert(2, PEB.next_valid(host[1]))
    dev = [t.cuda() for t in host]
    before = PEF.launches
    desc, stats = PEF.flat_decide_batch(*dev, ext=ext, nblk=nblk)
    torch.cuda.synchronize()
    assert PEF.launches == before + 1
    rdesc, rstats = PEF.flat_decide_batch(*host, ext=ext, nblk=nblk)
    assert torch.equal(desc.cpu(), rdesc) and torch.equal(stats.cpu(), rstats)
    words, osz = PEF.flat_emit_batch(dev[0], dev[1], dev[3], ext=ext,
                                     nblk=nblk)
    osz = osz.cpu()
    assert not osz[:, 2].any()
    for k, b in enumerate(blocks):
        payload = PE.payload_from_words(words[k], int(osz[k, 0]))
        assert payload == _want(native, b, ext), f"block {k}"


def test_encode_kernels_garbage_planes_match_plain(native):
    """Garbage candidates and skip tables, a meta past the planes and a
    descriptor plane too small: the decide, assemble and flat decide
    kernels stay inside their planes and equal their plain versions."""
    rng = np.random.default_rng(9)
    blocks = [synthetic_text(20_000, seed=45), b"xyzxyzxyz" * 50, b"q" * 100]
    host = planes_to_torch(*_encode_planes(native, blocks), device="cpu")
    host[1][0] = torch.from_numpy(rng.integers(
        -1, 40_000, host[1][0].numel(), dtype=np.int32)).view(
            host[1][0].shape)
    host[1][1].view(-1)[100:200] = torch.arange(100, 200, dtype=torch.int32)
    host[2][2, 0] = (1 << 22) + 1
    host.insert(2, PEB.next_valid(host[1]))
    host[2][1].view(-1)[:300] = torch.from_numpy(
        rng.integers(-5, 400, 300, dtype=np.int32))
    dev = [t.cuda() for t in host]
    got = PEB.decide_batch(*dev)
    ref = PEB.decide_batch(*host)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert ref[2][2, :3].tolist() == [-1, 0, 1]
    assert torch.equal(PEB.assemble_batch(dev[0], *got).cpu(),
                       PEB.assemble_batch(host[0], *ref))
    for rows in (8, PEF.DESC_ROWS):
        got = PEF.flat_decide_batch(*dev, desc_rows=rows)
        ref = PEF.flat_decide_batch(*host, desc_rows=rows)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)


def _decide_kernels_match(native, blocks, ext):
    """Both decide kernels on ``blocks`` against their plain versions,
    word for word; the assembled and laid-out payloads against the native
    core."""
    host = planes_to_torch(*_encode_planes(native, blocks), device="cpu")
    host.insert(2, PEB.next_valid(host[1]))
    dev = [t.cuda() for t in host]
    got = PEB.decide_batch(*dev, ext=ext)
    desc, stats = PEF.flat_decide_batch(*dev, ext=ext)
    ref = PEB.decide_batch(*host, ext=ext)
    for name, g, r in zip(("side", "rec", "osz"), got, ref):
        assert torch.equal(g.cpu(), r), name
    rdesc, rstats = PEF.flat_decide_batch(*host, ext=ext)
    assert torch.equal(desc.cpu(), rdesc) and torch.equal(stats.cpu(), rstats)
    pay = PEB.assemble_batch(dev[0], *got)
    words, fosz = PEF.layout_live(desc, stats, dev[0], dev[3], ext=ext)
    osz, fosz = ref[2], fosz.cpu()
    for k, b in enumerate(blocks):
        want = _want(native, b, ext)
        assert PE.payload_from_words(pay[k], int(osz[k, 0])) == want, k
        assert PE.payload_from_words(words[k], int(fosz[k, 0])) == want, k


@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_decide_kernels_class_blocks(native, full_class_blocks, cls):
    """One full 4 MiB block of each class of ``chip_smoke.py``'s input,
    ext on and off: the decide and flat decide kernels equal their plain
    versions, and their payloads the native core's."""
    for ext in (True, False):
        _decide_kernels_match(native, [full_class_blocks[cls]], ext)


@pytest.mark.parametrize("ext", [True, False])
def test_decide_kernels_open_slot_blocks(native, ext):
    """Blocks that end with the ctrl and size slots open below the
    literal high-water mark: the warp sink's dead values, loaded at the
    end only, are the plain version's."""
    _decide_kernels_match(native, open_slot_blocks(), ext)


@pytest.mark.parametrize("emit_impl", ["bulk", "flat"])
def test_emitter_routes_match_native(native, emit_impl):
    """``compress(emit_impl=...)`` on the card: two full blocks and a
    short one at level 1, and with a dictionary, equal to the native
    core's containers; the route's kernels launched."""
    import turbosqueeze_tpu_torch as tsq

    data = b"".join(make() for make, _ in _MIXED) * 20 + b"tail" * 999
    d = synthetic_text(33_000, seed=113)
    for dictionary in (None, d):
        PEB.launches.update(dict.fromkeys(PEB.launches, 0))
        PEF.launches = 0
        got = pipeline.compress(data, device="cuda", emit_impl=emit_impl,
                                dictionary=dictionary)
        want = (native.compress_dict(data, d, True) if dictionary
                else native.compress(data, True, level=1))
        assert got == want
        if emit_impl == "bulk":
            assert PEB.launches == {"decide": 1, "assemble": 1}
        else:
            assert PEF.launches == 1
    assert tsq.decompress(got, backend="cuda", dictionary=d) == data


# --- TSQX, decompress_to_file, the CLI and the job engine ---------------------

_TSQX_DATA = (lambda: synthetic_text(200_000, seed=131) + bytes(4 << 20)
              + synthetic_binary(90_000, seed=132))


@pytest.mark.parametrize("nblk", [1, 4, 8])
def test_tsqx_decodes_on_the_card(native, nblk):
    from turbosqueeze_tpu_torch import tsqx
    from turbosqueeze_tpu_torch.runtime import api

    data = _TSQX_DATA()
    packed = tsqx.pack(native.compress(data, True, level=1), nblk=nblk)
    before = PG.launches
    assert tsqx.decompress(packed) == data
    assert api.decompress(packed) == data
    assert PG.launches >= before + 2
    view = tsqx.TsqxView(packed)
    result, sizes = tsqx.decode_to_words(view, device="cuda:0",
                                         groups=slice(0, 1))
    [shard] = result.shards
    words = shard.data
    assert words.device.type == "cuda" and len(sizes) == nblk
    assert result.shape[0] == nblk and shard.index == slice(0, nblk)
    ref = PG._decode_gang_plain(
        *(torch.from_numpy(a.copy()) for a in (
            view.lit_words[:nblk], view.gang_words[:1], view.gmeta[:1])),
        nblk=nblk, out_rows=PT.OUT_ROWS, max_win=PB.MAX_WIN,
        slot_recs=view.slot_recs)
    assert torch.equal(words.cpu(), ref)


@pytest.mark.parametrize("impl", pipeline._FILE_IMPLS)
def test_decompress_to_file_on_the_card(native, impl, tmp_path):
    data = _TSQX_DATA()
    d = synthetic_text(9_000, seed=133)
    out = tmp_path / "out"
    for stream, dictionary in ((native.compress(data, True, level=1), None),
                               (native.compress_dict(data, d, True), d)):
        assert pipeline.decompress_to_file(
            stream, out, impl=impl, window_blocks=1,
            dictionary=dictionary) == len(data)
        assert out.read_bytes() == data


def test_cli_and_jobs_on_the_card(native, tmp_path):
    from turbosqueeze_tpu_torch.cli import main
    from turbosqueeze_tpu_torch.runtime.jobs import JobEngine

    data = _TSQX_DATA()
    src, tsq, tsqx_f = (tmp_path / "in", tmp_path / "a.tsq",
                        tmp_path / "a.tsqx")
    src.write_bytes(data)
    assert main(["c", "--level", "1", str(src), str(tsq)]) == 0
    assert tsq.read_bytes() == native.compress(data, True, level=1)
    assert main(["x", str(tsq), str(tsqx_f)]) == 0
    for f in (tsq, tsqx_f):
        assert main(["d", str(f), str(tmp_path / "out")]) == 0
        assert (tmp_path / "out").read_bytes() == data
    assert main(["verify", str(src), str(tsq)]) == 0
    parts = [data[i::4] for i in range(4)]
    with JobEngine(n_workers=4) as eng:
        streams = [j.result(300) for j in [eng.submit_compress(
            x, level=i % 2) for i, x in enumerate(parts)]]
        backs = [j.result(300) for j in [eng.submit_decompress(s)
                                         for s in streams]]
    for i, (x, s, y) in enumerate(zip(parts, streams, backs)):
        assert s == native.compress(x, level=i % 2) and y == x


_TWO = ["cuda:0", "cuda:0"]  # two shards of every window on one card


def test_two_shards_on_one_card(native):
    """decompress (gang), compress (level 1) and TSQX with each window
    split into two shards on cuda:0: the two blocks a shard each (TSQX at
    nblk 4: one group, the second shard empty)."""
    from turbosqueeze_tpu_torch import tsqx

    data = _TSQX_DATA()
    stream = native.compress(data, True, level=1)
    before = PG.launches
    assert pipeline.decompress(stream, device=_TWO, impl="gang",
                               window_blocks=2) == data
    assert PG.launches == before + 2
    assert pipeline.compress(data, level=1, device=_TWO,
                             window_blocks=2) == stream
    for nblk in (1, 4):
        assert tsqx.decompress(tsqx.pack(stream, nblk=nblk),
                               device=_TWO) == data


@pytest.mark.parametrize("case", ["pallas", "stream", "tsqx"])
def test_words_shards_on_one_card(native, case):
    """The device-resident decodes over two shards on cuda:0: the two
    blocks one a shard (TSQX at nblk 1: one group a shard), each shard's
    words on the card and equal to the input."""
    from turbosqueeze_tpu_torch import tsqx

    data = _TSQX_DATA()
    stream = native.compress(data, True, level=1)
    if case == "tsqx":
        words, sizes = tsqx.decode_to_words(
            tsqx.TsqxView(tsqx.pack(stream, nblk=1)), device=_TWO)
    else:
        words, sizes, _ = pipeline.decompress_to_words(stream, device=_TWO,
                                                       impl=case)
    assert words.shape == (2, PT.OUT_ROWS, 128) and len(sizes) == 2
    assert [sh.index for sh in words.shards] == [slice(0, 1), slice(1, 2)]
    assert all(sh.data.device == torch.device("cuda", 0)
               for sh in words.shards)
    assert b"".join(_words_bytes(sh.data, 0, 0, n)
                    for sh, n in zip(words.shards, sizes)) == data
