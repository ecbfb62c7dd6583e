"""The gang route's plane packing (``kernels/decode_gang.py::prep_gang``):
the pool writes every plane byte once, straight into the host tensors the
upload reads. Each case holds the planes byte for byte against the plain
packing of the same resolved blocks, kept here as the reference: a zeroed
plane, each block's literals and each group's records copied into it
through a zeroed row of their own, the merge's meta words as they are."""

import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu_torch.format import scan_block_table
from turbosqueeze_tpu_torch.kernels import decode_bulk as DBK
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
from turbosqueeze_tpu_torch.parallel import pipeline
from turbosqueeze_tpu_torch.parallel.mesh import pad_batch
from turbosqueeze_tpu_torch.utils.corpus import synthetic_binary, synthetic_text

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import port_core  # noqa: E402

from gpubench.gen import text_standin  # noqa: E402

BLOCK = 4 << 20
LAST = 1_755_648  # the last block of the 10^9-byte tsq b input


@pytest.fixture(scope="module")
def native():
    return port_core()


@pytest.fixture(scope="module")
def standin(native):
    """One gang window of the benchmark's level-0 text: 31 full blocks and
    the short last block."""
    data = text_standin.generate(2020, n_bytes=31 * BLOCK + LAST)
    return data, native.compress(data, True, level=0)


def _payloads(stream):
    _, table = scan_block_table(stream)
    return [(stream[off:off + psz], ext) for off, psz, ext in table]


def _plain_planes(native, payloads, nblk, slot_recs, dictionary=None):
    """The planes as the plain packing gives them: (lit, gang, gmeta,
    sizes) numpy."""
    preps = DBK.resolve_blocks(payloads, map, dictionary)
    sizes = [int(p[2][0]) for p in preps]
    preps += [DBK.EMPTY_PREP] * (pad_batch(len(preps), nblk) - len(preps))
    G = len(preps) // nblk
    merged = [native.bulk_gang([p[1] for p in preps[nblk * g:nblk * (g + 1)]],
                               [p[2] for p in preps[nblk * g:nblk * (g + 1)]],
                               slot_recs) for g in range(G)]
    lit_rows = max(DBK.rows_for_bytes(len(p[0])) for p in preps)
    rec_rows = max(DBK.rows_for_bytes(4 * len(m[0])) for m in merged)
    lit = np.zeros((len(preps), lit_rows, 128), np.int32)
    gang = np.zeros((G, rec_rows, 128), np.int32)
    gmeta = np.zeros((G, PG.GMETA_WORDS), np.int32)
    for b, p in enumerate(preps):
        lit[b] = DBK.pack_lit_words(p[0], lit_rows)
    for g, (rec, m) in enumerate(merged):
        gang[g] = DBK.pack_rec_words(rec, rec_rows)
        gmeta[g] = m.view(np.int32)
    return lit, gang, gmeta, sizes


def _pooled(payloads, nblk, slot_recs, dictionary=None):
    with ThreadPoolExecutor() as pool:
        return PG.prep_gang(payloads, nblk, slot_recs, map_fn=pool.map,
                            dictionary=dictionary)


def _assert_same(planes, want):
    assert planes[3] == want[3]
    for got, ref in zip(planes[:3], want[:3]):
        assert isinstance(got, torch.Tensor) and got.is_contiguous()
        assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
        assert np.array_equal(got.numpy(), ref)


def test_standin_window_packs_as_the_plain_packing(native, standin):
    _, stream = standin
    pe = _payloads(stream)
    assert len(pe) == pipeline.WINDOW_BLOCKS
    srecs = pipeline.GANG_SRECS[pipeline.GANG_NBLK]
    planes = _pooled(pe, pipeline.GANG_NBLK, srecs)
    assert planes[3] == [BLOCK] * 31 + [LAST]
    _assert_same(planes, _plain_planes(native, pe, pipeline.GANG_NBLK,
                                       srecs))


def _mixed_payloads(native):
    """Five blocks of other sizes, classes and levels, so that nblk 2 and 4
    pad the last group with empty blocks."""
    datas = [synthetic_text(90_000, seed=41), bytes(40_000),
             synthetic_binary(60_000, seed=43),
             np.random.default_rng(7).bytes(40_000),
             synthetic_text(300_000, seed=44)]
    return [(native.compress(d, True, level=lv)[19:], True)
            for d, lv in zip(datas, (0, 1, 2, 1, 0))]


@pytest.mark.parametrize("nblk, slot_recs", [(1, 8), (2, 16), (4, 16)])
def test_groups_with_padding_blocks_pack_as_the_plain_packing(
        native, nblk, slot_recs):
    pe = _mixed_payloads(native)
    planes = _pooled(pe, nblk, slot_recs)
    assert planes[0].shape[0] == pad_batch(len(pe), nblk)
    _assert_same(planes, _plain_planes(native, pe, nblk, slot_recs))


def test_dictionary_window_packs_as_the_plain_packing(native):
    """A 40,000-byte dictionary: the first block reaches into a third
    2 MiB window of the dict-extended space."""
    d = synthetic_text(40_000, seed=120)
    data = synthetic_text(BLOCK + 50_000, seed=121)
    stream = native.compress_dict(data, d, True)
    pe = _payloads(stream)
    planes = _pooled(pe, 1, 8, dictionary=d)
    assert planes[2][0, 8] == 3
    _assert_same(planes, _plain_planes(native, pe, 1, 8, dictionary=d))


def test_small_window_after_a_large_one_zeroes_recycled_memory(
        native, standin, monkeypatch):
    """A pinned block the host allocator recycles holds the bytes of the
    window it carried last: a small window packed into the standin
    window's own planes gives the plain planes, every padding byte 0."""
    _, stream = standin
    srecs = pipeline.GANG_SRECS[pipeline.GANG_NBLK]
    large = _pooled(_payloads(stream), pipeline.GANG_NBLK, srecs)[:3]
    before = [t.clone() for t in large]
    recycled = iter(large)
    empty = torch.empty

    def recycling_empty(shape, *, dtype, pin_memory):
        old = next(recycled)
        assert dtype == old.dtype and math.prod(shape) <= old.numel()
        return old.view(-1)[:math.prod(shape)].view(shape)

    pe = _mixed_payloads(native)
    want = _plain_planes(native, pe, 2, 16)
    monkeypatch.setattr(torch, "empty", recycling_empty)
    planes = _pooled(pe, 2, 16)
    monkeypatch.setattr(torch, "empty", empty)
    _assert_same(planes, want)
    for got, mem in zip(planes[:3], large):
        assert got.data_ptr() == mem.data_ptr()
    for got, old in zip(planes[:2], before):
        # the memory held the large window's bytes where the small one pads
        held = old.view(-1)[:got.numel()].numpy()
        assert (held[got.view(-1).numpy() == 0] != 0).any()
    lit = planes[0].numpy().view(np.uint8).reshape(len(want[0]), -1)
    for b, p in enumerate(DBK.resolve_blocks(pe, map)):
        assert not lit[b, len(p[0]):].any(), f"block {b}'s padding"
    assert not lit[len(pe):].any()  # the padding block


def test_packed_planes_go_to_the_cpu_as_they_are(native):
    planes = _pooled(_mixed_payloads(native), 2, 16)[:3]
    staged = planes_to_torch(*planes, device="cpu")
    assert [t.data_ptr() for t in staged] == [t.data_ptr() for t in planes]
    with pytest.raises(TypeError, match="int32 or uint32"):
        planes_to_torch(planes[0].long(), device="cpu")


def test_gang_route_decodes_the_standin(native):
    data = text_standin.generate(2021, n_bytes=BLOCK + 60_000)
    stream = native.compress(data, True, level=0)
    assert pipeline.decompress(stream, device="cpu", impl="gang") == data
