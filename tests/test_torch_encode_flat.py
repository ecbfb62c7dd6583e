"""The port's flat emitter (turbosqueeze_tpu_torch/kernels/encode_flat.py)
on the CPU: the torch ``layout_batch`` held against the JAX package's
``layout_batch`` on ``descs_from_tokens`` streams, the flat decide pass's
plain version against the Pallas kernel (interpret mode) at ``nblk`` 1
and 2, and the composed emitter against the native core. Tolerance zero:
the layout's words and osz, and the descriptors below ``n_sym`` with the
stats row."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import encode_bulk as RB
from turbosqueeze_tpu.kernels import encode_emit as RE
from turbosqueeze_tpu.kernels import encode_flat as RF
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import encode_bulk as PB
from turbosqueeze_tpu_torch.kernels import encode_emit as PE
from turbosqueeze_tpu_torch.kernels import encode_flat as PF
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_encode_emit import (  # noqa: E402
    _dead_size_slot_case, _window_edge_case)
from test_torch_host_copies import port_core  # noqa: E402

_DESC_ROWS = 128     # descriptor planes of the batched cases
_IN_ROWS = 136       # input rows the layout cases need (65.9 KB + 16)


@pytest.fixture(scope="module")
def native():
    return port_core()


def _alternation(n):
    rng = np.random.default_rng(3)
    return b"".join(rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
                    + b"QWERTYUI" for _ in range(n))


def _blocks():
    """name -> block: the cases of the JAX package's layout tests."""
    rng = np.random.default_rng(7)
    text = synthetic_text(2_000, seed=40)
    return {"text": synthetic_text(40_000, seed=31), "zeros": bytes(20_000),
            "random": rng.bytes(16_384),
            **{f"tiny{n}": text[:n] for n in (1, 2, 3, 5, 8, 17, 33, 64, 513,
                                               1025)},
            "alternation": _alternation(600),
            **{f"window_edge{q}": _window_edge_case(q)
               for q in (65_500, 65_534, 65_560)},
            "fills": synthetic_text(3_000, seed=45) + bytes(9_000)
            + synthetic_text(2_000, seed=46)}


_NAMES = list(_blocks())


@pytest.fixture(scope="module", params=[True, False], ids=["ext", "noext"])
def layouts(request, native):
    """Every case's descriptors (from the native payload) through the JAX
    layout and the port's, one batch each."""
    ext = request.param
    blocks = list(_blocks().values())
    wants = [native.encode_block_candidates(b, native.build_candidates(b),
                                            ext) for b in blocks]
    descs = [RF.descs_from_tokens(w, ext) for w in wants]
    dw = np.stack([RF.pack_desc_words(d, _DESC_ROWS) for d in descs])
    nsym = np.array([len(d) for d in descs], np.int32)
    iw = np.stack([RE.pack_input_words(b)[:_IN_ROWS] for b in blocks])
    meta = PE.pack_meta([len(b) for b in blocks])
    out_rows = 200  # J must not pass the JAX sort's length
    ref = RF.layout_batch(jnp.asarray(dw), jnp.asarray(nsym), jnp.asarray(iw),
                          jnp.asarray(meta), ext=ext, out_rows=out_rows)
    got = PF.layout_batch(*planes_to_torch(dw, nsym, iw, meta, device="cpu"),
                          ext=ext, out_rows=out_rows)
    return ext, blocks, wants, descs, [np.asarray(a) for a in ref], got


@pytest.mark.parametrize("case", _NAMES)
def test_layout_matches_jax(layouts, case):
    """The torch layout's words and osz equal the JAX layout's, and the
    payload equals the native core's."""
    ext, blocks, wants, descs, (rw, rosz), (pw, posz) = layouts
    b = _NAMES.index(case)
    assert np.array_equal(pw[b].numpy(), rw[b])
    assert np.array_equal(posz[b].numpy(), rosz[b])
    assert PE.payload_from_words(pw[b], int(posz[b, 0])) == wants[b]
    assert np.array_equal(PF.descs_from_tokens(wants[b], ext), descs[b])


def test_layout_dead_slot_sizes(native):
    """Sizes around group boundaries, so that n_sym % 8 and % 2 reach every
    trailing-slot shape (dead ctrl, dead size, padded groups): the torch
    layout against the native payloads."""
    text = synthetic_text(4_096, seed=44)
    blocks = [text[:sz] for sz in range(900, 964)]
    wants = [native.encode_block_candidates(b, native.build_candidates(b),
                                            True) for b in blocks]
    descs = [PF.descs_from_tokens(w, True) for w in wants]
    words, osz = PF.layout_batch(*planes_to_torch(
        np.stack([PF.pack_desc_words(d, 8) for d in descs]),
        np.array([len(d) for d in descs], np.int32),
        np.stack([PE.pack_input_words(b)[:8] for b in blocks]),
        PE.pack_meta([len(b) for b in blocks]), device="cpu"), out_rows=8)
    assert not osz[:, 2].any()
    for b, want in enumerate(wants):
        assert PE.payload_from_words(words[b], int(osz[b, 0])) == want, b


def test_layout_block_dictionary(native):
    """``layout_block`` with a dictionary base against the native
    dictionary emission."""
    d = synthetic_text(30_000, seed=34)
    blk = synthetic_text(8_000, seed=34)[4_000:] + bytes(2_000)
    want = native.encode_block_dict(blk, d, native.build_candidates(d + blk),
                                    True)
    # the tokenizer cannot read a dictionary payload: the descriptors come
    # from the decide pass
    t = planes_to_torch(*_decide_planes(native, [(blk, d)]), device="cpu")
    desc, stats = PF.flat_decide_batch(t[0], t[1], PB.next_valid(t[1]), t[2])
    got = PF.layout_block(d + blk, desc.reshape(-1)[:int(stats[0, 0])]
                          .numpy(), base=len(d), device="cpu")
    assert got == want


def _decide_cases():
    """(block, dictionary prefix) pairs for the flat decide pass; an even
    count, for nblk = 2."""
    cases = [(b, b"") for b in _blocks().values()]
    cases += [(b, b"") for b in list(_dead_size_slot_case())[:4]]
    cases += [(synthetic_text(8_000, seed=34)[4_000:] + bytes(2_000),
               synthetic_text(30_000, seed=34)), (b"", b"")]
    return cases[:len(cases) // 2 * 2]


def _decide_planes(native, cases):
    return [np.stack([RE.pack_input_words(d + b) for b, d in cases]),
            np.stack([RE.pack_cand_words(native.build_candidates(d + b))
                      for b, d in cases]),
            np.stack([PE.pack_meta([len(b)], len(d))[0] for b, d in cases])]


@pytest.mark.parametrize("ext, nblk", [(True, 1), (False, 1), (True, 2)])
def test_flat_decide_matches_jax_kernel(native, ext, nblk):
    """Descriptors below n_sym and the stats row equal the Pallas
    kernel's (interpreted), at nblk 1 and 2."""
    cases = _decide_cases()
    iw, cw, meta = _decide_planes(native, cases)
    desc, stats = RF.flat_decide_batch(
        jnp.asarray(iw), jnp.asarray(cw), RB.next_valid(jnp.asarray(cw)),
        jnp.asarray(meta), ext=ext, nblk=nblk, desc_rows=_DESC_ROWS,
        interpret=True)
    desc, stats = np.asarray(desc), np.asarray(stats)
    t = planes_to_torch(iw, cw, meta, device="cpu")
    pdesc, pstats = PF.flat_decide_batch(t[0], t[1], PB.next_valid(t[1]),
                                         t[2], ext=ext, nblk=nblk,
                                         desc_rows=_DESC_ROWS)
    assert np.array_equal(pstats[:, :2].numpy(), stats[:, :2])
    assert not pstats[:, 2:].any() and not stats[:, 1].any()
    for b in range(len(cases)):
        n = stats[b, 0]
        assert np.array_equal(pdesc[b].reshape(-1)[:n].numpy(),
                              desc[b].reshape(-1)[:n]), b
        assert not pdesc[b].reshape(-1)[n:].any()


def test_flat_decide_overflow_matches_jax_kernel(native):
    """A descriptor plane too small: both flag the overflow, and their
    descriptors agree up to the plane's capacity less 8 rows."""
    blk = synthetic_text(12_000, seed=31)
    iw, cw, meta = _decide_planes(native, [(blk, b"")])
    _, stats = RF.flat_decide_batch(
        jnp.asarray(iw), jnp.asarray(cw), RB.next_valid(jnp.asarray(cw)),
        jnp.asarray(meta), desc_rows=16, interpret=True)
    t = planes_to_torch(iw, cw, meta, device="cpu")
    pdesc, pstats = PF.flat_decide_batch(t[0], t[1], PB.next_valid(t[1]),
                                         t[2], desc_rows=16)
    full, _ = PF.flat_decide_batch(t[0], t[1], PB.next_valid(t[1]), t[2])
    assert int(np.asarray(stats)[0, 1]) == int(pstats[0, 1]) == 1
    assert torch.equal(pdesc.reshape(-1), full.reshape(-1)[:16 * 128])
    assert int(pstats[0, 0]) > 8 * 128


@pytest.mark.parametrize("blk", [
    synthetic_text(300_000, seed=51) + bytes(60_000)
    + synthetic_binary(200_000, seed=52),
    np.random.default_rng(12).bytes((1 << 21) + 5_000)],
    ids=["mixed", "two_windows"])
def test_flat_emit_block_matches_native(native, blk):
    cand = native.build_candidates(blk)
    for ext in (True, False):
        got, ovf = PF.flat_emit_block(blk, cand, ext=ext, device="cpu")
        assert ovf == 0
        assert got == native.encode_block_candidates(blk, cand, ext)


def test_flat_emit_batch_pairs_match_single(native):
    """nblk = 2 over two blocks gives each block's nblk = 1 payload; the
    layout's sub-batches and live slices change no byte."""
    blocks = [synthetic_text(12_000, seed=61),
              synthetic_text(12_000, seed=62)[:9_000] + bytes(800),
              bytes(30_000)]
    iw, cw, meta = planes_to_torch(*_decide_planes(
        native, [(b, b"") for b in blocks[:2]]), device="cpu")
    words, osz = PF.flat_emit_batch(iw, cw, meta, nblk=2)
    for b, blk in enumerate(blocks[:2]):
        single, ovf = PF.flat_emit_block(blk, native.build_candidates(blk),
                                         device="cpu")
        assert ovf == 0 == int(osz[b, 2])
        assert PE.payload_from_words(words[b], int(osz[b, 0])) == single
    with pytest.raises(ValueError, match="B % nblk"):
        PF.flat_emit_batch(iw[:1], cw[:1], meta[:1], nblk=2)
    # three blocks in sub-batches of one: the same words as one batch
    iw, cw, meta = planes_to_torch(*_decide_planes(
        native, [(b, b"") for b in blocks]), device="cpu")
    whole = PF.flat_emit_batch(iw, cw, meta)
    old = PF.LAYOUT_BLOCKS
    try:
        PF.LAYOUT_BLOCKS = 1
        split = PF.flat_emit_batch(iw, cw, meta)
    finally:
        PF.LAYOUT_BLOCKS = old
    assert all(torch.equal(a, b) for a, b in zip(whole, split))


def test_host_glue_matches_reference(native):
    blk = synthetic_text(5_000, seed=63)
    payload = native.encode_block_candidates(blk, native.build_candidates(blk),
                                             True)
    desc = RF.descs_from_tokens(payload, True)
    assert np.array_equal(PF.descs_from_tokens(payload, True), desc)
    assert np.array_equal(PF.pack_desc_words(desc, 16),
                          RF.pack_desc_words(desc, 16))
    assert PF.layout_block(blk, desc, device="cpu") == payload


def test_wrapper_checks(native):
    iw, cw, meta = planes_to_torch(*_decide_planes(
        native, [(b"hello hello", b"")]), device="cpu")
    nv = PB.next_valid(cw)
    with pytest.raises(ValueError, match="int32"):
        PF.flat_decide_batch(iw, cw.to(torch.int64), nv, meta)
    with pytest.raises(ValueError, match="desc_rows"):
        PF.flat_decide_batch(iw, cw, nv, meta, desc_rows=12)
    with pytest.raises(ValueError, match="cand_words is on meta"):
        PF.flat_decide_batch(iw, cw.to("meta"), nv, meta)
    before = PF.launches
    PF.flat_emit_batch(iw, cw, meta)
    assert PF.launches == before  # CPU: the plain version, no launch
