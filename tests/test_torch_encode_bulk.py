"""The port's two-pass emitter (turbosqueeze_tpu_torch/kernels/
encode_bulk.py) on the CPU, where ``decide_batch`` and ``assemble_batch``
run their plain versions: held against the JAX package's Pallas kernels
(interpret mode) and the native core's emission. Tolerance zero over what
the reference defines: ``osz`` (its words 0-2 and 5-7), the record words
below ``osz[b, 7]``, the side bytes that a record reads, and each
payload's first ``osz[b, 0]`` bytes.

Interpreting the JAX kernels costs a compile per batch shape, and a large
batch runs slowly there, so a module-scoped fixture runs every case alone,
at one shape, once per ``ext``."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import encode_bulk as RB
from turbosqueeze_tpu.kernels import encode_emit as RE
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import encode_bulk as PB
from turbosqueeze_tpu_torch.kernels import encode_emit as PE
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_encode_emit import (  # noqa: E402
    _dead_size_slot_case, _window_edge_case)
from test_torch_host_copies import port_core  # noqa: E402

_DICT = synthetic_text(30_000, seed=34)
_OSZ_WORDS = [0, 1, 2, 5, 6, 7]  # words 3-4 are not written by the kernel


@pytest.fixture(scope="module")
def native():
    return port_core()


def _alternation(n):
    """1-literal/1-match alternation: more than 120 records in one row."""
    rng = np.random.default_rng(3)
    return b"".join(rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
                    + b"QWERTYUI" for _ in range(n))


def _cases():
    """name -> (block, dictionary prefix)."""
    rng = np.random.default_rng(7)
    text = synthetic_text(2_000, seed=40)
    cases = {"zeros": bytes(20_000), "random": rng.bytes(16_384),
             "text": synthetic_text(12_000, seed=31),
             "alternation": _alternation(400), "empty": b"",
             **{f"tiny{n}": text[:n] for n in (1, 3, 5, 17, 33, 513)},
             **{f"dead_slot{k}": b for k, b in
                enumerate(list(_dead_size_slot_case())[:6])},
             **{f"window_edge{q}": _window_edge_case(q)
                for q in (65_500, 65_534, 65_560)}}
    cases = {k: (v, b"") for k, v in cases.items()}
    cases["dictionary"] = (synthetic_text(8_000, seed=34)[4_000:]
                           + bytes(2_000), _DICT)
    return cases


_NAMES = list(_cases())


def _planes(native, cases):
    """Input, candidate and meta planes (numpy) of (block, prefix) pairs."""
    return [np.stack([RE.pack_input_words(d + b) for b, d in cases]),
            np.stack([RE.pack_cand_words(native.build_candidates(d + b))
                      for b, d in cases]),
            np.stack([PE.pack_meta([len(b)], len(d))[0] for b, d in cases])]


@pytest.fixture(scope="module", params=[True, False], ids=["ext", "noext"])
def runs(request, native):
    """Every case through the JAX kernels (interpreted) and the port's
    plain versions, one batch each."""
    ext = request.param
    cases = list(_cases().values())
    iw, cw, meta = _planes(native, cases)
    outs = []
    for b in range(len(cases)):
        nv = RB.next_valid(jnp.asarray(cw[b:b + 1]))
        side, rec, osz = RB.decide_batch(
            jnp.asarray(iw[b:b + 1]), jnp.asarray(cw[b:b + 1]), nv,
            jnp.asarray(meta[b:b + 1]), ext=ext, interpret=True)
        pay = RB.assemble_batch(jnp.asarray(iw[b:b + 1]), side, rec, osz,
                                interpret=True)
        outs.append([np.asarray(a) for a in (side, rec, osz, pay)])
    jax_out = [np.concatenate(a) for a in zip(*outs)]
    t = planes_to_torch(iw, cw, meta, device="cpu")
    pnv = PB.next_valid(t[1])
    port = PB.decide_batch(t[0], t[1], pnv, t[2], ext=ext)
    # the port's assemble on the JAX package's side and record planes
    jplanes = planes_to_torch(*jax_out[:3], device="cpu")
    port_pay = PB.assemble_batch(t[0], *jplanes)
    return ext, cases, jax_out, port, port_pay


def _read_side_bytes(rec, osz, side_base):
    """Side offsets read by the records of a stream below osz[7]."""
    words = rec.reshape(-1)[:osz[7]].astype(np.int64) & 0xFFFFFFFF
    read, p = [], 0
    while p < len(words):
        n_u = words[p + 1] >> 16
        for k in range(n_u):
            w0, src = words[p + 2 + 2 * k], words[p + 3 + 2 * k]
            if src >= side_base:
                read.append(np.arange(src, src + (w0 & 1023)) - side_base)
        p += 2 + 2 * n_u
    return np.concatenate(read) if read else np.zeros(0, np.int64)


def _entries(rec, n):
    """(row, n_u) of each entry of a stream of n words."""
    words, out, p = rec.reshape(-1)[:n], [], 0
    while p < n:
        out.append((int(words[p]), int(words[p + 1]) >> 16))
        p += 2 + 2 * out[-1][1]
    return out


@pytest.mark.parametrize("case", _NAMES)
def test_decide_matches_jax_kernel(runs, case):
    """osz, the record words below osz[7] and every side byte a record
    reads equal the JAX kernel's."""
    ext, cases, (side, rec, osz, _), port, _ = runs
    b = _NAMES.index(case)
    pside, prec, posz = (t[b].numpy() for t in port)
    assert np.array_equal(posz[_OSZ_WORDS], osz[b, _OSZ_WORDS])
    n = osz[b, 7]
    assert np.array_equal(prec.reshape(-1)[:n], rec[b].reshape(-1)[:n])
    read = _read_side_bytes(rec[b], osz[b], PB.U_SIDE)
    sb = side[b].reshape(-1).view(np.uint8)
    assert np.array_equal(pside.reshape(-1).view(np.uint8)[read], sb[read])
    assert osz[b, 2] == 0
    if case == "alternation":  # a row split at the 120-record entry cap
        entries = _entries(rec[b], n)
        assert any(n_u == PB._MAX_ENTRY_RECS and nxt[0] == row
                   for (row, n_u), nxt in zip(entries, entries[1:]))


@pytest.mark.parametrize("case", _NAMES)
def test_assemble_matches_jax_kernel(native, runs, case):
    """The port's assemble on the JAX side and record planes, the JAX
    assemble, and the native core's emission agree on the payload."""
    ext, cases, (_, _, osz, pay), port, port_pay = runs
    b = _NAMES.index(case)
    n = int(osz[b, 0])
    got = PE.payload_from_words(port_pay[b], n)
    assert got == RE.payload_from_words(pay[b], n)
    # and the port's own two passes
    ppay = PB.assemble_batch(
        torch.from_numpy(_planes(native, [cases[b]])[0]),
        *(t[b:b + 1] for t in port))
    assert PE.payload_from_words(ppay[0], int(port[2][b, 0])) == got
    blk, d = cases[b]
    if blk:
        cand = native.build_candidates(d + blk)
        want = (native.encode_block_dict(blk, d, cand, ext) if d
                else native.encode_block_candidates(blk, cand, ext))
        assert got == want


def test_next_valid_matches_jax():
    rng = np.random.default_rng(11)
    cand = rng.integers(-1, 1000, (3, 2 * 8, 128), dtype=np.int32)
    cand[0] = -1
    cand[1, :, :100] = -1
    cand[2, -1, -1] = 5
    got = PB.next_valid(torch.from_numpy(cand))
    assert got.dtype == torch.int32 and got.shape == cand.shape
    assert np.array_equal(got.numpy(),
                          np.asarray(RB.next_valid(jnp.asarray(cand))))


@pytest.mark.parametrize("blk", [
    synthetic_text(300_000, seed=51) + bytes(60_000)
    + synthetic_binary(200_000, seed=52),
    np.random.default_rng(12).bytes((1 << 21) + 5_000)],
    ids=["mixed", "two_windows"])
def test_emit_bulk_block_matches_native(native, blk):
    """Larger blocks, one of them past a 2 MiB window, against the native
    core's level-1 emission, ext on and off."""
    cand = native.build_candidates(blk)
    for ext in (True, False):
        got, ovf = PB.emit_bulk_block(blk, cand, ext=ext, device="cpu")
        assert ovf == 0
        assert got == native.encode_block_candidates(blk, cand, ext)
    assert len(got) > 1 << 21 or len(blk) < 1 << 21


def test_meta_past_the_planes(native):
    """A size or base that does not fit gets osz [-1, 0, 1, 0...] and no
    record; the other blocks are emitted as usual."""
    blocks = [b"abcabcabcabc", b"xyz", b"hello hello hello"]
    iw, cw, meta = planes_to_torch(*_planes(native, [(b, b"")
                                                     for b in blocks]),
                                   device="cpu")
    meta[0, 0] = (1 << 22) + 1
    meta[1, 1] = PE.IN_ROWS * 512
    side, rec, osz = PB.decide_batch(iw, cw, PB.next_valid(cw), meta)
    assert osz[:2].tolist() == [[-1, 0, 1, 0, 0, 0, 0, 0]] * 2
    assert not rec[:2].any() and not side[:2].any()
    pay = PB.assemble_batch(iw, side, rec, osz)
    assert not pay[:2].any()
    assert PE.payload_from_words(pay[2], int(osz[2, 0])) == \
        native.encode_block_candidates(blocks[2],
                                       native.build_candidates(blocks[2]),
                                       True)


def test_wrapper_checks(native):
    iw, cw, meta = planes_to_torch(*_planes(native, [(b"hello hello", b"")]),
                                   device="cpu")
    nv = PB.next_valid(cw)
    with pytest.raises(ValueError, match="int32"):
        PB.decide_batch(iw.to(torch.int64), cw, nv, meta)
    with pytest.raises(ValueError, match="nv_words"):
        PB.decide_batch(iw, cw, nv[:, :8], meta)
    with pytest.raises(ValueError, match="meta is on meta"):
        PB.decide_batch(iw, cw, nv, meta.to("meta"))
    side, rec, osz = PB.decide_batch(iw, cw, nv, meta)
    with pytest.raises(ValueError, match="side_words"):
        PB.assemble_batch(iw, side[:, :8], rec, osz)
    before = dict(PB.launches)
    PB.emit_bulk_batch(iw, cw, meta)
    assert PB.launches == before  # CPU: the plain versions, no launch
