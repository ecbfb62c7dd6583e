"""The pair mover of the token and stream kernels
(``kernels/csrc/decode_pairs.cuh``) and the stream kernel's split parse
(``decode_stream.cu``), modelled in Python and held to the plain versions
on the CPU; no JAX.

The mover takes up to 32 format pairs a batch. It cuts the batch before
the first pair whose write hull meets the hull of the earlier pairs' (or
that would widen the batch past the map), moves a first pair too wide for
the map alone, paints each written byte with its writer token, points a
byte whose source another earlier pair of the batch writes at that byte,
resolves the pointers by pointer jumping, and loads every byte's final
source before it stores any. The model does each step as the kernel does
and counts the rules it drives; it must give the plain versions' words.

The parse walks the control groups serially, keeping for each pair only
the position of its size byte, its output cursor and its literal bits,
then decodes the 32 pairs of an item at once; the model must give the
pairs the plain version's parse gives.

The premise that makes the batches long, that no pair of a real stream
reads bytes its own pair writes, is checked on the class blocks.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu_torch import block
from turbosqueeze_tpu_torch.kernels import decode_stream as DS
from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import (CLASSES, CORRUPT, class_blocks,  # noqa: E402
                          corrupt_container)

_CUT = 1 << 16
_BATCH, _MAP, _NONE = 32, 8192, 0xFF


@pytest.fixture(scope="module")
def native():
    from turbosqueeze_tpu_torch.runtime import native

    return native


@pytest.fixture(scope="module")
def class_cuts():
    """The eight classes of ``chip_smoke.py``'s input, each cut to 64
    KiB."""
    return [b[:_CUT] for b in class_blocks(len(CLASSES))]


# --- the model ---------------------------------------------------------------

def _write_range(d, ln, P, U):
    """The bytes a token writes inside the output plane: [lo, hi)."""
    return max(d, P), (U if d >= U else min(d + ln, U))


def _load(u, s, U):
    return u[s] if s < U else 0


def _move_solo(u, pair, P, U):
    """A first pair too wide for the map: both tokens read, then written
    in order."""
    d1, l1, s1, d2, l2, s2 = pair
    v1 = [_load(u, min(s1, U) + i, U) for i in range(l1)]
    v2 = [_load(u, min(s2, U) + i, U) for i in range(l2)]
    for d, v in ((d1, v1), (d2, v2)):
        for i, x in enumerate(v):
            if P <= d + i < U:
                u[d + i] = x


def _move_batch(u, pairs, P, U, rules):
    """One batch of the kernel's mover over the flat unified buffer ``u``
    (numpy uint8). ``pairs``: up to 32 (d1, l1, s1, d2, l2, s2). Returns
    the pairs moved."""
    # 1. the batch: each pair's write hull against its prefix, the cut
    lo, hi = [], []
    for d1, l1, _, d2, l2, _ in pairs:
        a1, b1 = _write_range(d1, l1, P, U)
        a2, b2 = _write_range(d2, l2, P, U)
        r = [(a, b) for a, b in ((a1, b1), (a2, b2)) if a < b]
        lo.append(min((a for a, _ in r), default=1 << 32))
        hi.append(max((b for _, b in r), default=0))
    n, Lo, Hi = 0, 1 << 32, 0
    for k in range(len(pairs)):
        if lo[k] < Hi and Lo < hi[k]:
            rules["meets"] += 1
            break
        L, H = min(Lo, lo[k]), max(Hi, hi[k])
        if L < H and ((H - (L & ~3) + 3) & ~3) > _MAP:
            rules["wide"] += 1
            break
        n, Lo, Hi = k + 1, L, H
    if n == 0:
        rules["solo"] += 1
        _move_solo(u, pairs[0], P, U)
        return 1
    rules["batches"] += 1
    if Lo >= Hi:
        return n
    base = Lo & ~3
    span = Hi - base
    # 2. paint: token 2 after token 1, so its bytes win
    w = np.full(span, _NONE, np.int64)
    D, S = np.zeros(2 * n, np.int64), np.zeros(2 * n, np.int64)
    for k, (d1, l1, s1, d2, l2, s2) in enumerate(pairs[:n]):
        for t, (d, ln, s) in enumerate(((d1, l1, s1), (d2, l2, s2))):
            D[2 * k + t], S[2 * k + t] = d, min(s, U)
            a, b = _write_range(d, ln, P, U)
            if a < b:
                w[a - base:b - base] = 2 * k + t
    # 3. entries: a source on a byte an earlier pair writes points there
    e = np.flatnonzero(w != _NONE)
    t = w[e]
    src = S[t] + (base + e - D[t])
    f = src - base
    inside = (f >= 0) & (f < span)
    wf = np.full(len(e), _NONE, np.int64)
    wf[inside] = w[f[inside]]
    written = wf != _NONE
    fwd = written & (wf >> 1 < t >> 1)
    if (written & ~fwd).any():
        rules["hazard"] += 1  # a byte read as it was before the batch
    ent = np.where(fwd, -1 - f, src)  # -1 - f: points at hull byte f
    rules["pointing"] += int(fwd.sum())
    # pointer jumping, synchronous rounds
    full = np.zeros(span, np.int64)
    full[e] = ent
    rounds = 0
    while (full[e] < 0).any():
        rounds += 1
        cur = full[e]
        p = cur < 0
        cur[p] = full[-1 - cur[p]]
        full[e] = cur
    rules["most_rounds"] = max(rules["most_rounds"], rounds)
    # 4. every load before any store
    s = full[e]
    vals = np.where(s < U, u[np.minimum(s, U - 1)], 0).astype(np.uint8)
    u[base + e] = vals
    return n


def _move(u, pairs, P, U, rules, item=None):
    """All pairs through the mover, 32 a batch; with ``item`` set, the
    batches never span two items of that many pairs (the stream kernel's
    queue, the token kernel's chunks)."""
    pos = 0
    while pos < len(pairs):
        end = len(pairs) if item is None else (pos // item + 1) * item
        pos += _move_batch(u, pairs[pos:min(pos + _BATCH, end)], P, U, rules)


def _chunk_pairs(a, b):
    """The token kernel's pairs of one block's chunk planes (count
    clamped to 1022, an odd count's last token dead, word B unsigned), and
    the pairs a chunk holds."""
    out = []
    for ca, cb in zip(a.reshape(-1, 1024).tolist(),
                      (b.reshape(-1, 1024).astype(np.int64)
                       & 0xFFFFFFFF).tolist()):
        n = min(max(ca[0], 0), 1022)
        chunk = []
        for t in range(1, n + 1, 2):
            a1, s1 = ca[t], cb[t]
            a2, s2 = (ca[t + 1], cb[t + 1]) if t + 1 <= n else (0, 0)
            chunk.append((a1 & 0xFFFFFF, (a1 >> 24) & 127, s1,
                          a2 & 0xFFFFFF, (a2 >> 24) & 127, s2))
        out.append(chunk)
    return out


def _tokens_model(pw, ta, tb, out_rows, rules):
    """The token kernel, modelled: (B, out_rows, 128) int32 words."""
    B, pay_rows, _ = pw.shape
    P = pay_rows * 512
    U = P + out_rows * 512
    out = np.zeros((B, out_rows * 512), np.uint8)
    for b in range(B):
        u = np.zeros(U, np.uint8)
        u[:P] = pw[b].reshape(-1).view(np.uint8)
        for chunk in _chunk_pairs(ta[b], tb[b]):
            _move(u, chunk, P, U, rules)
        out[b] = u[P:]
    return torch.from_numpy(out.view(np.int32).reshape(B, out_rows, 128))


def _sym_len(lit, nib, ext):
    return nib + 1 if lit or not (ext and nib < 3) else 32 + 16 * nib


def _parse_items(pay, ext, start, end):
    """The stream kernel's parse, modelled: items of up to 32 pairs. The
    serial walk keeps each pair's size-byte position, output cursor and
    literal bits; each pair is then decoded from them alone. Bytes past
    the payload plane read 0 (the ring is zero-filled there)."""
    P = len(pay)

    def byte(i):
        return int(pay[i]) if i < P else 0

    i, j = 3, start
    while j < end:
        kept = []
        for _ in range(8):
            if j >= end:
                break
            ctrl = byte(i)
            i += 1
            for pair in range(4):
                sb = byte(i)
                lit0 = (ctrl >> (7 - 2 * pair)) & 1
                lit1 = (ctrl >> (6 - 2 * pair)) & 1
                kept.append((i, j, lit0, lit1))
                i += (1 + ((sb >> 4) + 1 if lit0 else 2)
                      + ((sb & 15) + 1 if lit1 else 2))
                j += (_sym_len(lit0, sb >> 4, ext)
                      + _sym_len(lit1, sb & 15, ext))
        item = []
        for q, anchor, lit0, lit1 in kept:
            sb = byte(q)
            q0 = q + 1
            q1 = q0 + ((sb >> 4) + 1 if lit0 else 2)
            srcs = [qq if lit else max(P + anchor - (byte(qq)
                                                      | byte(qq + 1) << 8), 0)
                    for qq, lit in ((q0, lit0), (q1, lit1))]
            l0, l1 = _sym_len(lit0, sb >> 4, ext), _sym_len(lit1, sb & 15, ext)
            item.append((P + anchor, l0, srcs[0], P + anchor + l0, l1,
                         srcs[1]))
        yield item


def _stream_model(pw, meta, dw, out_rows, rules):
    """The stream kernel, modelled: (B, out_rows, 128) int32 words."""
    B, pay_rows, _ = pw.shape
    P, O = pay_rows * 512, out_rows * 512
    U = P + O
    dict_bytes = (np.zeros(0, np.uint8) if dw is None
                  else dw.reshape(-1).view(np.uint8)[:O])
    out = np.zeros((B, O), np.uint8)
    for b, (ext, size, dict_len) in enumerate(meta[:, :3].tolist()):
        u = np.zeros(U, np.uint8)
        u[:P] = pw[b].reshape(-1).view(np.uint8)
        u[P:P + len(dict_bytes)] = dict_bytes
        if size > 0:
            for item in _parse_items(u[:P].copy(), ext != 0, dict_len,
                                     min(dict_len + size, O)):
                _move(u, item, P, U, rules)
        out[b] = u[P:]
    return torch.from_numpy(out.view(np.int32).reshape(B, out_rows, 128))


# --- the planes --------------------------------------------------------------

def _token_planes(parsed):
    """A tokenized block's planes at the shapes ``block.py`` picks."""
    pay2, dst, src, ln, lit, size, base = parsed
    pay_rows = max(-(-(-(-(len(pay2) + 1) // 512) + 16) // 8) * 8, 8)
    out_rows = max(-(-(-(-(base + size + 1) // 512) + 16) // 8) * 8, 8)
    ta, tb = DK.pack_tokens(dst, src, ln, lit, DK.n_chunks_for_tokens(
        len(dst)), pay_rows=pay_rows)
    return (DK.pack_payload_words(pay2, pay_rows)[None], ta[None],
            tb[None]), out_rows


def _check_tokens(planes, out_rows):
    rules = Counter()
    pw, ta, tb = (np.asarray(p) for p in planes)
    got = _tokens_model(pw, ta, tb, out_rows, rules)
    ref = DK.decode_tokens_batch(*(torch.from_numpy(np.ascontiguousarray(p))
                                   for p in (pw, ta, tb)), out_rows=out_rows)
    assert torch.equal(got, ref)
    return rules


def _check_stream(pw, meta, dw, out_rows):
    rules = Counter()
    got = _stream_model(pw, meta, dw, out_rows, rules)
    ref = DS.decode_stream_batch(
        torch.from_numpy(pw), torch.from_numpy(meta),
        None if dw is None else torch.from_numpy(dw), out_rows=out_rows)
    assert torch.equal(got, ref)
    return rules


def _garbage_token_planes(seed):
    """Token planes like ``chip_smoke.py``'s phase 7 and the GPU tests:
    counts past the chunk, and destinations and sources near the planes
    and dense in them, so that pairs overlap, spread past the map and read
    their own bytes."""
    rng = np.random.default_rng(seed)
    pay_rows, out_rows = 16, 24
    U = (pay_rows + out_rows) * 512
    pw = rng.integers(-2**31, 2**31, (3, pay_rows, 128), dtype=np.int32)
    ta = rng.integers(-2**31, 2**31, (3, 2, 8, 128), dtype=np.int32)
    tb = rng.integers(-2**31, 2**31, (3, 2, 8, 128), dtype=np.int32)
    near = rng.integers(0, U, (3, 2, 8, 128))
    ta[1] = (near[1] | rng.integers(0, 128, near[1].shape) << 24)
    dense = rng.integers(pay_rows * 512 - 200, pay_rows * 512 + 3000,
                         (2, 8, 128))
    ta[2] = dense | rng.integers(0, 128, dense.shape) << 24
    tb[1:] = near[1:]
    tb[2] = dense - rng.integers(-40, 400, dense.shape)
    ta.reshape(3, -1)[:, ::1024] = [[5000, 7], [-3, 301], [1022, 901]]
    return (pw, ta, tb), out_rows


# --- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_mover_model_class_blocks(native, class_cuts, cls, level):
    """Both kernels' mover, modelled, on each class cut to 64 KiB, ext on
    and off: the token planes and the raw payload give the plain
    versions' words; the parse model gives the plain parse's pairs; no
    real batch is cut, and the premise holds."""
    data = class_cuts[cls]
    for ext in (True, False):
        payload = native.compress(data, ext, level=level)[19:]
        parsed = block.tokenize_with_dict(payload, ext, None)
        _, dst, src, ln, lit, size, _ = parsed
        # the premise: no pair reads bytes its own pair writes
        for t in range(0, len(dst) - 1, 2):
            lo, hi = dst[t], dst[t + 1] + ln[t + 1]
            for k in (t, t + 1):
                if not lit[k]:
                    assert src[k] + ln[k] <= lo or src[k] >= hi
        rules = _check_tokens(*_token_planes(parsed))
        assert not (rules["meets"] or rules["wide"] or rules["solo"]
                    or rules["hazard"])
        pw = DK.pack_payload_words(payload)[None]
        meta = DS.pack_meta([ext], [len(data)])
        pay = pw.reshape(-1).view(np.uint8)
        assert [p for item in _parse_items(pay, ext, 0, len(data))
                for p in item] == [tuple(p) for p in DS._pairs(
                    pay, ext, 0, len(data))]
        rules = _check_stream(pw, meta, None,
                              DK.OUT_ROWS)
        assert not (rules["meets"] or rules["wide"] or rules["solo"])


def test_mover_model_forwards_long_chains(native, class_cuts):
    """Level-1 zeros and synthetic binary: most bytes of a batch point at
    bytes of earlier pairs of it, through chains of several rounds."""
    for cls in ("zeros", "synthetic_binary"):
        data = class_cuts[CLASSES.index(cls)]
        parsed = block.tokenize_with_dict(native.compress(data, True, level=1)
                                          [19:], True, None)
        rules = _check_tokens(*_token_planes(parsed))
        assert rules["pointing"] > len(data) // 4
        assert rules["most_rounds"] >= 4


def test_mover_model_dictionary(native):
    """A dictionary staged by prefix tokens (token kernel) and at the
    output's head (stream kernel)."""
    from turbosqueeze_tpu_torch.format import iter_container

    d = synthetic_text(16_400, seed=36)
    for data in (synthetic_text(30_000, seed=114), bytes(9000)):
        (_, payload, ext), = iter_container(native.compress_dict(data, d,
                                                                 True))
        _check_tokens(*_token_planes(block.tokenize_with_dict(payload, ext,
                                                              d)))
        pw = DK.pack_payload_words(payload, 64)[None]
        meta = DS.pack_meta([ext], [len(data)], dict_len=len(d))
        _check_stream(pw, meta, DS.pack_dict_words(d), 96)


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_mover_model_corrupt_containers(native, case):
    """The corrupt containers on which the port differs from the JAX
    routes: the models give the plain versions' words."""
    from turbosqueeze_tpu_torch.format import iter_container

    _, stream = corrupt_container(case, native)
    (_, payload, ext), = iter_container(stream)
    size = payload[0] | payload[1] << 8 | payload[2] << 16
    _check_tokens(*_token_planes(block.tokenize_with_dict(payload, ext,
                                                          None)))
    _check_stream(DK.pack_payload_words(payload, 64)[None],
                  DS.pack_meta([ext], [size]), None,
                  64)


@pytest.mark.parametrize("seed", [40, 41])
def test_mover_model_garbage_token_planes(seed):
    """Garbage token planes drive every rule of the batch: the hull cut,
    the map's width, a first pair moved alone, and bytes read as they
    were before the batch."""
    rules = _check_tokens(*_garbage_token_planes(seed))
    assert rules["meets"] and rules["wide"] and rules["solo"]
    assert rules["hazard"] and rules["pointing"]


@pytest.mark.parametrize("seed", [0, 1])
def test_mover_model_garbage_payloads(seed):
    """Random payloads of 8-16 KiB, declared sizes inside and past the
    output plane, ext on and off: the stream model gives the plain
    version's words over the whole output plane."""
    rng = np.random.default_rng(700 + seed)
    pay_rows, out_rows = 16 * (1 + seed), 24
    pw = rng.integers(-2**31, 2**31, (3, pay_rows, 128), dtype=np.int32)
    meta = DS.pack_meta([True, False, seed == 0],
                        [int(rng.integers(1, out_rows * 512)), 2**31 - 1,
                         int(rng.integers(1, 3000))])
    rules = _check_stream(pw, meta, None, out_rows)
    assert rules["meets"] or rules["hazard"]


def test_mover_model_pair_reads_its_own_bytes():
    """A pair whose match reads bytes the pair itself writes (and one
    whose tokens overlap) reads them as they were before the pair; the
    next pair of the batch reads what it wrote."""
    P, out_rows = 512, 8
    U = P + out_rows * 512
    pw = np.arange(128, dtype=np.int32).reshape(1, 1, 128) * 0x01010101
    toks = [  # (dst, len, src) in unified addresses, a pair each two
        (P, 16, 0), (P + 16, 16, 20),        # literals
        (P + 32, 8, P + 28), (P + 40, 8, P + 36),  # reads its own bytes
        (P + 48, 8, P + 40), (P + 50, 4, P),  # tokens overlap: 2nd wins
        (P + 56, 8, P + 44), (P + 64, 8, U - 4),  # forwards; past U
    ]
    ta = np.zeros((1, 1, 8, 128), np.int32)
    tb = np.zeros((1, 1, 8, 128), np.int32)
    fa, fb = ta.reshape(-1), tb.reshape(-1)
    fa[0] = len(toks)
    for i, (d, ln, s) in enumerate(toks, 1):
        fa[i], fb[i] = d | ln << 24, s
    rules = _check_tokens((pw, ta, tb), out_rows)
    assert rules["batches"] == 1 and rules["hazard"] and rules["pointing"]
    assert rules["meets"] == 0
