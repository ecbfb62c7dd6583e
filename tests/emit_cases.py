"""Hand-made blocks for the ``table`` matcher of the emit kernel
(``turbosqueeze_tpu_torch/kernels/csrc/encode_emit.cu``), whose literal
scan probes 32 positions a step on one warp, and a model of that batch
written over the plain version's pieces. No JAX: the GPU tests import this
module too.

The kernel's batch rules, which each case drives:

  * lanes with one hash inside a batch: the highest lower lane's position
    replaces the stale table entry, and only the highest lane up to the
    stop stores its position (``same_hash``);
  * the batch stops on its first found lane, lane 0 to lane 31
    (``stop_lanes``);
  * a batch ends at the serial loop's 32-byte flush point, and the flush
    moves the anchor at either ``n_sym`` parity (``flush_parity``);
  * the block's end inside a batch, a position past it found
    (``end_in_batch``);
  * a stale 16-bit entry promoted into the window at a position whose
    bytes match (``stale_alias``).

A position forwarded from a lower lane of the same batch is never found:
it lies past the anchor, which the offset test needs it to be below.
``same_hash`` instead finds, in a later batch, the position the highest
lane stored.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from turbosqueeze_tpu_torch.format import HASH_ENTRIES
from turbosqueeze_tpu_torch.kernels import encode_emit as EE

_U32 = 0xFFFFFFFF


def _collide(word: int) -> int:
    """Another 4-byte word with the same hash: flipping bit 17 flips bit 5
    of ``word >> 12``, and flipping bit 5 undoes it."""
    return word ^ (1 << 17) ^ (1 << 5)


def _same_hash(rng) -> bytes:
    """Random bytes with a 4-byte word three times and a word of the same
    hash twice inside 32 bytes, again and again. The other word also
    stands 100 bytes before: the table's entry for the hash, which the
    first lane reads and does not match, and which a later lane holding
    the other word would match were the first lane's position not
    forwarded to it. Later the word recurs with a longer tail, found at
    the highest lane's position."""
    out = bytearray(rng.bytes(3000))
    for k in range(40):
        word = rng.bytes(4)
        other = _collide(int.from_bytes(word, "little")).to_bytes(4, "little")
        out += other + rng.bytes(96)
        at = len(out)
        out += rng.bytes(3) + word + rng.bytes(5) + word + other + word
        out += other + rng.bytes(30 + k)
        out += rng.bytes(200) + word + out[at + 17:at + 25] + rng.bytes(40)
    return bytes(out)


def _stop_lanes(rng) -> bytes:
    """After a 16-byte match (which ends exactly where its chunk ends),
    ``g`` random bytes and the next chunk: the scan finds it on lane g - 1,
    for g = 0 .. 70 (lanes 0 to 31, and in a second or third batch). Then
    the word one byte into each chunk, alone: found in the first copy,
    since no lane past a stop records its position."""
    src = rng.bytes(16 * 80)
    out = bytearray(src)
    for g in range(71):
        out += rng.bytes(g) + src[16 * g:16 * g + 16]
    for g in range(71):
        out += rng.bytes(40) + src[16 * g + 1:16 * g + 5]
    return bytes(out)


def _flush_parity(rng) -> bytes:
    """Random gaps of 33-120 bytes between 7- to 30-byte repeats, so the
    scans flush at both parities of ``n_sym``; after each flush point a
    word from 6-14 bytes before it recurs, which is found only when the
    flush moved the anchor to the flush point (an even ``n_sym`` before
    it), not 16 bytes short of it."""
    src = rng.bytes(2000)
    out = bytearray(src)
    for k in range(120):
        n = 7 + k % 24
        out += src[n * k % 1900:n * k % 1900 + n]
        g = 33 + (k * 37) % 88
        gap = bytearray(rng.bytes(g))
        back = 6 + k % 9
        if g > 40:  # the first flush point lies 32 bytes into the gap
            gap[33:37] = gap[32 - back:36 - back]
        out += gap
    return bytes(out)


def _end_in_batch(rng) -> list:
    """Blocks ending 1-31 positions into a batch, zeros first: the zero
    padding past the end matches, so lanes past the end are found too."""
    return [bytes(100) + rng.bytes(900 + k) for k in range(0, 32, 5)]


def _stale_alias(rng) -> bytes:
    """A 2048-byte random period repeated past 64 KiB: after the first
    copy only match ends are probed, so a word's entry keeps its position
    from the first copy; 5000 bytes past the 64 KiB point a random stretch
    holds that word, whose stored 16-bit position promotes to the copy 64
    KiB later, with the same bytes: found there."""
    period = rng.bytes(2048)
    out = bytearray(period * 34)  # 69,632 bytes
    q = 65536 + 1000 + 5000
    del out[q - 200:]
    out += rng.bytes(200) + period[1000:1004] + rng.bytes(300)
    return bytes(out)


def table_cases() -> dict:
    """{name: [blocks]} for the ``table`` matcher."""
    rng = np.random.default_rng(2024)
    return {"same_hash": [_same_hash(rng)],
            "stop_lanes": [_stop_lanes(rng)],
            "flush_parity": [_flush_parity(rng)],
            "end_in_batch": _end_in_batch(rng),
            "stale_alias": [_stale_alias(rng)]}


def table_batches(block: bytes, ext: bool = True):
    """The ``table`` parse of ``block`` with its literal scan in the
    kernel's batches of 32 lanes, over the plain version's sink, prefix
    and probe rules. Returns (payload, events): a Counter of the batch
    rules the block drove (``stop_lane_<l>``, ``forwarded`` lanes,
    ``shared_hash`` batches, ``flush_parity_<n_sym & 1>``,
    ``near_anchor_<parity>``: a find 5-20 bytes below the anchor in the
    batch after a flush, ``end_in_batch``, ``past_end_found``,
    ``stale_found``: a find whose entry was stored at another
    position)."""
    planes = EE.pack_input_words(block)[None]
    inp, v4 = EE.block_input(torch.from_numpy(planes).view(torch.uint8)
                             .reshape(1, -1), 0, 0, len(block))
    buf = bytearray(EE.OUT_ROWS * EE.ROW_BYTES)
    sink = EE._TokenSink(buf, len(block), 0)
    prefix = EE._prefix_fn(v4, ext)
    table, stored = [0] * HASH_ENTRIES, [0] * HASH_ENTRIES
    ev = collections.Counter()
    end = len(block)
    end5 = (end - 5) & _U32

    def hash4(v):
        return (v ^ (v >> 12)) & (HASH_ENTRIES - 1)

    def promote(p16, i):
        return p16 + (i & ~0xFFFF) - (65536 if p16 >= (i & 0xFFFF) else 0)

    def ok(cur, pos, anchor):
        return ((anchor - pos - 4) & _U32) < 0xFFFB and cur == v4[pos]

    i, last_flush = 0, None
    while end:
        run_start = i
        while True:
            qs = [i + 1 + lane for lane in range(32)]
            curs = [v4[q] for q in qs]
            hs = [hash4(c) for c in curs]
            pos, src = [], []  # src: where the entry read was stored
            for lane, h in enumerate(hs):
                lower = [m for m in range(lane) if hs[m] == h]
                if lower:
                    ev["forwarded"] += 1
                p16 = (qs[lower[-1]] & 0xFFFF) if lower else table[h]
                pos.append(promote(p16, qs[lane]))
                src.append(qs[lower[-1]] if lower else stored[h])
            found = [ok(c, p, sink.anchor) for c, p in zip(curs, pos)]
            stops = [lane for lane in range(32)
                     if found[lane] or qs[lane] >= end]
            s = stops[0] if stops else 31
            if len(set(hs[:s + 1])) <= s:
                ev["shared_hash"] += 1
            for lane in range(s + 1):  # the highest lane of each hash
                if hs[lane] not in hs[lane + 1:s + 1]:
                    table[hs[lane]] = qs[lane] & 0xFFFF
                    stored[hs[lane]] = qs[lane]
            if stops and qs[s] >= end:
                ev["end_in_batch"] += s < 31
                ev["past_end_found"] += any(found[s:])
            elif stops:
                ev[f"stop_lane_{s}"] += 1
                if last_flush is not None and \
                        5 <= sink.anchor - pos[s] <= 20:
                    ev[f"near_anchor_{last_flush}"] += 1
            last_flush = None
            i += s + 1
            if s == 31:
                ev[f"flush_parity_{sink.n_sym & 1}"] += 1
                last_flush = sink.n_sym & 1
                sink.literals(inp, run_start, i)
                run_start = i
            if stops:
                p = pos[s]
                if found[s] and src[s] != p:
                    ev["stale_found"] += 1
                break
        sink.literals(inp, run_start, i)
        if i >= end:
            break
        while True:
            k = prefix(i, p)
            window = (sink.anchor - p) & _U32
            if k > window:
                k = window - 1
            if k < 4 or ((window - 4) & _U32) >= 0xFFFB:
                break
            code = EE.MLEN_TABLE[k]
            i += (code + 2) << 4 if code < 3 else code + 1
            sink.match(window, code, i)
            cur = v4[i]
            h = hash4(cur)
            p = promote(table[h], i)
            table[h], stored[h] = i & 0xFFFF, i
            if not (i < end5 and ok(cur, p, sink.anchor)):
                break
        if i >= end:
            break
    n = sink.finish()
    return bytes(buf[:n]), ev
