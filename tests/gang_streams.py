"""Streams for the decoders' tests (importing this module needs no JAX:
the GPU tests import it on a machine without JAX; only
``check_corrupt_difference``, a CPU test's helper, imports it): hand-built gang streams whose records
overlap, read their own rows or carry odd segment bounds, the streams on
which the port deliberately differs from the interpreted Pallas kernel,
garbage planes; hand-built bulk streams whose records overlap; the
corrupt containers on which three decode routes differ from the JAX
routes; the full blocks of the classes ``chip_smoke.py`` decodes; and
the mixed-class inputs (``mixed_case``, ``scale_blocks``) that the fuzz
tests and ``chip_smoke.py``'s scale phase hold every route to."""

import functools

import numpy as np

# Each case is (gangs, bounds, n_win): gangs are (row, [(dst_off, len, w1),
# ...]) in stream order, one round each (nblk 1); bounds are gmeta[16:],
# the cumulative rounds at the end of each window's U and W segments
# (None: past the stream). The port and the interpreted kernel agree on
# these: their sources lie inside the planes both kernels write, and the
# stream's last 8 rows hold only null gangs (see DIFFERENCES).

FILL = 1 << 31


def _u(row, col):
    """A U-plane source: rows [0, 130) are the previous window's tail,
    the literal plane follows."""
    return row << 9 | col


def _w(row, col):
    """A source in the current window (bit 29 marks it; the kernels mask
    it off)."""
    return 1 << 29 | row << 9 | col


_LIT = 130  # first literal row of the U plane

CASES = {
    # two U records on one byte, and two U gangs of one row on one byte;
    # a record past the row's end, a source wrapping inside its row
    "u_records_overlap": ([
        (0, [(0, 4, FILL | 0x01), (2, 4, FILL | 0x02),
             (6, 20, _u(_LIT + 1, 5))]),
        (0, [(20, 10, FILL | 0x40), (500, 30, _u(_LIT + 2, 480))]),
        (3, [(100, 300, _u(_LIT + 3, 200)), (150, 20, _u(_LIT + 4, 511))]),
    ], [3, 3], 1),
    # two records of one W gang on one byte, and a fill over both
    "w_records_overlap": ([
        (0, [(0, 512, _u(_LIT, 0))]),
        (1, [(0, 512, _u(_LIT + 1, 7))]),
        (2, [(0, 64, _w(0, 10)), (32, 64, _w(1, 500)), (40, 8, FILL | 0x80)]),
    ], [2, 3], 1),
    # a W gang that reads bytes of its own row that it also writes: it
    # reads them as they stood before it; the next gang sees its writes
    "w_reads_own_row": ([
        (1, [(0, 256, _u(_LIT + 2, 0))]),
        (1, [(0, 4, FILL | 0x11), (400, 4, _w(1, 0)), (410, 8, _w(1, 2)),
             (254, 4, _w(1, 300))]),
        (5, [(0, 4, _w(1, 0)), (4, 4, _w(1, 400)), (8, 8, _w(1, 252))]),
    ], [1, 3], 1),
    # window 0's W bound below its U bound (an empty W segment: the round
    # counter stays), then window 1 reading window 0's tail
    "w_bound_below_u": ([
        (4000, [(0, 512, _u(_LIT, 3))]),
        (4001, [(0, 512, _u(_LIT + 1, 0))]),
        (4002, [(0, 100, FILL | 0x5A)]),
        (4003, [(7, 90, _u(_LIT + 5, 9))]),
        (0, [(0, 512, _u(34, 11))]),
        (1, [(0, 300, _u(36, 0)), (300, 212, _u(37, 40))]),
        (2, [(0, 512, _w(0, 100))]),
        (3, [(10, 50, _w(1, 290)), (0, 20, _w(2, 0))]),
    ], [4, 2, 6, 8], 2),
    # bounds past the stream's rounds: the rounds that are not there do
    # nothing, and later windows start where the stream ends
    "bounds_past_stream": ([
        (0, [(0, 512, _u(_LIT + 6, 1))]),
        (1, [(5, 200, _w(0, 0)), (100, 20, FILL | 0x33)]),
    ], [1, None, None, None], 2),
}


def _sources_outside_planes(n_rounds):
    """A U gang reading window 0's tail (never staged), the first row past
    the 8-row literal plane and a row past the reference's scratch, beside
    one literal source; then a W gang reading the row past the window.
    The port reads zeros there; the reference reads scratch that nothing
    wrote (the interpreter fills it with 0x80000000 words)."""
    return ([(0, 0, [(0, 8, _u(5, 0)), (8, 8, _u(_LIT + 8, 0)),
                     (16, 8, _u(_LIT + 70, 0)), (24, 8, _u(_LIT, 0))]),
             (1, 2, [(0, 8, _w(4096, 0)), (8, 8, _w(0, 24))])],
            [1, 2], 1, [0, 1, 2, 3, 4, 5, 256, 257])


def _rounds_past_stream(n_rounds):
    """A FILL gang at the head of the stream's row 8 in window 0's U
    segment, and window 1's W bound one round past the stream. The port
    runs no round past the stream; the reference's ring re-reads the
    stream's last 8-row chunk there, so its round ``n_rounds`` replays
    that gang into window 1."""
    half = n_rounds // 2  # the first gang of stream row 8
    return ([(half, 5, [(0, 4, FILL | 0x07)])],
            [half + 1] * 3 + [n_rounds + 1], 2, [(4096 + 5) * 128])


# Where the port and the interpreted kernel differ by design (ROADMAP §3,
# "Open"): case -> f(n_rounds) giving ([(round, row, records), ...],
# bounds, n_win, the output words on which the two differ). Real streams
# (native.bulk_gang) hold neither.
DIFFERENCES = {"sources_outside_planes": _sources_outside_planes,
               "rounds_past_stream": _rounds_past_stream}


def hand_planes(case, slot_recs):
    """Planes of one case of CASES or DIFFERENCES at ``slot_recs`` records
    a gang: (lit, gang, gmeta, n_win), numpy int32, one block of 8 literal
    rows and a 16-row stream."""
    gw, rec_rows = 2 * slot_recs, 16
    n_rounds = rec_rows * 128 // gw
    if case in CASES:
        gangs, bounds, n_win = CASES[case]
        placed = [(i, row, recs) for i, (row, recs) in enumerate(gangs)]
        assert len(gangs) * gw <= 8 * 128  # rows 8-15 are null gangs
    else:
        placed, bounds, n_win, _ = DIFFERENCES[case](n_rounds)
    words = np.zeros(rec_rows * 128, np.uint32)
    for i, row, recs in placed:
        recs = recs + [(0, 0, FILL)] * (slot_recs - len(recs))  # null records
        for j, (off, ln, w1) in enumerate(recs):
            w0 = (row if j == 0 else 0) << 19 | off << 10 | ln
            words[i * gw + 2 * j] = w0
            words[i * gw + 2 * j + 1] = w1
    gm = np.zeros((1, 32), np.uint32)
    gm[0, 0], gm[0, 8], gm[0, 31] = n_win * (1 << 21), n_win, 1
    gm[0, 16:16 + len(bounds)] = [n_rounds + 5 if b is None else b
                                  for b in bounds]
    gm[0, 30] = n_rounds
    lit = np.random.default_rng(61).integers(
        -2**31, 2**31, (1, 8, 128), dtype=np.int32)
    return lit, words.view(np.int32).reshape(1, rec_rows, 128), \
        gm.view(np.int32), n_win


def differing_words(case, slot_recs):
    """The output words of a DIFFERENCES case on which the port and the
    interpreted kernel differ."""
    return DIFFERENCES[case](16 * 128 // (2 * slot_recs))[3]


def garbage_planes(seed):
    """Random records (most sources near or inside their planes, so that
    bytes land), random window counts, and segment bounds past the stream
    and below the round counter: (lit, gang, gmeta, nblk, slot_recs,
    max_win), numpy int32."""
    rng = np.random.default_rng(seed)
    nblk, slot_recs, max_win = ((2, 16, 2), (1, 8, 3), (3, 32, 2))[seed % 3]
    groups, rec_rows = 2, 64
    lit = rng.integers(-2**31, 2**31, (groups * nblk, 16, 128),
                       dtype=np.int32)
    words = rng.integers(0, 2**32, (groups, rec_rows * 128), dtype=np.uint32)
    w1 = words[:, 1::2]
    near = rng.integers(0, 4096 + 150, w1.shape).astype(np.uint32)
    w1[:] = np.where(rng.random(w1.shape) < 0.6,
                     (w1 & 0xA00001FF) | near << 9, w1)
    n_rounds = rec_rows * 128 // (nblk * 2 * slot_recs)
    gm = rng.integers(0, 2**32, (groups, 32), dtype=np.uint32)
    gm[:, 8:16] = rng.integers(0, 5, (groups, 8))
    gm[0, 16:22] = np.sort(rng.integers(0, n_rounds + 20, 6))
    gm[1, 16:22] = rng.integers(0, n_rounds + 20, 6)
    return (lit, words.view(np.int32).reshape(groups, rec_rows, 128),
            gm.view(np.int32), nblk, slot_recs, max_win)


# Bulk streams (``native.bulk_prep``'s entry ABI, ``decode_bulk.py``) whose
# records overlap, so that the order in which an entry applies its units
# (U gangs of 8, U singles, W gangs of 8, W singles; each unit replaces the
# bytes it covers with the OR of its records' bytes) shows. Each case is
# (abi, nblk, entries) with entries (row, U records, W records) in stream
# order, member i % nblk of a merged ABI taking entry i; records are
# (dst_off, len, w1). W sources read only bytes that earlier entries
# wrote: the JAX kernel's window starts as scratch.
_GANG8 = [(0, 64, _u(_LIT, 0)), (32, 64, _u(_LIT + 1, 100)),
          (64, 8, FILL | 0x21), (60, 10, _u(_LIT + 2, 509)),
          (200, 40, _u(_LIT + 3, 0)), (210, 4, FILL | 0x0F),
          (300, 212, _u(_LIT + 4, 77)), (0, 3, FILL | 0x80)]
_ROWS01 = [(0, [(0, 512, _u(_LIT, 0))], []),
           (1, [(0, 512, _u(_LIT + 1, 7))], [])]
_W_GANG8 = [(0, 64, _w(0, 10)), (32, 64, _w(1, 500)), (40, 8, FILL | 0x80),
            (100, 100, _w(0, 0)), (150, 20, _w(1, 3)), (300, 12, FILL | 0x3C),
            (305, 30, _w(0, 200)), (400, 112, _w(1, 100))]
BULK_CASES = {
    # two U fills on one entry, one unit each: the second replaces
    # bytes 2-3 (the reference gives [1, 1, 2, 2, 2, 2])
    "two_u_singles": ("bulk", 1, [
        (0, [(0, 4, FILL | 0x01), (2, 4, FILL | 0x02)], [])]),
    # the same two fills as the head of a gang of 8: ORed
    "u_gang_of_8": ("bulk", 1, [
        (3, [(0, 4, FILL | 0x01), (2, 4, FILL | 0x02)] + _GANG8[2:], [])]),
    # a gang of 8 with overlaps, then two singles over it and each other
    "u_gang_then_singles": ("bulk", 1, [
        (5, _GANG8 + [(16, 40, _u(_LIT + 5, 300)), (50, 10, FILL | 0x05)],
         [])]),
    # U fills, then a W gang of 8 and three W singles over them and over
    # each other; then the row again, its W records reading it as the
    # entry before left it
    "w_overlaps": ("bulk", 1, _ROWS01 + [
        (2, [(0, 16, FILL | 0x01), (8, 16, FILL | 0x02)],
         _W_GANG8 + [(4, 20, _w(1, 0)), (10, 5, FILL | 0x7E),
                     (190, 20, _w(0, 400))]),
        (2, [], [(0, 8, _w(2, 100)), (96, 8, _w(2, 0))])]),
    # a pair on one alternating stream, both members overlapping
    "pair": ("bulk2", 2, [
        (0, [(0, 4, FILL | 0x01), (2, 4, FILL | 0x02)], []),
        (7, _GANG8 + [(16, 40, _u(_LIT + 5, 300))], []),
        (1, [(0, 512, _u(_LIT + 6, 9))], []),
        (7, [], [(0, 30, _w(7, 200)), (20, 30, FILL | 0x66)]),
        (0, [], [(0, 512, _w(1, 0)), (0, 64, _w(1, 10)),
                 (32, 64, _w(1, 500)), (40, 8, FILL | 0x80)]),
        (8, [], [])]),
    # three blocks round-robin; member 1's and 2's last entries are empty
    "group_of_3": ("bulkn", 3, [
        _ROWS01[0], (9, [(0, 4, FILL | 0x01), (2, 4, FILL | 0x02)], []),
        (6, [(0, 512, _u(_LIT + 2, 3))], []),
        _ROWS01[1], (4, _GANG8, []),
        (7, [], [(0, 100, _w(6, 50)), (90, 20, FILL | 0x03)]),
        (2, [(0, 16, FILL | 0x01), (8, 16, FILL | 0x02)],
         _W_GANG8 + [(4, 20, _w(1, 0))]),
        (0, [(1, 2, FILL | 0x11)], [(8, 8, _w(4, 20))]),
        (6, [(10, 10, FILL | 0x44)], []),
        (3, [], [(0, 64, _w(0, 0)), (32, 64, _w(1, 0))]),
        (9, [], []), (8, [], [])]),
}

_BULK_META = {"bulk": (8, 1, 5), "bulk2": (8, 2, 5), "bulkn": (16, 4, 9)}


def bulk_hand_planes(case):
    """Planes of one BULK_CASES case: (abi, nblk, lit, rec, meta, covered),
    numpy; ``lit`` (nblk, 8, 128) int32 random literal rows, ``rec`` (1, 8,
    128) int32 and ``meta`` (1, meta words) int32 with one window a member,
    and ``covered`` (nblk, 4096, 512) bool, the bytes some record covers.
    Every case has these shapes. Decode with ``max_win=1``."""
    abi, nblk, entries = BULK_CASES[case]
    words, covered = [], np.zeros((nblk, 4096, 512), bool)
    for i, (row, u, w) in enumerate(entries):
        words += [row, len(u) << 16 | len(w)]
        for off, ln, w1 in u + w:
            words += [off << 10 | ln, w1]
            covered[i % nblk, row, off:off + ln] = True
    rec = np.zeros(8 * 128, np.uint32)
    rec[:len(words)] = words
    meta_words, nwin, end = _BULK_META[abi]
    meta = np.zeros((1, meta_words), np.uint32)
    meta[0, 0] = 512
    meta[0, nwin:nwin + nblk] = 1
    meta[0, end] = len(words)
    lit = np.random.default_rng(71).integers(
        -2**31, 2**31, (nblk, 8, 128), dtype=np.int32)
    return (abi, nblk, lit, rec.view(np.int32).reshape(1, 8, 128),
            meta.view(np.int32), covered)


# Corrupt level-1 containers that ``native.decompress`` accepts, on which
# the ``pallas``, ``bulk`` and ``stream`` routes differ from the JAX routes
# (ROADMAP §3): a match reads output bytes no token wrote. The JAX kernels
# give their scratch there (in interpret mode the high byte 0x80 of the
# 0x80000000 fill), the port 0; no decoder defines these bytes. Each is
# (input, {container byte: new value}).
CORRUPT = {"text300": ((300, 3), {185: 0x61}),
           "text60000": ((60000, 3),
                         {13981: 0xF2, 15783: 0x81, 25492: 0x52})}
# case -> route -> the decoded bytes on which the two differ
CORRUPT_DIFFERENCES = {
    "text300": {"pallas": [275, 279, 283, 287, 291, 295, 299],
                "bulk": [283, 287, 291, 295, 299], "stream": []},
    "text60000": {
        "pallas": [*range(57208, 57256, 4), 57271, 57432, 57453, 57457,
                   57461, 57578, 57596, 57600, 57629, 57633, 57637, 57842,
                   57865, 57869, 57873, 57877, 57880, 57884, 57948, 57998,
                   58002, 58146, 58149, 58153, 58232, 58286, 58289, 58293,
                   58348, 58351, 58355, 58393, 58406, 58417, 58528, 58575,
                   58643, 58689, 58693, 58800, 58815, 58818, 58822, 58865,
                   58998, 59001, 59005, 59016, 59188, 59192, 59275, 59330,
                   59377, 59394, 59397, 59401, 59528, 59530, 59610, 59614,
                   59664, 59666, 59768, 59819, 59980, 59994, 59996],
        "bulk": [*range(57216, 57256, 4), 57454, 57458, 57630, 57634, 57881,
                 58150, 58290, 58352, 58819, 59002, 59398]}}
CORRUPT_DIFFERENCES["text60000"]["stream"] = \
    CORRUPT_DIFFERENCES["text60000"]["pallas"]


def corrupt_container(case, native):
    """The CORRUPT container ``case``, made with ``native`` (the port's or
    the JAX package's binding of the host core): the input and the
    container."""
    from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

    (n, seed), flips = CORRUPT[case]
    data = synthetic_text(n, seed=seed)
    c = bytearray(native.compress(data, True, level=1))
    for i, v in flips.items():
        c[i] = v
    return data, bytes(c)


def check_corrupt_difference(case, impl, native):
    """The CPU tests' pin of a CORRUPT container on route ``impl``: the
    JAX route (interpreted; JAX is imported here only) and the port's plain
    version differ on exactly the listed bytes, the reference's 0x80 and
    the port's 0, and ``native.decompress`` accepts the container."""
    import jax
    from turbosqueeze_tpu.parallel import mesh as ref_mesh
    from turbosqueeze_tpu.parallel import pipeline as ref_pipeline
    from turbosqueeze_tpu_torch.parallel import pipeline

    data, stream = corrupt_container(case, native)
    native.decompress(stream)
    ref = np.frombuffer(ref_pipeline.decompress(
        stream, mesh=ref_mesh.block_mesh(jax.devices()[:1]), impl=impl),
        np.uint8)
    got = np.frombuffer(pipeline.decompress(stream, device="cpu", impl=impl),
                        np.uint8)
    differ = np.zeros(len(data), bool)
    differ[CORRUPT_DIFFERENCES[case][impl]] = True
    assert len(ref) == len(got) == len(data)
    assert np.array_equal(got[~differ], ref[~differ])
    assert (ref[differ] == 0x80).all() and not got[differ].any()


# the classes of class_blocks, in their order
CLASSES = ("licenses", "pydoc", "python", "bytecode", "synthetic_text",
           "synthetic_binary", "zeros", "random")


def class_blocks(n_blocks=len(CLASSES)):
    """Full 4 MiB blocks cycling over the classes ``chip_smoke.py``
    decodes: the four in-repo real files, synthetic text and binary,
    zeros, random bytes; each block cut from its class at its own
    offset."""
    from turbosqueeze_tpu_torch.utils.corpus import (real_files,
                                                     synthetic_binary,
                                                     synthetic_text)

    blk = 4 << 20
    pool = list(real_files().values()) + [synthetic_text(blk, seed=301),
                                          synthetic_binary(blk, seed=302)]
    out = []
    for i in range(n_blocks):
        c = i % len(CLASSES)
        if CLASSES[c] == "zeros":
            out.append(bytes(blk))
        elif CLASSES[c] == "random":
            out.append(np.random.default_rng(1000 + i).bytes(blk))
        else:
            src = pool[c]
            off = (i // len(CLASSES)) * 523_123 % len(src)
            reps = (off + blk) // len(src) + 1
            out.append((src * reps)[off:off + blk])
    return out


def open_slot_blocks():
    """Short blocks (86 bytes) whose parse ends on a match right after a
    short literal run, at n_sym % 8 == 0: the ctrl and size slots still
    open at the end lie below the literal high-water mark, so they hold
    over-copied input bytes (the decide sinks' dead values)."""
    out = []
    for k in (29, 32, 35):
        r = np.random.default_rng(100 * k + 38 - k)
        p = r.bytes(24)
        out.append(r.bytes(k) + p + r.bytes(38 - k) + p)
    return out


def mixed_case(rng, size):
    """Content with abrupt class switches at random boundaries: the port's
    copy of ``tests/test_fuzz_roundtrip.py::_mixed_case`` (the same bytes
    for the same ``np.random.Generator`` state). Pieces of 500-70,000
    bytes: incompressible, zeros, synthetic text, synthetic binary, or a
    re-quote of the previous 70,000 bytes."""
    from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                     synthetic_text)

    parts = []
    n = 0
    while n < size:
        kind = rng.integers(0, 5)
        ln = int(rng.integers(500, 70_000))
        if kind == 0:
            parts.append(rng.bytes(ln))
        elif kind == 1:
            parts.append(bytes(ln))
        elif kind == 2:
            parts.append(synthetic_text(ln, seed=int(rng.integers(1e6))))
        elif kind == 3:
            parts.append(synthetic_binary(ln, seed=int(rng.integers(1e6))))
        else:
            prev = b"".join(parts)[-70_000:] or b"seed"
            parts.append((prev * 3)[:ln])
        n += ln
    return b"".join(parts)[:size]


_BLK = 4 << 20
_EDGE = 1 << 16       # the 64 KiB offset window's edge
_QUOTE = (64_000, 67_000)  # re-quote distances, either side of MAX_OFFSET


def scale_blocks(seed, n_blocks=256, n_pure=8):
    """``n_blocks`` full 4 MiB blocks of seeded mixed-class content, as one
    bytes object (256 blocks: 1 GiB, the scale phase's input; about 4 s
    to build). The recipe, all drawn from ``np.random.default_rng(seed)``:

    - pure blocks: block k of ``class_blocks(n_pure)`` (licenses, pydoc,
      Python source, bytecode, synthetic text, synthetic binary, zeros,
      random) goes at a seeded index of the k-th of ``n_pure`` equal runs
      of blocks (with 256 blocks: one in each 32-block window);
    - every other block is cut from one continuous splice, so a piece
      runs on across the boundary between two such blocks. Pieces of
      500-70,000 bytes, each of one kind: random bytes; zeros; a slice
      of one of the four real files (``real_files``) at a seeded offset;
      a slice of a pool of ``synthetic_text(4 MiB, seed=401)`` or
      ``synthetic_binary(4 MiB, seed=402)`` at a seeded offset; a run of
      one seeded byte value; or a re-quote: the bytes 64,000-67,000
      back (either side of the format's largest offset, 65,534), repeated
      with that period, the piece stretched past the next 64 KiB edge of
      its block;
    - the piece that crosses a boundary between two spliced blocks is a
      byte run or a re-quote, stretched 500-70,000 bytes into the next
      block.
    """
    if not 0 <= n_pure <= n_blocks:
        raise ValueError(f"n_pure {n_pure} outside [0, {n_blocks}]")
    rng = np.random.default_rng(seed)
    pools = _pools()
    out = np.zeros(n_blocks * _BLK, np.uint8)
    pure = {}
    if n_pure:
        run = n_blocks // n_pure
        for k, blk in enumerate(class_blocks(n_pure)):
            pure[k * run + int(rng.integers(run))] = blk
    for b, blk in pure.items():
        out[b * _BLK:(b + 1) * _BLK] = np.frombuffer(blk, np.uint8)
    b = 0
    while b < n_blocks:
        if b in pure:
            b += 1
            continue
        stop = b
        while stop < n_blocks and stop not in pure:
            stop += 1
        _splice(rng, out, b * _BLK, stop * _BLK, pools)
        b = stop
    return out.tobytes()


@functools.lru_cache(maxsize=1)
def _pools():
    """The pieces' sources: the four real files, then the synthetic text
    and binary pools (uint8 arrays, made once a process)."""
    from turbosqueeze_tpu_torch.utils.corpus import (real_files,
                                                     synthetic_binary,
                                                     synthetic_text)

    return [np.frombuffer(b, np.uint8) for b in (
        *real_files().values(), synthetic_text(_BLK, seed=401),
        synthetic_binary(_BLK, seed=402))]


def _splice(rng, out, pos, end, pools):
    """Fill ``out[pos:end]`` with the pieces ``scale_blocks`` describes:
    kind 0 random, 1 zeros, 2 a real file, 3 a synthetic pool, 4 a byte
    run, 5 a re-quote."""
    start = pos
    while pos < end:
        kind = int(rng.integers(0, 6))
        ln = int(rng.integers(500, 70_000))
        edge = (pos // _BLK + 1) * _BLK  # the next block boundary
        if pos + ln > edge and edge < end:  # this piece crosses it
            kind = 4 + int(rng.integers(0, 2))
            ln = edge - pos + int(rng.integers(500, 70_000))
        if kind == 5:
            d = int(rng.integers(*_QUOTE))
            if pos - d < start:
                kind = 4
            else:
                lo = pos % _BLK
                ln = max(ln, (lo // _EDGE + 1) * _EDGE - lo
                         + int(rng.integers(1, 4096)))
        ln = min(ln, end - pos)
        dst = out[pos:pos + ln]
        if kind == 0:
            dst[:] = np.frombuffer(rng.bytes(ln), np.uint8)
        elif kind == 1:
            dst[:] = 0
        elif kind in (2, 3):
            src = pools[int(rng.integers(0, 4)) if kind == 2
                        else int(rng.integers(4, 6))]
            off = int(rng.integers(0, len(src) - ln))
            dst[:] = src[off:off + ln]
        elif kind == 4:
            dst[:] = int(rng.integers(0, 256))
        else:
            for k in range(0, ln, d):  # period d: each chunk copies d back
                n = min(d, ln - k)
                out[pos + k:pos + k + n] = out[pos + k - d:pos + k - d + n]
        pos += ln
