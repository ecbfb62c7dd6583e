"""The premises of the warp decide kernels (``kernels/csrc/encode_bulk.cu``,
``encode_flat.cu`` and the shared ``encode_parse.cuh``), checked on the CPU
with the port's plain versions; no JAX.

(a) The dead-slot premise. The decide sink stores, at every reserved ctrl
and size slot, the byte the host's buffer holds there (the last literal's
over-copy, or 0). Every reserved slot is overwritten by its group's value
except the two still open at ``finish()``, so the warp sink loads and
stores a dead value only for those two. A sink that poisons every reserved
byte and restores the dead value only in the two open slots gives the
plain version's side plane, record stream and osz.

(b) The warp chain walk. ``usable_warp`` loads the span below the cursor
one entry a lane, ends a walk inside it by pointer doubling over shuffles
(5 rounds) and steps through memory when the span passes 32 positions. A
model of it over 32 lanes gives what the serial walk (csrc
``usable_candidate``, the plain parse's ``usable``) gives, at every
candidate read of the parse.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
from turbosqueeze_tpu_torch.kernels import encode_emit as EE
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import (CLASSES, class_blocks,  # noqa: E402
                          open_slot_blocks)

_CUT = 1 << 16
_U32 = 0xFFFFFFFF
_POISON = 0xA5


@pytest.fixture(scope="module")
def native():
    from turbosqueeze_tpu_torch.runtime import native

    return native


@pytest.fixture(scope="module")
def class_cuts():
    """The eight classes of ``chip_smoke.py``'s input, each cut to 64
    KiB."""
    return [b[:_CUT] for b in class_blocks(len(CLASSES))]


def _planes(native, blocks, d=b""):
    """Input, candidate, skip-table and meta planes of a batch (CPU)."""
    iw = torch.from_numpy(np.stack([EE.pack_input_words(d + b)
                                    for b in blocks]))
    cw = torch.from_numpy(np.stack([EE.pack_cand_words(
        native.build_candidates(d + b)) for b in blocks]))
    meta = torch.from_numpy(EE.pack_meta([len(b) for b in blocks], len(d)))
    return [iw, cw, EB.next_valid(cw), meta]


def _garbage_planes(native):
    """Garbage candidates and skip tables and a meta past the planes, as
    ``tests/test_torch_cuda.py::test_encode_kernels_garbage_planes_match_
    plain`` builds them."""
    rng = np.random.default_rng(9)
    blocks = [synthetic_text(20_000, seed=45), b"xyzxyzxyz" * 50, b"q" * 100]
    iw, cw, _, meta = _planes(native, blocks)
    cw[0] = torch.from_numpy(rng.integers(
        -1, 40_000, cw[0].numel(), dtype=np.int32)).view(cw[0].shape)
    cw[1].view(-1)[100:200] = torch.arange(100, 200, dtype=torch.int32)
    meta[2, 0] = (1 << 22) + 1
    nv = EB.next_valid(cw)
    nv[1].view(-1)[:300] = torch.from_numpy(
        rng.integers(-5, 400, 300, dtype=np.int32))
    return [iw, cw, nv, meta]


# --- (a) the dead-slot premise -------------------------------------------

class _PoisonSink(EB._DecideSink):
    """The plain decide sink, but every reserved byte holds a poison byte;
    the dead value is remembered (as the warp sink keeps its source in
    registers) and stored back only in the ctrl and size slots still open
    at ``finish()``."""

    reserved = 0  # slots reserved by every instance, to show the poison ran
    open_dead = 0  # ends at n_sym % 8 == 0 with a dead byte in an open slot

    def __init__(self, *args):
        self.dead = {}
        super().__init__(*args)

    def reserve(self) -> int:
        j, p = self.j, self.sj
        self.dead[p] = 0 if j >= self.hwm else self.inp[self.lls + j
                                                         - self.llo]
        got = super().reserve()
        self.put_side(p, _POISON)
        _PoisonSink.reserved += 1
        return got

    def finish(self) -> None:
        for p in (self.csat, self.ssat):
            self.put_side(p, self.dead[p])
        if self.n_sym & 7 == 0 and (self.dead[self.csat]
                                    or self.dead[self.ssat]):
            _PoisonSink.open_dead += 1
        super().finish()


def _premise_holds(monkeypatch, planes, ext):
    ref = EB.decide_batch(*planes, ext=ext)
    before = _PoisonSink.reserved
    with monkeypatch.context() as m:
        m.setattr(EB, "_DecideSink", _PoisonSink)
        got = EB.decide_batch(*planes, ext=ext)
    assert _PoisonSink.reserved > before
    for name, g, r in zip(("side", "rec", "osz"), got, ref):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("ext", [True, False])
@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_dead_slot_premise(native, class_cuts, monkeypatch, cls, ext):
    """Side plane, record stream and osz unchanged when only the two slots
    open at the end get their dead values, on each class."""
    _premise_holds(monkeypatch, _planes(native, [class_cuts[cls]]), ext)


@pytest.mark.parametrize("case", ["dictionary", "garbage", "edges"])
def test_dead_slot_premise_other_planes(native, monkeypatch, case):
    """The same on a dictionary base, on garbage candidate and skip-table
    planes, and on short blocks, among them blocks that end with both open
    slots holding over-copied bytes, untouched by ``finish()``."""
    if case == "dictionary":
        planes = _planes(native, [synthetic_text(50_000, seed=114),
                                  bytes(3_000)],
                         synthetic_text(33_000, seed=113))
    elif case == "garbage":
        planes = _garbage_planes(native)
    else:
        rng = np.random.default_rng(3)
        alt = b"".join(rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
                       + b"QWERTYUI" for _ in range(1200))
        planes = _planes(native, [alt, b"abcab", b"x", bytes(17),
                                  synthetic_text(9_999, seed=5), b""]
                         + open_slot_blocks())
    before = _PoisonSink.open_dead
    for ext in (True, False):
        _premise_holds(monkeypatch, planes, ext)
    if case == "edges":
        assert _PoisonSink.open_dead >= before + 2 * len(open_slot_blocks())


# --- (b) the warp chain walk ----------------------------------------------

def _usable_serial(cand, i, anchor):
    """The serial walk (csrc usable_candidate): the nearest chain entry p
    with p + 4 <= anchor and an offset <= 65534, or -1; the chain ends
    where it stops decreasing."""
    q, p = i, cand[i]
    while 0 <= p < q and p + 4 > anchor:
        q, p = p, cand[p]
    if p < 0 or p >= q or anchor - p > 65534:
        return -1
    return p


def _usable_warp(cand, i, anchor, paths):
    """``encode_parse.cuh::usable_warp`` over 32 lanes, u32 arithmetic as
    on the card; ``paths`` counts the doubling ends and the memory
    steps."""
    def more(p, q):
        return 0 <= p < q and p + 4 > anchor

    def window(top):
        span = (top - anchor + 4) & _U32
        return [cand[top - lane] if span <= 32 and lane < span
                and top - lane >= 0 else -1 for lane in range(32)]

    top = i
    c = window(top)
    q, p = i, cand[i]
    while more(p, q):
        if (top - anchor + 4) & _U32 <= 32:
            # lane l's successor lane, itself where the walk ends
            nxt = [top - c[lane] if more(c[lane], top - lane) else lane
                   for lane in range(32)]
            for _ in range(5):
                nxt = [nxt[nxt[lane] & 31] for lane in range(32)]
            t = nxt[0]
            q, p = top - t, c[t]
            paths["doubling"] += 1
            break
        q = p
        top = q
        c = window(top)
        p = cand[q]
        paths["memory"] += 1
    if p < 0 or p >= q or (anchor - p) & _U32 > 65534:
        return -1
    return p


class _Reads(list):
    """A candidate list that records the sink's anchor at every read: the
    parse's usable calls read cand[i] first, then each chain entry."""

    def __init__(self, cand, sink_box):
        super().__init__(cand)
        self.box, self.reads = sink_box, set()

    def __getitem__(self, i):
        self.reads.add((i, self.box[0].anchor))
        return super().__getitem__(i)


def _parse_reads(planes, b, ext):
    """Every (position, anchor) at which block b's plain parse reads a
    candidate, and the block's plain candidate list."""
    iw, cw, nv, meta = planes
    size, base = meta[b, :2].tolist()
    end = base + size
    inp, v4 = EE.block_input(iw.view(torch.uint8).reshape(iw.shape[0], -1),
                             b, base, size)
    cand = cw[b].reshape(-1)[:end].tolist()
    box = [None]
    reads = _Reads(cand, box)
    box[0] = EE._TokenSink(bytearray(EE.OUT_ROWS * 512), size, base)
    EE._parse_cand(inp, v4, reads, box[0], base, size, ext,
                   nv[b].reshape(-1)[:end + 1].tolist())
    return reads.reads, cand


def _walks_agree(reads, cand):
    paths = {"doubling": 0, "memory": 0}
    for i, anchor in sorted(reads):
        assert _usable_warp(cand, i, anchor, paths) == \
            _usable_serial(cand, i, anchor), (i, anchor)
    return paths


@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_warp_walk_model(native, class_cuts, cls):
    """At every candidate read of the parse of each class (ext on), the
    32-lane walk gives the serial walk's entry (random bytes have no
    candidate, and their parse reads none)."""
    planes = _planes(native, [class_cuts[cls]])
    reads, cand = _parse_reads(planes, 0, True)
    assert bool(reads) == any(c >= 0 for c in cand)
    _walks_agree(reads, cand)


def test_warp_walk_model_zeros_takes_both_paths(native):
    """Zeros make long chains: the doubling end and the memory step are
    both taken there, and the model agrees with the serial walk."""
    planes = _planes(native, [bytes(_CUT)])
    reads, cand = _parse_reads(planes, 0, False)
    paths = _walks_agree(reads, cand)
    assert paths["doubling"] > 0 and paths["memory"] > 0


@pytest.mark.parametrize("case", ["dictionary", "garbage", "random"])
def test_warp_walk_model_other_chains(native, case):
    """The same on a dictionary base, on the parse of garbage planes, and
    on garbage chains read at random positions and anchors (spans below,
    at and past 32, chains that stop decreasing)."""
    if case == "dictionary":
        planes = _planes(native, [synthetic_text(50_000, seed=114)],
                         synthetic_text(33_000, seed=113))
        runs = [_parse_reads(planes, 0, True)]
    elif case == "garbage":
        planes = _garbage_planes(native)
        runs = [_parse_reads(planes, b, ext) for b in (0, 1)
                for ext in (True, False)]
    else:
        rng = np.random.default_rng(21)
        n = 5_000
        # chains that mostly decrease by a few positions, some garbage
        cand = np.arange(n) - rng.integers(1, 12, n)
        bad = rng.random(n) < 0.05
        cand[bad] = rng.integers(-2, n, int(bad.sum()))
        i = rng.integers(100, n, 3_000)
        anchor = i - rng.integers(0, 80, 3_000)
        runs = [(set(zip(i.tolist(), anchor.tolist())), cand.tolist())]
    for reads, cand in runs:
        paths = _walks_agree(reads, cand)
    if case == "random":
        assert paths["doubling"] > 0 and paths["memory"] > 0
