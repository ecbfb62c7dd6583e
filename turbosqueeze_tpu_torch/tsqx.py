"""TSQX: the serving profile of a ``.tsq`` container, gang-ready record
planes on disk; the port of ``turbosqueeze_tpu/tsqx.py``.

The gang decode route (``pipeline.decompress(impl="gang")``) spends most of
its wall time resolving every block's payload on the host
(``native.bulk_prep``, then ``native.bulk_gang``) before the gang kernel
runs. TSQX moves that resolve to pack time: the container stores the
resolver's output, padded to the kernel's plane geometry, so decoding it is
a file read, one upload and the gang kernel (``kernels/decode_gang.py``),
with no per-byte host work. A TSQX file runs about twice the decoded size:
it is a decode-speed cache beside the ``.tsq``, not a compression format.

Container layout (little-endian), version 1, byte for byte the JAX
package's:

    0   "TSQX"
    4   u32 version = 1
    8   u32 nblk        gang co-schedule width (1..8)
    12  u32 slot_recs   records per gang slot (8, 16 or 32)
    16  u32 n_blocks    real blocks (groups pad to nblk with empties)
    20  u32 lit_rows    per-block literal-plane rows (container-wide)
    24  u32 rec_rows    per-group gang-stream rows (container-wide)
    28  u32 flags       reserved (0)
    32  u64 total_size  decoded bytes
    40  u64 reserved
    48  u32 sizes[n_blocks]             decoded size per block
    ..  u32 gmeta[n_groups][32]         ``native.bulk_gang``'s meta words
    ..  u8  lit_planes[n_pad][lit_rows*512]
    ..  u8  gang_planes[n_groups][rec_rows*512]

``TsqxView`` checks every header field and section bound before it hands
out a view (the JAX package's view checks only the magic and version).
The plane sections are only 4-byte aligned in the file, and the gang
kernel reads its planes 16 bytes at a time, so ``decode_to_words``
copies them once into fresh (pinned, for a CUDA device) host tensors and
uploads those; the kernel never sees a view into the file. ``decompress``
copies each decoded block once, from the pinned download straight into
the result.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .format import BLOCK_SZ, FormatError, scan_block_table
from .kernels import decode_gang as DGK
from .kernels.decode_bulk import EMPTY_PREP, rows_for_bytes
from .kernels.decode_tokens import OUT_ROWS, to_device
from .parallel import mesh as mesh_mod
from .parallel.pipeline import (GANG_SRECS, _lookahead, _Pending, _Shard,
                                _Spread, _to_host0)
from .runtime import native
from .utils import profiling

MAGIC = b"TSQX"
VERSION = 1
_HDR = struct.Struct("<4sIIIIIIIQQ")
assert _HDR.size == 48

ROW_BYTES = 512
LANES = 128
SLOT_RECS = (8, 16, 32)  # the gang kernel's slot widths
BATCH_GROUPS = 16  # groups a device's batch: bounds its memory


def is_tsqx(data) -> bool:
    return bytes(data[:4]) == MAGIC


def _bucket(x: int, m: int) -> int:
    return -(-x // m) * m


def pack(stream: bytes, nblk: int = 4, slot_recs: Optional[int] = None,
         threads: Optional[int] = None) -> bytes:
    """Resolve a ``.tsq`` container into a TSQX serving container, byte
    for byte what the JAX package's ``pack`` gives.

    Runs the native resolver once per block and the gang merger once per
    ``nblk``-block group, in a pool of ``threads`` threads (the core
    releases the GIL). Raises ValueError when a block is too fragmented
    for the gang formulation (serve the ``.tsq`` container instead).
    """
    if not 1 <= nblk <= 8:
        raise ValueError("nblk must be in [1, 8]")
    if slot_recs is None:
        slot_recs = GANG_SRECS.get(nblk, 8)
    hdr, table = scan_block_table(stream)
    n = len(table)
    if n == 0:
        return _HDR.pack(MAGIC, VERSION, nblk, slot_recs, 0, 8, 8, 0,
                         hdr.total_size, 0)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        preps: List = list(pool.map(
            lambda e: native.bulk_prep(stream[e[0]:e[0] + e[1]], e[2]),
            table))
        bad = [b for b in range(n) if preps[b] is None]
        if bad:
            raise ValueError(
                f"block(s) {bad[:4]} too fragmented for the gang "
                "formulation; serve the .tsq container instead")
        n_pad = _bucket(n, nblk)
        preps += [EMPTY_PREP] * (n_pad - n)
        n_groups = n_pad // nblk
        merged = list(pool.map(lambda g: native.bulk_gang(
            [p[1] for p in preps[nblk * g:nblk * (g + 1)]],
            [p[2] for p in preps[nblk * g:nblk * (g + 1)]], slot_recs),
            range(n_groups)))

    lit_rows = max(rows_for_bytes(len(p[0])) for p in preps)
    rec_rows = max(rows_for_bytes(4 * len(m[0])) for m in merged)
    lit_bytes, rec_bytes = lit_rows * ROW_BYTES, rec_rows * ROW_BYTES
    o_gmeta = _HDR.size + 4 * n
    o_lit = o_gmeta + 4 * n_groups * DGK.GMETA_WORDS
    o_gang = o_lit + n_pad * lit_bytes
    out = np.zeros(o_gang + n_groups * rec_bytes, dtype=np.uint8)
    out[:_HDR.size] = np.frombuffer(_HDR.pack(
        MAGIC, VERSION, nblk, slot_recs, n, lit_rows, rec_rows, 0,
        hdr.total_size, 0), np.uint8)
    out[_HDR.size:o_gmeta].view(np.uint32)[:] = [int(p[2][0])
                                                 for p in preps[:n]]
    gmeta = out[o_gmeta:o_lit].view(np.uint32).reshape(n_groups, -1)
    for g, (rec, m) in enumerate(merged):
        gmeta[g] = m
        o = o_gang + g * rec_bytes
        out[o:o + 4 * len(rec)] = rec.view(np.uint8)
    for b, p in enumerate(preps):
        o = o_lit + b * lit_bytes
        out[o:o + len(p[0])] = p[0]
    return out.tobytes()


class TsqxView:
    """Zero-copy numpy views of a TSQX container's sections, after every
    header field and section bound has been checked; raises FormatError
    on a malformed container."""

    def __init__(self, data):
        buf = memoryview(data)
        if len(buf) < _HDR.size:
            raise FormatError("TSQX container shorter than its header")
        (magic, version, self.nblk, self.slot_recs, self.n_blocks,
         self.lit_rows, self.rec_rows, _flags, self.total_size,
         _r) = _HDR.unpack_from(buf, 0)
        if magic != MAGIC:
            raise FormatError("not a TSQX container")
        if version != VERSION:
            raise FormatError(f"unsupported TSQX version {version}")
        if not 1 <= self.nblk <= 8:
            raise FormatError(f"TSQX nblk {self.nblk} not in [1, 8]")
        if self.slot_recs not in SLOT_RECS:
            raise FormatError(f"TSQX slot_recs {self.slot_recs} not in "
                              f"{SLOT_RECS}")
        for name in ("lit_rows", "rec_rows"):
            rows = getattr(self, name)
            if rows <= 0 or rows % 8:
                raise FormatError(f"TSQX {name} {rows} is not a positive "
                                  "multiple of 8")
        n = self.n_blocks
        self.n_pad = _bucket(n, self.nblk)
        self.n_groups = self.n_pad // self.nblk
        o = _HDR.size
        end = (o + 4 * n + 4 * self.n_groups * DGK.GMETA_WORDS
               + (self.n_pad * self.lit_rows + self.n_groups * self.rec_rows)
               * ROW_BYTES)
        if end > len(buf):
            raise FormatError(f"TSQX sections need {end} bytes, the "
                              f"container has {len(buf)}")
        sizes = np.frombuffer(buf, np.uint32, n, o)
        self.sizes = sizes.tolist()
        # every block of the padded groups, 0 for a padding block
        self.block_sizes = self.sizes + [0] * (self.n_pad - n)
        o += 4 * n
        self.gmeta = np.frombuffer(
            buf, np.int32, self.n_groups * DGK.GMETA_WORDS, o).reshape(
            self.n_groups, DGK.GMETA_WORDS)
        o += 4 * self.n_groups * DGK.GMETA_WORDS
        lit_n = self.n_pad * self.lit_rows * LANES
        self.lit_words = np.frombuffer(buf, np.int32, lit_n, o).reshape(
            self.n_pad, self.lit_rows, LANES)
        o += 4 * lit_n
        rec_n = self.n_groups * self.rec_rows * LANES
        self.gang_words = np.frombuffer(buf, np.int32, rec_n, o).reshape(
            self.n_groups, self.rec_rows, LANES)
        if n and int(sizes.max()) > BLOCK_SZ:
            raise FormatError(f"TSQX block size {int(sizes.max())} past "
                              f"{BLOCK_SZ}")
        if sum(self.sizes) != self.total_size:
            raise FormatError(f"TSQX block sizes sum to {sum(self.sizes)}, "
                              f"the header declares {self.total_size}")
        meta = self.gmeta.view(np.uint32).astype(np.int64)
        rounds = meta[:, 30]
        words = rounds * self.nblk * 2 * self.slot_recs
        if (words > self.rec_rows * LANES).any():
            raise FormatError("TSQX gang rounds overrun the gang plane")
        if (meta[:, 16:30] > rounds[:, None]).any():
            raise FormatError("TSQX gang segment bounds past the rounds")


def _host_planes(view: TsqxView, lo: int, hi: int, pin: bool):
    """Groups [lo, hi)'s planes copied once into fresh host tensors
    (pinned when ``pin``): (lit, gang, gmeta) int32."""
    nblk = view.nblk
    out = []
    with profiling.span("host.pack") as sp:
        for a in (view.lit_words[lo * nblk:hi * nblk],
                  view.gang_words[lo:hi], view.gmeta[lo:hi]):
            t = torch.empty(a.shape, dtype=torch.int32, pin_memory=pin)
            # one thread: on the H100 host torch's threaded copy was faster
            # only at nblk 4 and 8, for several times the host CPU seconds
            t.numpy()[...] = a
            sp.add(bytes=t.nbytes)
            out.append(t)
    return out


def _decode_groups(view: TsqxView, dev: torch.device, lo: int, hi: int):
    """Groups [lo, hi) through the gang kernel on ``dev``: (words,
    sizes)."""
    planes = to_device(_host_planes(view, lo, hi, dev.type == "cuda"), dev)
    words = DGK.decode_gang_batch(*planes, nblk=view.nblk,
                                  slot_recs=view.slot_recs)
    return words, view.block_sizes[lo * view.nblk:hi * view.nblk]


def decode_to_words(view: TsqxView, device=None, groups: slice = None):
    """Decode (a slice of) a TSQX container's groups with the gang kernel
    and leave the words on the devices; returns (words, sizes).

    ``groups`` picks a contiguous range ``[lo, hi)`` of groups (default
    all; ``hi`` is clamped to the group count). It pads to a whole number
    of equal shards over every device of ``device`` in every process with
    all-zero groups, kernel no-ops, as the reference pads it
    (``mesh.padded_shards``, in groups). ``words`` is a
    ``mesh.BlockShards`` of global shape (B, OUT_ROWS, 128) int32, B =
    nblk times the padded groups; this process holds its own shards, each
    decoded through the gang kernel on its device (the kernel's plain
    version on the CPU), every shard launched before any is waited for.
    Row b holds block ``lo * nblk + b``'s decoded bytes as little-endian
    words, its first ``sizes[b]`` bytes defined; ``sizes`` covers every
    row, 0 for a padding block. ``device`` as in ``decompress`` (default
    every CUDA device; raises where there is none)."""
    g = groups if groups is not None else slice(0, view.n_groups)
    lo = g.start or 0
    hi = min(g.stop if g.stop is not None else view.n_groups, view.n_groups)
    spread = _Spread(device, max(hi - lo, 0), 0, BATCH_GROUPS)
    n_pad, rows = mesh_mod.padded_shards(hi - lo, len(spread.devices))
    nblk, shards = view.nblk, []
    for sl, dev in zip(rows, spread.devices):
        a, b = lo + sl.start, min(lo + sl.stop, hi)
        data = torch.zeros(((sl.stop - sl.start) * nblk, OUT_ROWS, LANES),
                           dtype=torch.int32, device=dev)
        if a < b:  # padding groups launch nothing
            data[:(b - a) * nblk] = _decode_groups(view, dev, a, b)[0]
        shards.append(mesh_mod.Shard(slice(sl.start * nblk, sl.stop * nblk),
                                     dev, data))
    sizes = [view.sizes[b] if b < view.n_blocks else 0
             for b in range(lo * nblk, (lo + n_pad) * nblk)]
    return mesh_mod.BlockShards((n_pad * nblk, OUT_ROWS, LANES),
                                tuple(shards)), sizes


def decompress(data, device=None) -> bytes:
    """TSQX container -> its original bytes. Each batch of
    ``BATCH_GROUPS`` times the shard count groups splits into contiguous
    shards of groups, one on each device of ``device`` (as in
    ``pipeline.decompress``: by default every CUDA device; ``"cpu"`` runs
    the kernel's plain version) in every process, each decoded through the
    gang kernel on its device; batch k + 1 is launched before batch k is
    drained. With several processes rank 0 returns the bytes and the
    others ``b""``."""
    with profiling.call("decode.call", route="tsqx") as sp:
        with profiling.span("decode.scan"):
            view = TsqxView(data)
        spread = _Spread(device, view.n_groups, 0, BATCH_GROUPS)
        sp.add(shards=spread.n_shards)
        nblk = view.nblk

        def launch(a, b, dev, card):
            with profiling.span("decode.window", blocks=(b - a) * nblk,
                                groups=b - a, card=card):
                return _Pending(*_decode_groups(view, dev, a, b), card=card)

        def batches():
            for lo in range(0, view.n_groups, spread.window):
                yield [_Shard(a * nblk, b * nblk, rank,
                              None if dev is None else launch(a, b, dev, card))
                       for a, b, rank, dev, card in spread.shards(
                           lo, min(lo + spread.window, view.n_groups))]

        out = _to_host0(_lookahead(batches()), view.block_sizes,
                        view.total_size)
        sp.add(bytes_in=len(data), bytes_out=len(out), blocks=view.n_blocks)
    return out
