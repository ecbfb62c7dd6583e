"""Device decode and encode of a ``.tsq`` container: the port of
``turbosqueeze_tpu/parallel/pipeline.py::decompress``,
``::decompress_to_file``, ``::decompress_to_words`` and ``::compress``.

Blocks stream through the device in windows.

Decode: for each window the host scans the block table and prepares the
blocks for the route ``impl`` names:

  * ``"gang"``: the native core resolves every block (``native.bulk_prep``,
    then ``native.bulk_gang``) into literal planes and a gang stream, and
    the gang kernel decodes the window; a window with a block the resolver
    declines goes through the stream kernel instead;
  * ``"bulk"``, ``"bulk2"``, ``"bulkn"``: the same resolve, then the bulk
    kernel runs the record streams as they are (``bulk``), zipped in block
    pairs (``native.bulk_merge2``) or in groups of the JAX package's
    co-schedule width, 4, 2 or 1 (``native.bulk_mergen``); a declined
    window goes through the stream kernel;
  * ``"stream"``: the raw payloads are the only input of the stream kernel,
    which parses them on the card;
  * ``"pallas"``: the native tokenizer parses every block on the host, in a
    thread pool, and the token-chunk kernel moves the bytes;
  * ``"xla"``: the same tokens go through the scatter/gather decode of
    ``kernels/decode_xla.py``, in torch ops on the device.

The default, ``"auto"``, is chosen for each shard by its device
(``_route``): ``"stream"`` on a CUDA device, where the host resolve would
idle the card, and ``"gang"`` on any other.

A preset dictionary rides every route in the dict-extended output space
``[0, dict_len + size)``: the resolver stages it in the literal plane (up
to a third 2 MiB gang window), the stream kernel at the head of the output,
and the tokenizer's routes as synthetic literal tokens
(``block.tokenize_with_dict``); each block is sliced at ``dict_len``.
Blocks are assembled in order on the host (``decompress_to_file`` writes
each at its fixed 4 MiB offset instead) and the total is checked against
the container's declared size. Kernel launches and the device-to-host copy
into pinned memory are asynchronous, so window k+1's host work runs while
window k decodes; each window is waited for only when it is drained.

Every entry point spreads a window's blocks over every local device of
every process (``mesh.py``): the window splits into contiguous shards, one
a device, and each process prepares and launches only its own shards. With
several processes (``mesh.init_distributed``, gloo) a decode's blocks meet
on rank 0 (``_to_host0``; the other ranks return ``b""``),
``decompress_to_file`` writes each rank's blocks into the one file, and
``compress`` hands every payload to every rank, so each returns the whole
container. ``decompress_to_words`` instead pads the blocks to a whole
number of equal shards, the reference's geometry, and leaves each shard's
words on its device (``mesh.BlockShards``).

Encode: the host packs each window's bytes into pinned memory and copies
them to the device, where the level picks the route: level 0 runs the
upstream's hash-table parse in the emit kernel; level 1 runs phase A (the
candidate search) and then a level-1 emitter on its candidates, the one
``emit_impl`` names: ``"scan"``, the single-pass emit kernel; ``"bulk"``,
the decide kernel and the assemble pass (``kernels/encode_bulk.py``);
``"flat"``, the flat decide kernel and the sort layout
(``kernels/encode_flat.py``). Level >= 2 runs phase A and sends the
candidates back for the native core's lazy parse on the host. Only each
window's live payload prefix comes back; a block that the bulk or flat
emitter flags as overflowed is emitted on the host from its candidates.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..format import (BLOCK_SZ, ContainerHeader, FormatError,
                      pack_block_header, scan_block_table, split_blocks)
from ..kernels import decode_bulk as DBK
from ..kernels import decode_gang as DGK
from ..kernels import decode_stream as DST
from ..kernels import decode_tokens as DK
from ..kernels import decode_xla as DXL
from ..kernels import encode_bulk as EB
from ..kernels import encode_emit as EE
from ..kernels import encode_flat as EF
from ..kernels import encode_xla as EX
from ..kernels.decode_tokens import planes_to_torch
from ..runtime import native
from ..utils import profiling
from . import mesh as mesh_mod

# records per gang slot by co-schedule width: the JAX package's table. The
# port decodes one block per CTA, so co-scheduling blocks in one stream
# buys nothing on the card; it runs one block per group, the width whose
# stream is shortest (no padding gangs for shorter group members).
GANG_SRECS = {1: 8, 2: 16, 3: 16, 4: 16, 6: 16}
GANG_NBLK = 1

# blocks per window: one CTA decodes one block, so a window should put many
# blocks in flight; 32 blocks is 128 MiB of output per window
WINDOW_BLOCKS = 32
# the xla route holds a few int64 index arrays over every byte of its
# window: 16 full blocks make each about 0.55 GB on the device
XLA_WINDOW_BLOCKS = 16

_DICT_PAD = 1 << 16  # dict-extended output/payload headroom (bucketed)

_EMITTERS = ("scan", "bulk", "flat")  # the level-1 emitters of compress
# blocks the bulk and flat emitters flagged as overflowed, emitted on the
# host instead, since the count was last reset
overflow_blocks = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _declared_sizes(stream, table_window):
    """Per-block decoded sizes from the 3-byte declared-size headers."""
    return [stream[off] | (stream[off + 1] << 8) | (stream[off + 2] << 16)
            if psz >= 3 else 0 for off, psz, _ in table_window]


class _Pending:
    """A window's decoded words on their way to the host: ``host`` is
    final once ``done`` (a CUDA event, or None on the CPU) has fired.
    Block b's bytes are ``[base, base + sizes[b])`` of its row; ``card``
    names the shard's device on the wait's span (``_Spread.cards``)."""

    def __init__(self, words: torch.Tensor, sizes: List[int], base: int = 0,
                 card: int = 0):
        self.sizes, self.base, self.card = sizes, base, card
        if words.device.type == "cuda":
            self.host = torch.empty(words.shape, dtype=words.dtype,
                                    pin_memory=True)
            self.host.copy_(words, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(words.device))
        else:
            self.host, self.done = words, None

    def views(self) -> List[torch.Tensor]:
        """Each block's bytes, as uint8 views of the host copy."""
        if self.done is not None:
            with profiling.span("decode.drain", card=self.card):
                self.done.synchronize()
        flat = self.host.view(torch.uint8).reshape(self.host.shape[0], -1)
        return [flat[b, self.base:self.base + n]
                for b, n in enumerate(self.sizes)]



class _Shard(NamedTuple):
    """A window's blocks ``[lo, hi)`` on one device of process ``rank``;
    ``pending`` holds their decoded words on this process, None on
    another."""
    lo: int
    hi: int
    rank: int
    pending: Optional[_Pending]


def _agree_max(values) -> List[int]:
    """Element-wise max of each process's int list: one all-gather of a
    short int64 tensor, nothing in one process."""
    n = mesh_mod.process_count()
    if n == 1:
        return [int(v) for v in values]
    mine = torch.tensor(values, dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine)
    return torch.stack(every).max(0).values.tolist()


class _Spread:
    """One call's shards: this process's devices, the global shard count
    ``n_shards`` (local devices times processes, each process holding the
    next run of shards in rank order) and the window, in blocks (TSQX:
    groups). Made once a call, on every process: it agrees the local
    device count, the call's block count and its ``window`` argument across
    processes and raises ``ValueError`` on every process when they differ.

    Each process launches its own kernels, so no plane shape needs
    agreeing. The JAX package agrees its resolver's fallback for a whole
    window across processes (``pipeline.py:759``); here each shard decides
    alone, and a shard the resolver declines goes to the stream kernel:
    the bytes are the same.

    ``cards`` names each local device on its shards' spans: its CUDA
    ordinal, or its position among the devices where it has none (the
    CPU) or shares it with another (a card named twice)."""

    def __init__(self, device, n_items: int, window: int, default: int):
        self.devices = mesh_mod.block_devices(device)
        self.rank = mesh_mod.process_index()
        mine = [len(self.devices), n_items, window]
        agreed = _agree_max(mine + [-v for v in mine])
        if agreed[:3] != [-v for v in agreed[3:]]:
            raise ValueError(
                f"processes disagree on (local devices, blocks, window): "
                f"this one has {tuple(mine)}, the largest are "
                f"{tuple(agreed[:3])}")
        self.n_shards = len(self.devices) * mesh_mod.process_count()
        index = [d.index for d in self.devices]
        self.cards = (index if None not in index
                      and len(set(index)) == len(index)
                      else list(range(len(index))))
        self.window = window if window > 0 else default * self.n_shards

    def shards(self, lo: int, hi: int):
        """Each non-empty shard of items ``[lo, hi)``, in order: (first,
        end, rank, device, card), device and card None for another
        process's shard."""
        n_dev = len(self.devices)
        for s, (a, b) in enumerate(mesh_mod.shard_bounds(hi - lo,
                                                         self.n_shards)):
            if a < b:
                rank = s // n_dev
                mine = rank == self.rank
                yield (lo + a, lo + b, rank,
                       self.devices[s % n_dev] if mine else None,
                       self.cards[s % n_dev] if mine else None)


def _lookahead(windows):
    """Yields each window of ``windows`` (a generator that launches each as
    it is asked for) only once the next one has been launched, so that
    draining window k overlaps window k + 1."""
    pending = None
    for cur in windows:
        if pending is not None:
            yield pending
        pending = cur
    if pending is not None:
        yield pending


def _result_buffer(total_size: int):
    """A fresh bytes object of ``total_size`` and a writable numpy view of
    it: the result is written here before anything else sees it."""
    out, ptr = native._alloc_exact_bytes(total_size)
    dst = (np.ctypeslib.as_array((ctypes.c_uint8 * total_size)
                                 .from_address(ptr))
           if total_size else np.empty(0, np.uint8))
    return out, dst


# the most bytes one transfer of the host-0 hop carries, as in the JAX
# package (there a cap on one coordination-service value)
_HOST0_CHUNK = 4 << 20


def _check_sizes(sizes, total_size: int) -> None:
    """Block sizes that fit a block and sum to the container's size, or
    ``FormatError``: checked on every process before any block crosses
    one, so that a corrupt container raises everywhere instead of leaving
    a peer waiting."""
    if max(sizes, default=0) > BLOCK_SZ:
        raise FormatError(f"a block declares {max(sizes)} bytes, past "
                          f"{BLOCK_SZ}")
    if sum(sizes) != total_size:
        raise FormatError(f"blocks declare {sum(sizes)} bytes, the "
                          f"container declares {total_size}")


def _local_blocks(shard: _Shard, sizes: List[int]):
    """(block, its bytes) of a local shard, each checked against its
    declared size (``FormatError``)."""
    for b, block in zip(range(shard.lo, shard.hi), shard.pending.views()):
        if len(block) != sizes[b]:
            raise FormatError(f"block {b} decoded to {len(block)} bytes, it "
                              f"declares {sizes[b]}")
        yield b, block


def _to_host0(windows, sizes: List[int], total_size: int,
              progress=None) -> bytes:
    """The decoded blocks of every process, in block order, on rank 0 (in
    one process, the process itself); the other ranks return ``b""``, as
    the JAX package's nonzero ranks do.

    ``windows`` yields each window's ``_Shard`` list (the same on every
    process); ``sizes`` is every block's declared size, which every process
    knows from the block table, so no size travels. Rank 0 allocates the
    result, copies each of its own blocks into it once and receives every
    other block straight into its slice of it (``torch.distributed.recv``,
    chunks of at most ``_HOST0_CHUNK``), in block order; ``progress`` is
    called there with ``(blocks_done, n_blocks)`` once per block. The
    other ranks send their blocks in block order. A block whose bytes
    differ from its declared size raises ``FormatError`` before it is sent
    or copied. A rank that fails mid-call leaves its peers waiting until
    the process group's timeout, which then raises there."""
    _check_sizes(sizes, total_size)
    if mesh_mod.process_index() != 0:
        # a window's sends are waited for once the next window's are
        # posted; each holds a view of its pinned copy until then
        sent = []
        for shards in windows:
            with profiling.span("decode.assemble") as sp:
                cur = []
                for sh in shards:
                    if sh.pending is None:
                        continue
                    for b, block in _local_blocks(sh, sizes):
                        cur += [dist.isend(block[c:c + _HOST0_CHUNK], dst=0,
                                           tag=b)
                                for c in range(0, len(block), _HOST0_CHUNK)]
                        sp.add(bytes=len(block))
                for w in sent:
                    w.wait()
                sent = cur
        with profiling.span("decode.assemble"):
            for w in sent:
                w.wait()
        return b""
    with profiling.span("decode.assemble"):
        out, dst = _result_buffer(total_size)
    offs = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).tolist()
    for shards in windows:
        with profiling.span("decode.assemble",
                            bytes=sum(sizes[shards[0].lo:shards[-1].hi])):
            for sh in shards:
                if sh.pending is not None:
                    for b, block in _local_blocks(sh, sizes):
                        dst[offs[b]:offs[b + 1]] = block.numpy()
                else:
                    for b in range(sh.lo, sh.hi):
                        into = torch.from_numpy(dst[offs[b]:offs[b + 1]])
                        for c in range(0, sizes[b], _HOST0_CHUNK):
                            dist.recv(into[c:c + _HOST0_CHUNK], src=sh.rank,
                                      tag=b)
                if progress is not None:
                    for b in range(sh.lo, sh.hi):
                        progress(b + 1, len(sizes))
    return out


def _gang_window(stream, table_window, device, pool, dictionary=None):
    """Resolve one window of blocks on the host and launch the gang kernel
    on it. Returns (words, dict_len), or None when the resolver declines a
    block (the window then goes to the stream kernel)."""
    payloads = [(stream[off:off + psz], ext) for off, psz, ext in table_window]
    planes = DGK.prep_gang(payloads, GANG_NBLK, GANG_SRECS[GANG_NBLK],
                           map_fn=pool.map, dictionary=dictionary,
                           pin=device.type == "cuda")
    if planes is None:
        return None
    base = len(dictionary) if dictionary else 0
    lit, gang, gmeta, _ = planes
    # the dict-extended output may reach into a third 2 MiB window
    words = DGK.decode_gang_batch(
        *planes_to_torch(lit, gang, gmeta, device=device), nblk=GANG_NBLK,
        slot_recs=GANG_SRECS[GANG_NBLK],
        out_rows=3 * DBK.WIN_ROWS if base else DK.OUT_ROWS,
        max_win=3 if base else DBK.MAX_WIN)
    return words, base


def bulk_abi(impl: str, preps):
    """The stream ABI and group width a bulk route decodes a window of
    resolved blocks with: ``bulkn`` takes the JAX package's width, the
    widest of 4 and 2 whose TPU scratch fits the window's (bucketed)
    literal planes, and the single-block ABI where neither does."""
    if impl != "bulkn":
        return impl, {"bulk": 1, "bulk2": 2}[impl]
    lit_rows = _round_up(max(DBK.rows_for_bytes(len(p[0]))
                             for p in preps), 64)
    nblk = next((k for k in (4, 2) if DBK.coschedule_fit(lit_rows, k)), 1)
    return ("bulkn" if nblk > 1 else "bulk"), nblk


def _bulk_window(stream, table_window, device, pool, dictionary=None, *,
                 impl: str):
    """Resolve one window of blocks on the host and launch the bulk kernel
    through the wrapper of ``impl``'s stream ABI. Returns (words,
    dict_len), or None when the resolver declines a block."""
    payloads = [(stream[off:off + psz], ext) for off, psz, ext in table_window]
    preps = DBK.resolve_blocks(payloads, pool.map, dictionary)
    if preps is None:
        return None
    abi, nblk = bulk_abi(impl, preps)
    lit, rec, meta, _ = DBK.pack_batch(preps, abi, nblk, pool.map)
    base = len(dictionary) if dictionary else 0
    # the dict-extended output may reach into a third 2 MiB window
    kw = {"out_rows": 3 * DBK.WIN_ROWS if base else DK.OUT_ROWS,
          "max_win": 3 if base else DBK.MAX_WIN}
    planes = planes_to_torch(lit, rec, meta, device=device)
    return DBK.decode_bulk(abi, nblk, *planes, **kw), base


def _stream_window(stream, table_window, device, pool, dictionary=None):
    """Launch the raw-payload stream kernel on one window of blocks.
    Returns (words, dict_len).

    The payload plane has the rows ``DST.payload_rows`` gives the window's
    longest payload. It is packed one block per task of the pool (numpy's
    copies release the GIL) straight from ``stream``, each byte written
    once, in pinned memory on a CUDA device, as are the meta and
    dictionary planes: ``copy.stage`` restages none of them."""
    dlen = len(dictionary) if dictionary else 0
    sizes = _declared_sizes(stream, table_window)
    pin = device.type == "cuda"
    src = np.frombuffer(stream, np.uint8)
    with profiling.span("host.pack") as sp:
        pay_rows = DST.payload_rows(max(psz for _, psz, _ in table_window))
        small = [DST.pack_meta([ext for _, _, ext in table_window], sizes,
                               dict_len=dlen)]
        if dlen:
            small.append(DST.pack_dict_words(dictionary))
        planes = [torch.empty(shape, dtype=torch.int32, pin_memory=pin)
                  for shape in ((len(table_window), pay_rows, DK.LANES),
                                *(a.shape for a in small))]
        pay = planes[0].numpy().view(np.uint8).reshape(len(table_window), -1)

        def pack(b):
            off, psz, _ = table_window[b]
            DK.fill_row(pay[b], src[off:off + psz])

        list(pool.map(pack, range(len(table_window))))
        for t, a in zip(planes[1:], small):
            t.numpy()[...] = a
        sp.add(bytes=sum(p.nbytes for p in planes), pay_rows=pay_rows)
    # dict-extended writes reach dict_len + size: widen the output
    out_rows = DK.OUT_ROWS + (_DICT_PAD // DK.ROW_BYTES if dlen else 0)
    words = DST.decode_stream_batch(*DK.to_device(planes, device),
                                    out_rows=out_rows)
    return words, dlen


def _tokenize_window(stream, table_window, dictionary, pool):
    """Host tokenization of a window's blocks, one block per task of the
    pool (the native core releases the GIL)."""
    from ..block import tokenize_with_dict

    with profiling.span("host.tokenize", blocks=len(table_window)):
        return list(pool.map(lambda e: tokenize_with_dict(
            stream[e[0]:e[0] + e[1]], e[2], dictionary), table_window))


def _token_planes(parsed, pool, pin: bool):
    """Pack a window's tokenized blocks into the token kernel's planes, one
    block per task of the pool, in pinned memory when ``pin``. Returns
    ((payload, tok_a, tok_b) host tensors, out_rows)."""
    pad_rows = _DICT_PAD // DK.ROW_BYTES if parsed[0][6] else 0
    pay_rows, out_rows = DK.PAY_ROWS + pad_rows, DK.OUT_ROWS + pad_rows
    # the chunk count is bucketed, as in the JAX package
    n_chunks = _round_up(DK.n_chunks_for_tokens(
        max(len(p[1]) for p in parsed)), 64)
    B = len(parsed)
    with profiling.span("host.pack") as sp:
        planes = [torch.empty(shape, dtype=torch.int32, pin_memory=pin)
                  for shape in ((B, pay_rows, DK.LANES),
                                *[(B, n_chunks, DK._SLOT_ROWS, DK.LANES)] * 2)]
        pay, tok_a, tok_b = (p.numpy() for p in planes)

        def pack(b):
            p = parsed[b]
            pay[b] = DK.pack_payload_words(p[0], pay_rows)
            tok_a[b], tok_b[b] = DK.pack_tokens(*p[1:5], n_chunks,
                                                pay_rows=pay_rows)

        list(pool.map(pack, range(B)))
        sp.add(bytes=sum(p.nbytes for p in (pay, tok_a, tok_b)))
    return planes, out_rows


def _pallas_window(stream, table_window, device, pool, dictionary=None):
    """Tokenize one window on the host and launch the token-chunk kernel
    on it. Returns (words, dict_len)."""
    parsed = _tokenize_window(stream, table_window, dictionary, pool)
    planes, out_rows = _token_planes(parsed, pool, device.type == "cuda")
    return (DK.decode_tokens_batch(*DK.to_device(planes, device),
                                   out_rows=out_rows), parsed[0][6])


def _xla_window(stream, table_window, device, pool, dictionary=None):
    """Tokenize one window on the host and decode it with the torch
    scatter/gather formulation. Returns (bytes (B, n_out) uint8,
    dict_len)."""
    parsed = _tokenize_window(stream, table_window, dictionary, pool)
    base = parsed[0][6]
    pad = _DICT_PAD if base else 0
    n_out = DXL.OUT_N + pad
    with profiling.span("host.pack") as sp:
        toks = DXL.pack_token_batch([p[1:5] for p in parsed], n_out)
        pay = DXL.pack_payload_batch([p[0] for p in parsed], DXL.PAY_N + pad)
        sp.add(bytes=sum(a.nbytes for a in (*toks, pay)))
    return DXL.decode_batch_xla(*DK.to_device((*toks, pay), device),
                                n_out=n_out), base


_WINDOW_ROUTES = {"gang": _gang_window, "stream": _stream_window,
                  "pallas": _pallas_window, "xla": _xla_window,
                  **{impl: partial(_bulk_window, impl=impl)
                     for impl in ("bulk", "bulk2", "bulkn")}}


# the routes decompress_to_file takes: the JAX package's set, all but pallas
_FILE_IMPLS = tuple(r for r in _WINDOW_ROUTES if r != "pallas")


def _check_impl(impl: str, routes) -> None:
    if impl not in routes:
        raise ValueError(f"unknown impl: {impl!r}")


def _route(impl: str, device) -> str:
    """The route a shard on ``device`` decodes through: ``"auto"`` is the
    stream kernel on a CUDA device, which parses the raw payload on the
    card with no host resolve, and ``"gang"`` on any other (the kernels'
    plain versions); any other name is itself."""
    if impl != "auto":
        return impl
    return "stream" if device.type == "cuda" else "gang"


def _check_dictionary(dictionary):
    """A usable dictionary, or None for none (an empty one is none)."""
    if not dictionary:
        return None
    if len(dictionary) > native.MAX_DICT:
        raise ValueError(f"dictionary must be 1..{native.MAX_DICT} bytes")
    return dictionary


def decompress(stream: bytes, device=None, impl: str = "auto",
               window_blocks: int = 0, dictionary: bytes = None,
               progress=None) -> bytes:
    """Decode a ``.tsq`` container on ``device`` -> its bytes.

    device: the devices a window's blocks spread over, one contiguous
    shard each (``mesh.block_devices``): by default every CUDA device; one
    device (``"cuda:1"``, ``"cpu"`` for the kernels' plain PyTorch
    versions) or a sequence of them, repeats allowed. A CUDA device with no
    GPU raises. With several processes (``mesh.init_distributed``) each
    decodes only its own shards, and rank 0 returns the bytes while every
    other rank returns ``b""``.
    impl: ``"gang"`` = host resolve + gang kernel, with the stream kernel
    for shards the resolver declines; ``"bulk"``, ``"bulk2"``,
    ``"bulkn"`` = host resolve + the bulk kernel on single, paired or
    N-way merged record streams, with the same fallback; ``"stream"`` =
    the stream kernel for every window; ``"pallas"`` = host tokenize +
    token-chunk kernel; ``"xla"`` = host tokenize + the torch
    scatter/gather decode; ``"auto"`` = ``"stream"`` on a CUDA device
    and ``"gang"`` on any other, chosen for each shard by its device. The
    host work runs in the native core, which is built at first use.
    window_blocks: blocks per window over all shards (default
    ``WINDOW_BLOCKS``, ``XLA_WINDOW_BLOCKS`` for xla, times the shard
    count, so that each shard keeps one device's geometry). dictionary:
    the preset dictionary the container was compressed with. progress:
    called with ``(blocks_done, n_blocks)`` once per block, in block
    order, as the blocks are assembled (on rank 0).
    """
    _check_impl(impl, ("auto", *_WINDOW_ROUTES))
    with profiling.call("decode.call", route=impl) as sp:
        hdr, table, sizes = _scan(stream)
        windows = _decoded_windows(stream, table, device, impl, window_blocks,
                                   dictionary, sp)
        out = _to_host0(windows, sizes, hdr.total_size, progress)
        sp.add(bytes_in=len(stream), bytes_out=len(out), blocks=len(table))
    return out


def _scan(stream: bytes):
    """The container's header, block table and declared block sizes."""
    with profiling.span("decode.scan"):
        hdr, table = scan_block_table(stream)
        return hdr, table, _declared_sizes(stream, table)


def _decoded_windows(stream, table, device, impl: str, window_blocks: int,
                     dictionary, call):
    """Decode the container's windows through the route ``impl``, each of
    this process's shards on its device through the route ``_route`` gives
    there (the stream kernel for a shard the resolver declines). Yields
    each window's ``_Shard`` list; window k is yielded only after every
    local shard of window k + 1 has been launched. The dictionary, the
    devices and the processes' agreement are checked here, at the call,
    before the caller writes anything; the call's span ``call`` counts its
    shards, and each ``decode.window`` names the route that decoded it."""
    dictionary = _check_dictionary(dictionary)
    spread = _Spread(device, len(table), window_blocks,
                     XLA_WINDOW_BLOCKS if impl == "xla" else WINDOW_BLOCKS)
    call.add(shards=spread.n_shards)

    def launch(lo, hi, dev, card, pool):
        win = table[lo:hi]
        route = _route(impl, dev)
        with profiling.span("decode.window", blocks=hi - lo, card=card,
                            route=route) as sp:
            r = _WINDOW_ROUTES[route](stream, win, dev, pool, dictionary)
            if r is None:  # the resolver declined a block
                sp.add(declined=1)
                sp.set(route="stream")
                r = _stream_window(stream, win, dev, pool, dictionary)
            return _Pending(r[0], _declared_sizes(stream, win), r[1], card)

    def windows():
        with ThreadPoolExecutor() as pool:  # the native core releases the GIL
            for lo in range(0, len(table), spread.window):
                yield [_Shard(a, b, rank, None if dev is None else
                              launch(a, b, dev, card, pool))
                       for a, b, rank, dev, card in spread.shards(
                           lo, min(lo + spread.window, len(table)))]

    return _lookahead(windows())


def decompress_to_file(stream: bytes, out_path, device=None,
                       impl: str = "auto", window_blocks: int = 0,
                       dictionary: bytes = None) -> int:
    """Decode a ``.tsq`` container on ``device`` straight into the file
    ``out_path``; returns the decoded size.

    Every block decodes to at most 4 MiB, so block b's bytes go at
    ``b << 22`` of the file, which rank 0 first creates and truncates to
    the container's size: each window's blocks are written as it drains,
    while the next window decodes, and no output is assembled in memory.
    ``impl`` is one of the JAX package's set (``"stream"``, ``"xla"``,
    ``"bulk"``, ``"bulk2"``, ``"bulkn"``, ``"gang"``) or ``"auto"``
    (``"stream"`` on a CUDA device, ``"gang"`` on any other), run as in
    ``decompress``; ``device``, ``window_blocks`` and ``dictionary`` as
    there. With several processes each writes only its own shards' blocks
    into the one file, between two barriers, and every rank returns the
    container's size.
    """
    _check_impl(impl, ("auto", *_FILE_IMPLS))
    with profiling.call("decode.call", route=impl) as sp:
        hdr, table, sizes = _scan(stream)
        sp.add(bytes_in=len(stream), blocks=len(table))
        windows = _decoded_windows(stream, table, device, impl, window_blocks,
                                   dictionary, sp)
        _check_sizes(sizes, hdr.total_size)
        several = mesh_mod.process_count() > 1
        if mesh_mod.process_index() == 0:
            with open(out_path, "wb") as f:
                f.truncate(hdr.total_size)
        if several:
            dist.barrier()
        written = 0
        with open(out_path, "r+b") as f:
            for shards in windows:
                with profiling.span("decode.assemble") as asm:
                    for sh in shards:
                        if sh.pending is None:
                            continue
                        for b, part in _local_blocks(sh, sizes):
                            f.seek(b << 22)
                            f.write(part.numpy())
                            written += len(part)
                            asm.add(bytes=len(part))
        sp.add(bytes_out=written)
        if several:
            dist.barrier()
            return hdr.total_size
    if written != hdr.total_size:
        raise FormatError(
            f"decoded {written} bytes, container declares {hdr.total_size}")
    return written


def decompress_to_words(stream: bytes, device=None, impl: str = "pallas",
                        window_blocks: int = 0):
    """Decode a ``.tsq`` container and leave the words on the devices.

    Returns (words, sizes, header). ``words`` is a ``mesh.BlockShards`` of
    global shape (B, OUT_ROWS, 128) int32, sharded over every device of
    ``device`` in every process as the reference's ``jax.Array`` is
    (``mesh.padded_shards``): B is the block count padded to a whole number
    of equal shards, at least one row a shard, and this process holds its
    own shards, each an int32 tensor on its device. Global row b holds
    block b's decoded bytes as little-endian words, its first ``sizes[b]``
    bytes defined; padding rows are zero. ``sizes`` is the container's
    declared block sizes, unpadded.

    device: as in ``decompress`` (default every CUDA device; a CUDA device
    with no GPU raises). impl: ``"pallas"`` (host tokenize + token-chunk
    kernel) or ``"stream"`` (the raw-payload stream kernel). Each shard
    decodes its blocks in windows of ``window_blocks`` (default
    ``WINDOW_BLOCKS``) into slices of its tensor, every local shard's
    window launched before the next window of any; each process tokenizes
    and packs only its own shards' blocks, and no bytes cross a process.
    Ranks that disagree on their device count, the block count or
    ``window_blocks`` raise ``ValueError`` on every rank.
    """
    _check_impl(impl, ("pallas", "stream"))
    with profiling.call("decode.call", route=impl) as sp:
        hdr, table, sizes = _scan(stream)
        sp.add(bytes_in=len(stream), blocks=len(table))
        spread = _Spread(device, len(table), window_blocks, WINDOW_BLOCKS)
        sp.add(shards=spread.n_shards)
        window = window_blocks if window_blocks > 0 else WINDOW_BLOCKS
        B, rows = mesh_mod.padded_shards(len(table), len(spread.devices))
        shards = [mesh_mod.Shard(sl, dev, torch.zeros(
            (sl.stop - sl.start, DK.OUT_ROWS, DK.LANES), dtype=torch.int32,
            device=dev)) for sl, dev in zip(rows, spread.devices)]
        with ThreadPoolExecutor() as pool:
            for lo in range(0, B // spread.n_shards, window):
                for sh, card in zip(shards, spread.cards):
                    first = sh.index.start + lo
                    win = table[first:min(first + window, sh.index.stop)]
                    if win:  # padding rows launch nothing
                        with profiling.span("decode.window", blocks=len(win),
                                            card=card):
                            sh.data[lo:lo + len(win)] = _WINDOW_ROUTES[impl](
                                stream, win, sh.device, pool)[0]
    return (mesh_mod.BlockShards((B, DK.OUT_ROWS, DK.LANES), tuple(shards)),
            sizes, hdr)


# --- compress ----------------------------------------------------------------

def _upload_window(win: List[bytes], dictionary, device) -> torch.Tensor:
    """A window's blocks -> (B, IN_ROWS * 512) uint8 on ``device``: each
    row is concat(dictionary, block), zero-padded. Packed on the host in
    pinned memory and copied without waiting."""
    d = dictionary or b""
    with profiling.span("copy.stage", restaged=0) as sp:
        host = torch.zeros((len(win), EE.IN_ROWS * DK.ROW_BYTES),
                           dtype=torch.uint8, pin_memory=device.type == "cuda")
        rows = host.numpy()
        for b, blk in enumerate(win):
            rows[b, :len(d)] = np.frombuffer(d, dtype=np.uint8)
            rows[b, len(d):len(d) + len(blk)] = np.frombuffer(blk,
                                                              dtype=np.uint8)
        return DK.to_device([host], device, sp)[0]


def _phase_a(batch: torch.Tensor, win: List[bytes], dlen: int) -> torch.Tensor:
    """Candidates over each row's first ``dlen + longest block`` bytes: the
    zero padding past that adds no entry below any block's end."""
    return EX.find_candidates(batch[:, :dlen + max(map(len, win))])


def emit_planes(batch, cands, win, dlen: int):
    """A window's emitter planes on its device: input words (B, IN_ROWS,
    128), candidate words (B, CAND_ROWS, 128), -1 padded (None without
    candidates), and meta (B, 8) ``[size, dlen]``."""
    B, dev = len(win), batch.device
    input_words = batch.view(torch.int32).reshape(B, EE.IN_ROWS, DK.LANES)
    # 32 bytes a block, not the window's staging: no span counts them
    (meta,) = DK.to_device([EE.pack_meta([len(b) for b in win], dlen)], dev,
                           profiling.OFF)
    if cands is None:
        return input_words, None, meta
    cand_words = torch.full((B, EE.CAND_ROWS * DK.LANES), -1,
                            dtype=torch.int32, device=dev)
    cand_words[:, :cands.shape[1]] = cands
    return input_words, cand_words.view(B, EE.CAND_ROWS, DK.LANES), meta


def _emit_window(batch, cands, win, dlen: int, ext: bool,
                 emit_impl: str = "scan"):
    """A level-1 emitter on a window (``emit_impl``), or without candidates
    (level 0) the emit kernel's ``"table"`` matcher. Returns (payload
    words, osz)."""
    input_words, cand_words, meta = emit_planes(batch, cands, win, dlen)
    if cands is None:
        return EE.emit_batch(input_words, None, meta, ext=ext,
                             matcher="table")
    if emit_impl == "bulk":
        return EB.emit_bulk_batch(input_words, cand_words, meta, ext=ext)
    if emit_impl == "flat":
        return EF.flat_emit_batch(input_words, cand_words, meta, ext=ext)
    return EE.emit_batch(input_words, cand_words, meta, ext=ext,
                         matcher="cand")


def _download_window(words: torch.Tensor, osz: torch.Tensor,
                     emitter: str) -> List[bytes]:
    """Each block's payload, copying back only the live prefix of the
    output plane (the rows up to the longest payload); None for a block
    the emitter flagged as overflowed."""
    with profiling.span("compress.download") as sp:
        osz = osz.cpu()
        sizes, flagged = osz[:, 0].tolist(), (osz[:, 2] != 0).tolist()
        live = [n for n, f in zip(sizes, flagged) if not f]
        if min(live, default=1) < 1:
            raise RuntimeError(f"the {emitter} emitter refused a block: osz "
                               f"{sizes}")
        rows = max(1, -(-max(live, default=0) // DK.ROW_BYTES))
        flat = words[:, :rows].cpu().contiguous().view(torch.uint8).reshape(
            len(sizes), -1)
        sp.add(bytes=flat.nbytes)
        return [None if f else flat[b, :n].numpy().tobytes()
                for b, (n, f) in enumerate(zip(sizes, flagged))]


def _host_emitter(win, cands, dictionary, ext: bool, level: int):
    """Block b of the window -> its payload, emitted by the native core
    from the device's candidates."""
    host = cands.cpu().numpy()
    dlen = len(dictionary) if dictionary is not None else 0

    def emit(b):
        blk = win[b]
        if dictionary is not None:
            return native.encode_block_dict(blk, dictionary,
                                            host[b, :dlen + len(blk)], ext,
                                            level=level)
        return native.encode_block_candidates(blk, host[b, :len(blk)], ext,
                                              level=level)

    return emit


def compress(data: bytes, ext: bool = True, level: int = 1, device=None,
             dictionary: bytes = None, progress=None, emit_impl: str = "scan",
             window_blocks: int = 0) -> bytes:
    """Encode ``data`` into a ``.tsq`` container on ``device``.

    The container is byte-identical to ``native.compress(data, ext,
    level)``, or with ``dictionary`` to ``native.compress_dict``. Level 0
    is the upstream's parse (the emit kernel's ``"table"`` matcher, no
    phase A). Level 1 runs phase A and a level-1 emitter on its
    candidates (``emit_impl``). Level >= 2
    runs phase A on the device and the native core's lazy parse of those
    candidates on the host, in a thread pool. A dictionary (1..65532 bytes)
    lifts the level to at least 1; every block is searched and parsed as
    concat(dictionary, block).

    device: the devices a window's blocks spread over, as in
    ``decompress`` (default: every CUDA device; ``"cpu"`` for the kernels'
    plain PyTorch versions; a CUDA device with no GPU raises). With several
    processes each compresses its own shards and every rank returns the
    whole container. progress: called with ``(blocks_done, n_blocks)``
    once per block, in block order. emit_impl: the level-1 emitter, for
    level 1 and the dictionary: ``"scan"``, the single-pass emit kernel;
    ``"bulk"``, the two-pass decide and assemble kernels; ``"flat"``, the
    flat decide kernel and the sort layout. Level 0 and level >= 2 ignore
    it. A block that the bulk or flat emitter flags as overflowed is
    emitted on the host from the card's candidates (``overflow_blocks``
    counts them). window_blocks: blocks per window over all shards
    (default ``WINDOW_BLOCKS`` times the shard count).
    """
    if emit_impl not in _EMITTERS:
        raise ValueError(f"unknown emit_impl: {emit_impl!r}")
    if dictionary is not None:
        if not 0 < len(dictionary) <= native.MAX_DICT:
            raise ValueError(f"dictionary must be 1..{native.MAX_DICT} bytes")
        level = max(level, 1)
    with profiling.call("compress.call", bytes_in=len(data),
                        level=level) as call:
        with profiling.span("compress.split"):
            blocks = split_blocks(data)
        call.add(blocks=len(blocks))
        spread = _Spread(device, len(blocks), window_blocks, WINDOW_BLOCKS)

        parts = [ContainerHeader(len(blocks), len(data)).pack()]
        with ThreadPoolExecutor() as pool:  # the native core releases the GIL
            for lo in range(0, len(blocks), spread.window):
                hi = min(lo + spread.window, len(blocks))
                shards = list(spread.shards(lo, hi))
                with profiling.span("compress.window", blocks=hi - lo) as sp:
                    over = overflow_blocks
                    # every local shard is launched before the first is
                    # drained
                    launched = [(a, b, _launch_shard(
                        blocks[a:b], dev, dictionary, ext, level, emit_impl))
                                for a, b, _, dev, _ in shards
                                if dev is not None]
                    mine = {}
                    for a, b, shard in launched:
                        mine.update(zip(range(a, b), _shard_payloads(
                            blocks[a:b], shard, dictionary, ext, level, pool)))
                    sp.add(overflowed=overflow_blocks - over)
                payloads = _share_payloads(shards, mine)
                with profiling.span("compress.join"):
                    for b in range(lo, hi):
                        parts += [pack_block_header(len(payloads[b]), ext),
                                  payloads[b]]
                        if progress is not None:
                            progress(b + 1, len(blocks))
        with profiling.span("compress.join") as sp:
            out = b"".join(parts)
            sp.add(bytes=len(out))
        call.add(bytes_out=len(out))
    return out


def _launch_shard(win: List[bytes], dev, dictionary, ext: bool, level: int,
                  emit_impl: str):
    """Upload a shard's blocks to ``dev`` and launch phase A (level >= 1)
    and, at levels 0-1, the emitter, without waiting: (candidates or None,
    (emitter, its planes) or None)."""
    dlen = len(dictionary) if dictionary is not None else 0
    batch = _upload_window(win, dictionary, dev)
    cands = _phase_a(batch, win, dlen) if level >= 1 else None
    if level >= 2:
        return cands, None
    emitter = emit_impl if cands is not None else "table"
    return cands, (emitter, _emit_window(batch, cands, win, dlen, ext,
                                         emitter))


def _shard_payloads(win: List[bytes], shard, dictionary, ext: bool,
                    level: int, pool) -> List[bytes]:
    """A launched shard's payloads: the emitter's, each block it flagged as
    overflowed emitted on the host from the candidates; at level >= 2
    every block emitted on the host, in the pool."""
    global overflow_blocks
    cands, emitted = shard
    if emitted is None:
        emit = _host_emitter(win, cands, dictionary, ext, level)
        return list(pool.map(profiling.pooled("host.emit", emit),
                             range(len(win))))
    payloads = _download_window(*emitted[1], emitted[0])
    over = [b for b, p in enumerate(payloads) if p is None]
    if over:
        emit = _host_emitter(win, cands, dictionary, ext, level)
        for b in over:
            with profiling.span("host.emit"):
                payloads[b] = emit(b)
        overflow_blocks += len(over)
    return payloads


def _share_payloads(shards, mine: dict) -> dict:
    """Every payload of a window on every process: ``mine`` maps this
    process's blocks to their payloads, ``shards`` is the window's
    ``_Spread.shards`` list. Across processes, one all-gather
    of each rank's payload sizes, then one of its payloads joined and
    padded to the longest rank's; every rank then holds every block."""
    n = mesh_mod.process_count()
    if n == 1:
        return mine
    with profiling.span("compress.share"):
        owned = [[] for _ in range(n)]
        for a, b, rank, _, _ in shards:
            owned[rank] += range(a, b)
        width = max(1, max(map(len, owned)))
        mine_blocks = owned[mesh_mod.process_index()]
        sizes = torch.zeros(width, dtype=torch.int64)
        sizes[:len(mine_blocks)] = torch.tensor(
            [len(mine[b]) for b in mine_blocks], dtype=torch.int64)
        every = [torch.empty_like(sizes) for _ in range(n)]
        dist.all_gather(every, sizes)
        span = max(1, max(int(t.sum()) for t in every))
        joined = torch.zeros(span, dtype=torch.uint8)
        raw = b"".join(mine[b] for b in mine_blocks)
        joined.numpy()[:len(raw)] = np.frombuffer(raw, np.uint8)
        bufs = [torch.empty_like(joined) for _ in range(n)]
        dist.all_gather(bufs, joined)
        out = {}
        for rank in range(n):
            flat, o = bufs[rank].numpy(), 0
            for b, size in zip(owned[rank], every[rank].tolist()):
                out[b] = flat[o:o + size].tobytes()
                o += size
        return out
