"""Device decode and encode of a ``.tsq`` container: the port of
``turbosqueeze_tpu/parallel/pipeline.py::decompress`` and ``::compress``.

Blocks stream through the device in windows.

Decode: for each window the host scans the block table, resolves every
block with the native core (``native.bulk_prep``, then
``native.bulk_gang``) into literal planes and a gang stream, and the gang
kernel decodes the window; a window with a block the resolver declines
goes through the raw-payload stream kernel instead. Blocks are assembled in
order on the host and the total is checked against the container's
declared size. Kernel launches and the device-to-host copy into pinned
memory are asynchronous, so window k+1's host resolve runs while window k
decodes; each window is waited for only when it is drained.

Encode: the host packs each window's bytes into pinned memory and copies
them to the device, where the level picks the route: level 0 runs the
upstream's hash-table parse in the emit kernel; level 1 runs phase A (the
candidate search) and then the emit kernel on its candidates; level >= 2
runs phase A and sends the candidates back for the native core's lazy
parse on the host. Only each window's live payload prefix comes back.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from turbosqueeze_tpu.format import (ContainerHeader, FormatError,
                                     pack_block_header, scan_block_table,
                                     split_blocks)

from ..kernels import decode_gang as DGK
from ..kernels import decode_stream as DST
from ..kernels import decode_tokens as DK
from ..kernels import encode_emit as EE
from ..kernels import encode_xla as EX
from ..kernels.decode_tokens import planes_to_torch
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


def _declared_sizes(stream, table_window):
    """Per-block decoded sizes from the 3-byte declared-size headers."""
    return [stream[off] | (stream[off + 1] << 8) | (stream[off + 2] << 16)
            if psz >= 3 else 0 for off, psz, _ in table_window]


class _Pending:
    """A window's decoded words on their way to the host: ``host`` is
    final once ``done`` (a CUDA event, or None on the CPU) has fired."""

    def __init__(self, words: torch.Tensor, sizes: List[int]):
        self.sizes = sizes
        if words.device.type == "cuda":
            self.host = torch.empty(words.shape, dtype=words.dtype,
                                    pin_memory=True)
            self.host.copy_(words, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(words.device))
        else:
            self.host, self.done = words, None

    def blocks(self) -> List[bytes]:
        if self.done is not None:
            self.done.synchronize()
        flat = self.host.view(torch.uint8).reshape(self.host.shape[0], -1)
        return [flat[b, :n].numpy().tobytes()
                for b, n in enumerate(self.sizes)]


def _bulk_window_words(stream, table_window, device, pool):
    """Resolve one window of blocks on the host and launch the gang kernel
    on it. Returns the pending words, or None when the resolver declines a
    block (the window then goes to the stream kernel)."""
    payloads = [(stream[off:off + psz], ext) for off, psz, ext in table_window]
    planes = DGK.prep_gang(payloads, GANG_NBLK, GANG_SRECS[GANG_NBLK],
                           map_fn=pool.map)
    if planes is None:
        return None
    lit, gang, gmeta, _ = planes
    words = DGK.decode_gang_batch(
        *planes_to_torch(lit, gang, gmeta, device=device), nblk=GANG_NBLK,
        slot_recs=GANG_SRECS[GANG_NBLK])
    return _Pending(words, _declared_sizes(stream, table_window))


def _decode_window_stream(stream, table_window, device):
    """Launch the raw-payload stream kernel on one window of blocks."""
    sizes = _declared_sizes(stream, table_window)
    pw = np.zeros((len(table_window), DK.PAY_ROWS, DK.LANES), np.int32)
    for b, (off, psz, _) in enumerate(table_window):
        pw[b] = DK.pack_payload_words(stream[off:off + psz])
    meta = DST.pack_meta([ext for _, _, ext in table_window], sizes)
    words = DST.decode_stream_batch(
        *planes_to_torch(pw, meta, device=device), out_rows=DK.OUT_ROWS)
    return _Pending(words, sizes)


def decompress(stream: bytes, device=None, impl: str = "auto",
               window_blocks: int = 0, progress=None) -> bytes:
    """Decode a ``.tsq`` container on ``device`` -> its bytes.

    device: a CUDA device (default: the first), or ``"cpu"`` for the
    kernels' plain PyTorch versions; a CUDA device with no GPU raises.
    impl: ``"gang"`` = host resolve + gang kernel, with the stream kernel
    for windows the resolver declines; ``"stream"`` = the stream kernel
    for every window; ``"auto"`` = gang when the native core is built,
    else stream. window_blocks: blocks per window (default
    ``WINDOW_BLOCKS``). progress: called with ``(blocks_done, n_blocks)``
    once per block, in block order, as the blocks are assembled.
    """
    from turbosqueeze_tpu.runtime import native

    # available() also loads the core: its loader is not safe to enter
    # from the pool's threads at once
    have_native = native.available()
    if impl == "auto":
        impl = "gang" if have_native else "stream"
    if impl not in ("gang", "stream"):
        raise ValueError(f"unknown impl: {impl!r}")
    if impl == "gang" and not have_native:
        raise RuntimeError("impl='gang' needs the native core "
                           "(run `make -C csrc`)")
    dev = mesh_mod.block_devices(device)[0]
    if window_blocks <= 0:
        window_blocks = WINDOW_BLOCKS

    hdr, table = scan_block_table(stream)
    wins = [table[lo:lo + window_blocks]
            for lo in range(0, len(table), window_blocks)]
    parts: List[bytes] = []

    def drain(p: _Pending) -> None:
        for part in p.blocks():
            parts.append(part)
            if progress is not None:
                progress(len(parts), len(table))

    pending = None
    with ThreadPoolExecutor() as pool:  # the native core releases the GIL
        for win in wins:
            cur = (_bulk_window_words(stream, win, dev, pool)
                   if impl == "gang" else None)
            if cur is None:
                cur = _decode_window_stream(stream, win, dev)
            if pending is not None:  # drain window k after launching k+1
                drain(pending)
            pending = cur
    if pending is not None:
        drain(pending)
    out = b"".join(parts)
    if len(out) != hdr.total_size:
        raise FormatError(
            f"decoded {len(out)} bytes, container declares {hdr.total_size}")
    return out


# --- compress ----------------------------------------------------------------

def _upload_window(win: List[bytes], dictionary, device) -> torch.Tensor:
    """A window's blocks -> (B, IN_ROWS * 512) uint8 on ``device``: each
    row is concat(dictionary, block), zero-padded. Packed on the host in
    pinned memory and copied without waiting."""
    d = dictionary or b""
    cuda = device.type == "cuda"
    host = torch.zeros((len(win), EE.IN_ROWS * DK.ROW_BYTES),
                       dtype=torch.uint8, pin_memory=cuda)
    rows = host.numpy()
    for b, blk in enumerate(win):
        rows[b, :len(d)] = np.frombuffer(d, dtype=np.uint8)
        rows[b, len(d):len(d) + len(blk)] = np.frombuffer(blk, dtype=np.uint8)
    return host.to(device, non_blocking=True) if cuda else host


def _phase_a(batch: torch.Tensor, win: List[bytes], dlen: int) -> torch.Tensor:
    """Candidates over each row's first ``dlen + longest block`` bytes: the
    zero padding past that adds no entry below any block's end."""
    return EX.find_candidates(batch[:, :dlen + max(map(len, win))])


def _emit_window(batch, cands, win, dlen: int, ext: bool):
    """The emit kernel on a window: the ``"table"`` matcher without
    candidates, else ``"cand"``. Returns (payload words, osz)."""
    B, dev = len(win), batch.device
    input_words = batch.view(torch.int32).reshape(B, EE.IN_ROWS, DK.LANES)
    meta = torch.from_numpy(EE.pack_meta([len(b) for b in win], dlen))
    cand_words = None
    if cands is not None:
        cand_words = torch.full((B, EE.CAND_ROWS * DK.LANES), -1,
                                dtype=torch.int32, device=dev)
        cand_words[:, :cands.shape[1]] = cands
        cand_words = cand_words.view(B, EE.CAND_ROWS, DK.LANES)
    return EE.emit_batch(input_words, cand_words, meta.to(dev), ext=ext,
                         matcher="cand" if cands is not None else "table")


def _download_window(words: torch.Tensor, osz: torch.Tensor) -> List[bytes]:
    """Each block's payload, copying back only the live prefix of the
    output plane (the rows up to the longest payload)."""
    sizes = osz[:, 0].tolist()
    if min(sizes) < 1:
        raise RuntimeError(f"emit kernel refused a block: osz {sizes}")
    rows = -(-max(sizes) // DK.ROW_BYTES)
    flat = words[:, :rows].cpu().contiguous().view(torch.uint8).reshape(
        len(sizes), -1)
    return [flat[b, :n].numpy().tobytes() for b, n in enumerate(sizes)]


def compress(data: bytes, ext: bool = True, level: int = 1, device=None,
             dictionary: bytes = None, progress=None, emit_impl: str = "scan",
             window_blocks: int = 0) -> bytes:
    """Encode ``data`` into a ``.tsq`` container on ``device``.

    The container is byte-identical to ``native.compress(data, ext,
    level)``, or with ``dictionary`` to ``native.compress_dict``. Level 0
    is the upstream's parse (the emit kernel's ``"table"`` matcher, no
    phase A). Level 1 runs phase A and the ``"cand"`` matcher. Level >= 2
    runs phase A on the device and the native core's lazy parse of those
    candidates on the host, in a thread pool. A dictionary (1..65532 bytes)
    lifts the level to at least 1; every block is searched and parsed as
    concat(dictionary, block).

    device: a CUDA device (default: the first), or ``"cpu"`` for the
    kernels' plain PyTorch versions; a CUDA device with no GPU raises.
    progress: called with ``(blocks_done, n_blocks)`` once per block, in
    block order. emit_impl: only ``"scan"``, the single-pass emitter, is
    ported. window_blocks: blocks per window (default ``WINDOW_BLOCKS``).
    """
    from turbosqueeze_tpu.runtime import native

    if emit_impl in ("bulk", "flat"):
        raise NotImplementedError(
            f"emit_impl={emit_impl!r} is not ported yet (ROADMAP.md, queue "
            f"2: the encode_bulk and encode_flat kernels)")
    if emit_impl != "scan":
        raise ValueError(f"unknown emit_impl: {emit_impl!r}")
    # available() loads the core here, before the pool's threads need it
    if level >= 2 and not native.available():
        raise RuntimeError("level >= 2 needs the native core "
                           "(run `make -C csrc`)")
    dlen = 0
    if dictionary is not None:
        if not 0 < len(dictionary) <= native.MAX_DICT:
            raise ValueError(f"dictionary must be 1..{native.MAX_DICT} bytes")
        dlen, level = len(dictionary), max(level, 1)
    dev = mesh_mod.block_devices(device)[0]
    if window_blocks <= 0:
        window_blocks = WINDOW_BLOCKS

    blocks = split_blocks(data)
    parts = [ContainerHeader(len(blocks), len(data)).pack()]
    with ThreadPoolExecutor() as pool:  # the native core releases the GIL
        for lo in range(0, len(blocks), window_blocks):
            win = blocks[lo:lo + window_blocks]
            batch = _upload_window(win, dictionary, dev)
            cands = _phase_a(batch, win, dlen) if level >= 1 else None
            if level <= 1:
                payloads = _download_window(
                    *_emit_window(batch, cands, win, dlen, ext))
            else:
                host = cands.cpu().numpy()

                def emit(b):
                    blk = win[b]
                    if dictionary is not None:
                        return native.encode_block_dict(
                            blk, dictionary, host[b, :dlen + len(blk)], ext,
                            level=level)
                    return native.encode_block_candidates(
                        blk, host[b, :len(blk)], ext, level=level)

                payloads = list(pool.map(emit, range(len(win))))
            for b, payload in enumerate(payloads):
                parts += [pack_block_header(len(payload), ext), payload]
                if progress is not None:
                    progress(lo + b + 1, len(blocks))
    return b"".join(parts)
