"""Device decode of a ``.tsq`` container: the port of
``turbosqueeze_tpu/parallel/pipeline.py::decompress``.

Blocks stream through the device in windows. For each window the host
scans the block table, resolves every block with the native core
(``native.bulk_prep``, then ``native.bulk_gang``) into literal planes and a
gang stream, and the gang kernel decodes the window; a window with a block
the resolver declines goes through the raw-payload stream kernel instead.
Blocks are assembled in order on the host and the total is checked against
the container's declared size.

Kernel launches and the device-to-host copy into pinned memory are
asynchronous, so window k+1's host resolve runs while window k decodes;
each window is waited for only when it is drained.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from turbosqueeze_tpu.format import FormatError, scan_block_table

from ..kernels import decode_gang as DGK
from ..kernels import decode_stream as DST
from ..kernels import decode_tokens as DK
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
               window_blocks: int = 0) -> bytes:
    """Decode a ``.tsq`` container on ``device`` -> its bytes.

    device: a CUDA device (default: the first), or ``"cpu"`` for the
    kernels' plain PyTorch versions; a CUDA device with no GPU raises.
    impl: ``"gang"`` = host resolve + gang kernel, with the stream kernel
    for windows the resolver declines; ``"stream"`` = the stream kernel
    for every window; ``"auto"`` = gang when the native core is built,
    else stream. window_blocks: blocks per window (default
    ``WINDOW_BLOCKS``).
    """
    from turbosqueeze_tpu.runtime import native

    if impl == "auto":
        impl = "gang" if native.available() else "stream"
    if impl not in ("gang", "stream"):
        raise ValueError(f"unknown impl: {impl!r}")
    dev = mesh_mod.block_devices(device)[0]
    if window_blocks <= 0:
        window_blocks = WINDOW_BLOCKS

    hdr, table = scan_block_table(stream)
    wins = [table[lo:lo + window_blocks]
            for lo in range(0, len(table), window_blocks)]
    parts: List[bytes] = []
    pending = None
    with ThreadPoolExecutor() as pool:  # the native core releases the GIL
        for win in wins:
            cur = (_bulk_window_words(stream, win, dev, pool)
                   if impl == "gang" else None)
            if cur is None:
                cur = _decode_window_stream(stream, win, dev)
            if pending is not None:  # drain window k after launching k+1
                parts += pending.blocks()
            pending = cur
    if pending is not None:
        parts += pending.blocks()
    out = b"".join(parts)
    if len(out) != hdr.total_size:
        raise FormatError(
            f"decoded {len(out)} bytes, container declares {hdr.total_size}")
    return out
