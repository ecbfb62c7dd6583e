"""Raw-payload decode: parses the ``.tsq`` block bitstream and rebuilds the
block, with the compressed payload as the only input.

On a CUDA tensor ``decode_stream_batch`` launches the Hopper kernel
``csrc/decode_stream.cu``; on a CPU tensor it runs the plain PyTorch version
beside it. Both compute what the Pallas kernel
``turbosqueeze_tpu/kernels/decode_stream.py::_decode_stream_kernel``
computes: starting at payload byte 3 and output byte ``dict_len``, each
control group (a ctrl byte, then per pair a size byte and two symbols) is
parsed into tokens and applied pair by pair, while the output cursor is
below ``dict_len + size``. The preset dictionary, if any, is staged at the
head of the output. Bytes past ``dict_len + size`` are unspecified.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .decode_tokens import LANES, OUT_ROWS, ROW_BYTES, reconstruct_pair

_WIN_ROWS = 8   # the reference kernel's parse window; pay_rows is a multiple

# kernel launches since the count was last reset (a CPU call is not one)
launches = 0


def decode_stream_batch(payload_words: torch.Tensor, meta: torch.Tensor,
                        dict_words: torch.Tensor | None = None, *,
                        out_rows: int = OUT_ROWS) -> torch.Tensor:
    """Decode a batch of blocks from their raw payload words.

    payload_words: (B, pay_rows, 128) int32 zero-padded payloads.
    meta: (B, 8) int32 ``[ext, declared_size, dict_len, 0...]`` per block.
    dict_words: optional (dict_rows, 128) int32 preset dictionary shared by
    every block; decoded bytes follow it, so callers slice
    ``[dict_len : dict_len + size]``.
    Returns (B, out_rows, 128) int32 decoded words on the inputs' device.
    """
    B, pay_rows, _ = payload_words.shape
    if pay_rows % _WIN_ROWS or pay_rows < _WIN_ROWS:
        raise ValueError(
            f"pay_rows must be a positive multiple of {_WIN_ROWS}, "
            f"got {pay_rows}")
    dev = payload_words.device
    if dict_words is None:
        dict_words = torch.zeros((0, LANES), dtype=torch.int32, device=dev)
    checks = (("payload_words", payload_words, (B, pay_rows, LANES)),
              ("meta", meta, (B, 8)),
              ("dict_words", dict_words, (dict_words.shape[0], LANES)))
    for name, t, shape in checks:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payload_words on "
                             f"{dev}")
    if dev.type == "cpu":
        return _decode_stream_plain(payload_words, meta, dict_words,
                                    out_rows=out_rows)
    if dev.type != "cuda":
        raise ValueError(f"no stream kernel for device {dev}")
    return _launch(payload_words, meta, dict_words, out_rows)


def _launch(payload_words, meta, dict_words, out_rows):
    global launches
    payload_words, meta, dict_words = (
        t.contiguous() for t in (payload_words, meta, dict_words))
    B, pay_rows, _ = payload_words.shape
    lib = _build.library()
    with torch.cuda.device(payload_words.device):
        out = torch.zeros((B, out_rows, LANES), dtype=torch.int32,
                          device=payload_words.device)
        if B == 0:
            return out
        err = lib.tsq_decode_stream(
            payload_words.data_ptr(), meta.data_ptr(), dict_words.data_ptr(),
            out.data_ptr(), B, pay_rows, out_rows, dict_words.shape[0],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "decode_stream")
    launches += 1
    return out


# --- plain PyTorch version ---------------------------------------------------

def _pairs(pay: np.ndarray, ext: bool, start: int, end: int):
    """Parse one block's payload bytes, from output byte ``start`` while
    the output cursor is below ``end``; yields each format pair's
    (dst1, ln1, src1, dst2, ln2, src2) in unified byte addresses. Bytes
    past the payload plane read as zero."""
    pay_bytes = len(pay)

    def byte(i):
        return int(pay[i]) if i < pay_bytes else 0

    i, j = 3, start
    while j < end:
        ctrl = byte(i)
        i += 1
        for pair in range(4):
            size_byte = byte(i)
            i += 1
            anchor = j
            toks = []
            for half in range(2):
                nib = size_byte & 15 if half else size_byte >> 4
                if (ctrl >> (7 - 2 * pair - half)) & 1:  # literal
                    ln, src = nib + 1, i
                    i += ln
                else:
                    ln = 32 + 16 * nib if ext and nib < 3 else nib + 1
                    off = byte(i) | (byte(i + 1) << 8)
                    src = max(pay_bytes + anchor - off, 0)
                    i += 2
                toks += [pay_bytes + j, ln, src]
                j += ln
            yield toks


def _decode_stream_plain(payload_words, meta, dict_words, *, out_rows):
    B, pay_rows, _ = payload_words.shape
    pay_bytes, out_bytes = pay_rows * ROW_BYTES, out_rows * ROW_BYTES
    out = torch.zeros((B, pay_bytes + out_bytes), dtype=torch.uint8)
    dict_bytes = dict_words.contiguous().view(torch.uint8).reshape(-1)
    nd = min(dict_bytes.numel(), out_bytes)
    for b, (ext, size, dict_len) in enumerate(meta[:, :3].tolist()):
        u = out[b]
        u[:pay_bytes] = payload_words[b].contiguous().view(
            torch.uint8).reshape(-1)
        u[pay_bytes:pay_bytes + nd] = dict_bytes[:nd]
        # a group at or past the output's end writes nothing: stop there
        end = min(dict_len + size, out_bytes)
        for toks in _pairs(u[:pay_bytes].numpy(), ext != 0, dict_len, end):
            reconstruct_pair(u, *toks)
    return out[:, pay_bytes:].contiguous().view(torch.int32).reshape(
        B, out_rows, LANES)


# --- host-side glue ----------------------------------------------------------

def pack_meta(payloads_ext, sizes, dict_len: int = 0) -> np.ndarray:
    """(ext, size, dict_len) scalars per block for decode_stream_batch."""
    meta = np.zeros((len(payloads_ext), 8), dtype=np.int32)
    for k, (ext, size) in enumerate(zip(payloads_ext, sizes)):
        meta[k, :3] = (1 if ext else 0, size, dict_len)
    return meta


def pack_dict_words(dictionary: bytes) -> np.ndarray:
    """Preset dictionary -> zero-padded (rows, 128) int32 words."""
    rows = max(-(-len(dictionary) // ROW_BYTES), 1)
    rows = -(-rows // 8) * 8
    buf = np.zeros(rows * ROW_BYTES, dtype=np.uint8)
    buf[:len(dictionary)] = np.frombuffer(dictionary, dtype=np.uint8)
    return buf.view("<i4").reshape(rows, LANES)
