"""Block geometry shared by the decode kernels, word-plane helpers, and the
plain reconstruction of one format pair.

Every plane crosses the kernel boundary as ``(rows, 128)`` int32 words,
512 little-endian bytes per row, the layout of the JAX package's kernels
(``turbosqueeze_tpu/kernels/decode_tokens.py``), so the two packages can
be fed the same numpy planes. u32 values ride as their int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from turbosqueeze_tpu.format import BLOCK_SZ, OUTPUT_SZ

LANES = 128
ROW_BYTES = LANES * 4                       # 512 bytes per (1,128) i32 row
OUT_ROWS = BLOCK_SZ // ROW_BYTES + 16       # 4 MiB + overshoot slack
PAY_ROWS = (OUTPUT_SZ + 3) // ROW_BYTES + 16


def planes_to_torch(*arrays, device) -> list:
    """numpy planes -> contiguous int32 tensors on ``device``.

    uint32 planes are reinterpreted, never converted, so words with bit 31
    set keep their bit pattern; the ``(rows, 128)`` layout is kept as is.
    A CUDA copy goes through pinned memory and does not wait: it is
    ordered before later work on the device's current stream.
    """
    device = torch.device(device)
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if a.dtype != np.int32:
            raise TypeError(f"planes are int32 or uint32 words, got {a.dtype}")
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t.to(device))
    return out


def pack_payload_words(payload: bytes, pay_rows: int = PAY_ROWS) -> np.ndarray:
    buf = np.zeros(pay_rows * ROW_BYTES, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.view("<i4").reshape(pay_rows, LANES)


def words_to_bytes(words, size: int) -> bytes:
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    return np.asarray(words).reshape(-1).view("<u1")[:size].tobytes()


def _source(u: torch.Tensor, s: int, ln: int) -> torch.Tensor:
    """A copy of ``u[s:s + ln]``, with zeros for bytes past the buffer."""
    a, e = min(s, u.numel()), min(s + ln, u.numel())
    if e - a == ln:
        return u[a:e].clone()
    return torch.cat([u[a:e], u.new_zeros(ln - (e - a))])


def reconstruct_pair(u: torch.Tensor, dst1: int, ln1: int, s1: int,
                     dst2: int, ln2: int, s2: int) -> None:
    """All byte movement of one format pair, in place on the flat uint8
    unified buffer ``u`` = ``[payload bytes | output bytes]``.

    Positions are unified byte addresses. Both tokens' sources are read
    before either is written, as the kernels do: the format's anchor rule
    makes a pair read-independent, and a corrupt pair then still has one
    defined result. Bytes past the buffer read as zero and are not
    written; trailing pad symbols of a block land there or past its size.
    """
    vals = ((dst1, _source(u, s1, ln1)), (dst2, _source(u, s2, ln2)))
    for dst, val in vals:
        e = min(dst + val.numel(), u.numel())
        if dst < e:
            u[dst:e] = val[:e - dst]
