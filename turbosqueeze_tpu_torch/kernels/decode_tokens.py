"""Token-chunk decode: moves the bytes of host-parsed tokens. Also the
block geometry shared by the decode kernels, the word-plane helpers, and
the plain reconstruction of one format pair.

Every plane crosses the kernel boundary as ``(rows, 128)`` int32 words,
512 little-endian bytes per row, the layout of the JAX package's kernels
(``turbosqueeze_tpu/kernels/decode_tokens.py``), so the two packages can
be fed the same numpy planes. u32 values ride as their int32 bit patterns.

On a CUDA tensor ``decode_tokens_batch`` launches the Hopper kernel
``csrc/decode_tokens.cu``; on a CPU tensor it runs the plain PyTorch version
beside it. Both compute what the Pallas kernel
``turbosqueeze_tpu/kernels/decode_tokens.py::_decode_pairs_kernel``
computes. A block's bytes live in one unified space, ``[payload plane |
output plane]``. Its tokens (``native.tokenize_block``) come in chunks of
1024 int32 slots: slot 0 holds the live count ``n`` (at most 1022, an even
capacity, so a format pair never splits), slots ``1..n`` the tokens. Word A
is ``dst | len << 24``, word B is ``src``, both unified byte addresses: a
literal's source lies in the payload plane, a match's in the output plane.
Chunks run in order, and within a chunk the tokens run in format pairs; an
odd count leaves the last pair's second token dead. The format's anchor
rule makes the two tokens of a pair read-independent, so a pair reads both
sources before it writes either; a later pair reads what earlier ones
wrote.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format import BLOCK_SZ, OUTPUT_SZ
from ..utils import profiling

from . import _build

LANES = 128
ROW_BYTES = LANES * 4                       # 512 bytes per (1,128) i32 row
OUT_ROWS = BLOCK_SZ // ROW_BYTES + 16       # 4 MiB + overshoot slack
PAY_ROWS = (OUTPUT_SZ + 3) // ROW_BYTES + 16
TOKENS_PER_CHUNK = 1024                     # slot 0 = count; 1022 tokens
_TOKENS_CAP = TOKENS_PER_CHUNK - 2          # even: pairs never split chunks
_SLOT_ROWS = TOKENS_PER_CHUNK // LANES

_DST_MASK = (1 << 24) - 1
_LEN_SHIFT = 24
_LEN_MASK = (1 << 7) - 1

# kernel launches since the count was last reset (a CPU call is not one)
launches = 0


def to_device(arrays, device, span=None) -> list:
    """Host arrays (numpy or CPU tensors) -> tensors on ``device``: the
    port's one host-to-device copy. uint32 arrays go up as the int32 bit
    patterns of their words. A CUDA copy goes up from pinned memory and
    does not wait (it is ordered before later work on the device's
    current stream): a pinned tensor from where it is, any other array
    first copied into pinned memory (``restaged``). On the CPU a tensor
    stays as it is. One ``copy.stage`` span counts ``bytes`` and
    ``restaged``, or ``span`` where the caller has that span open."""
    device = torch.device(device)
    if span is None:
        with profiling.span("copy.stage", restaged=0) as sp:
            return to_device(arrays, device, sp)
    out = []
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = np.ascontiguousarray(a)
            a = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                 else a)
        t = a.contiguous()
        span.add(bytes=t.nbytes)
        if device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
            span.add(restaged=t.nbytes)
        out.append(t.to(device, non_blocking=True))
    return out


def planes_to_torch(*arrays, device) -> list:
    """int32 or uint32 numpy planes, or int32 host tensors -> contiguous
    int32 tensors on ``device`` (``to_device``: uint32 words keep their bit
    pattern); the ``(rows, 128)`` layout is kept as is."""
    for a in arrays:
        if a.dtype not in (torch.int32, np.int32, np.uint32):
            raise TypeError(f"planes are int32 or uint32 words, got "
                            f"{a.dtype}")
    return to_device(arrays, device)


def pack_payload_words(payload: bytes, pay_rows: int = PAY_ROWS) -> np.ndarray:
    buf = np.zeros(pay_rows * ROW_BYTES, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.view("<i4").reshape(pay_rows, LANES)


def fill_row(row: np.ndarray, data: np.ndarray) -> None:
    """``data`` at the start of ``row`` and zeros after it: each byte of the
    row written once, whatever the row held before (a pinned block the
    host allocator recycles holds an earlier window's bytes)."""
    row[:len(data)] = data
    row[len(data):] = 0


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


def decode_tokens_batch(payload_words: torch.Tensor, tok_a: torch.Tensor,
                        tok_b: torch.Tensor, *,
                        out_rows: int = OUT_ROWS) -> torch.Tensor:
    """Reconstruct a batch of blocks from payload words and token chunks.

    payload_words: (B, pay_rows, 128) int32 per-block payloads.
    tok_a, tok_b: (B, n_chunks, 8, 128) int32 token chunks, packed by
    ``pack_tokens`` with the same ``pay_rows``.
    Returns (B, out_rows, 128) int32 decoded words on the inputs' device,
    zeroed before the decode; callers slice each block's bytes.
    """
    B, pay_rows, _ = payload_words.shape
    n_chunks = tok_a.shape[1]
    dev = payload_words.device
    shape = (B, n_chunks, _SLOT_ROWS, LANES)
    for name, t, want in (("payload_words", payload_words,
                           (B, pay_rows, LANES)),
                          ("tok_a", tok_a, shape), ("tok_b", tok_b, shape)):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be int32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, payload_words on "
                             f"{dev}")
    if (pay_rows + out_rows) * ROW_BYTES > 1 << 31:
        raise ValueError("pay_rows + out_rows must address under 2 GiB")
    if dev.type == "cpu":
        return _decode_tokens_plain(payload_words, tok_a, tok_b,
                                    out_rows=out_rows)
    if dev.type != "cuda":
        raise ValueError(f"no token kernel for device {dev}")
    return _launch(payload_words, tok_a, tok_b, out_rows)


def _launch(payload_words, tok_a, tok_b, out_rows):
    global launches
    payload_words, tok_a, tok_b = (t.contiguous() for t in
                                   (payload_words, tok_a, tok_b))
    B, pay_rows, _ = payload_words.shape
    lib = _build.library()
    with torch.cuda.device(payload_words.device):
        out = torch.zeros((B, out_rows, LANES), dtype=torch.int32,
                          device=payload_words.device)
        if B == 0 or tok_a.shape[1] == 0:
            return out
        err = lib.tsq_decode_tokens(
            payload_words.data_ptr(), tok_a.data_ptr(), tok_b.data_ptr(),
            out.data_ptr(), B, tok_a.shape[1], pay_rows, out_rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "decode_tokens")
    launches += 1
    return out


# --- plain PyTorch version ---------------------------------------------------

def _clip_head(pay_bytes: int, dst: int, ln: int, src: int):
    """A token's bytes below the output plane are not written: drop them,
    keeping each remaining byte's source."""
    skip = pay_bytes - dst
    if skip <= 0:
        return dst, ln, src
    if ln <= skip:
        return pay_bytes, 0, src
    return pay_bytes, ln - skip, src + skip


def _decode_tokens_plain(payload_words, tok_a, tok_b, *, out_rows):
    """The token kernel's plain version: runs each block's token pairs over
    ``[payload | output]``, every token in order.

    On a corrupt container, a match can read output bytes that no token
    has written; the JAX kernel gives its scratch there (in interpret mode
    the high byte 0x80 of its 0x80000000 fill, on a TPU whatever VMEM
    held), this version and the CUDA kernel 0. No decoder defines those
    bytes; ``tests/gang_streams.py::CORRUPT`` pins the containers and
    bytes where the two differ (ROADMAP §3)."""
    B, pay_rows, _ = payload_words.shape
    pay_bytes = pay_rows * ROW_BYTES
    out = torch.zeros((B, pay_bytes + out_rows * ROW_BYTES),
                      dtype=torch.uint8)
    for b in range(B):
        u = out[b]
        u[:pay_bytes] = payload_words[b].contiguous().view(
            torch.uint8).reshape(-1)
        # word B is an unsigned address: a garbage one lies past the buffer
        words_a = tok_a[b].reshape(-1, TOKENS_PER_CHUNK).tolist()
        words_b = (tok_b[b].reshape(-1, TOKENS_PER_CHUNK).to(torch.int64)
                   & 0xFFFFFFFF).tolist()
        for a, s in zip(words_a, words_b):
            n = min(max(a[0], 0), _TOKENS_CAP)
            for t in range(1, n + 1, 2):
                live2 = t + 1 <= n
                a1, s1 = a[t], s[t]
                a2, s2 = (a[t + 1], s[t + 1]) if live2 else (0, 0)
                reconstruct_pair(
                    u, *_clip_head(pay_bytes, a1 & _DST_MASK,
                                   (a1 >> _LEN_SHIFT) & _LEN_MASK, s1),
                    *_clip_head(pay_bytes, a2 & _DST_MASK,
                                (a2 >> _LEN_SHIFT) & _LEN_MASK, s2))
    return out[:, pay_bytes:].contiguous().view(torch.int32).reshape(
        B, out_rows, LANES)


# --- host-side glue ----------------------------------------------------------

def pack_tokens(dst, src, ln, lit, n_chunks: int, pay_rows: int = PAY_ROWS):
    """Pack token fields into the two-plane chunked layout (numpy).

    Positions are translated into the kernel's unified byte space: the
    payload occupies [0, pay_rows*512) and the decoded output follows, so
    literal sources stay payload-relative while match sources and all
    destinations shift up by the payload extent. Returns (tok_a, tok_b) of
    shape (n_chunks, 8, 128) int32, slot 0 of each chunk holding its live
    count; the planes equal the JAX package's ``pack_tokens``.
    """
    n = len(dst)
    cap = n_chunks * _TOKENS_CAP
    if n > cap:
        raise ValueError(f"{n} tokens exceed capacity {cap}")
    pay_bytes = pay_rows * ROW_BYTES
    lit = np.asarray(lit)
    a = ((np.asarray(dst, np.int64) + pay_bytes)
         | (np.asarray(ln, np.int64) << _LEN_SHIFT)).astype(np.int32)
    s = (np.asarray(src, np.int64)
         + np.where(lit == 1, 0, pay_bytes)).astype(np.int32)
    full, rem = divmod(n, _TOKENS_CAP)
    planes = []
    for v in (a, s):
        p = np.zeros((n_chunks, TOKENS_PER_CHUNK), dtype=np.int32)
        p[:full, 1:1 + _TOKENS_CAP] = v[:full * _TOKENS_CAP].reshape(
            full, _TOKENS_CAP)
        if rem:
            p[full, 1:1 + rem] = v[full * _TOKENS_CAP:]
        planes.append(p)
    planes[0][:full, 0] = _TOKENS_CAP
    if rem:
        planes[0][full, 0] = rem
    shape = (n_chunks, _SLOT_ROWS, LANES)
    return planes[0].reshape(shape), planes[1].reshape(shape)


def n_chunks_for_tokens(n_tokens: int) -> int:
    return max(1, -(-n_tokens // _TOKENS_CAP))
