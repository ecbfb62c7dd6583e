"""Fully data-parallel decode of host-parsed tokens, in torch ops: the port
of ``turbosqueeze_tpu/kernels/decode_xla.py``.

The copy loop of the reference decoder, re-expressed as a handful of bulk
array passes with no loop over tokens:

  1. segment ids: byte i belongs to token t(i) (dst starts ascend; one
     scatter-max and a cummax);
  2. source map: a match byte points at an earlier output byte,
     ``P[i] = src_t + (i - dst_t)``; a literal byte is a fixed point
     ``P[i] = i`` and keeps its payload offset aside;
  3. pointer doubling: ``P <- P[P]``, a fixed 23 rounds. The format's anchor
     rule gives ``P[i] < i`` for match bytes, so every chain ends at a
     literal byte within ``ceil(log2(depth))`` rounds, and 2^23 covers any
     depth in a block;
  4. one byte gather: ``out[i] = payload[paysrc[P[i]]]``.

The block batch is flattened into one byte axis (block b holds bytes
``[b*n_out, (b+1)*n_out)``), so every gather and scatter is 1-D. There is
no Pallas kernel here: the JAX package leaves this to XLA, and the port to
torch's own gather and scatter, on whatever device the tensors are on.
Indices are int64, so a window of 32 full blocks takes about 1.1 GB per
index array on the device (``pipeline.XLA_WINDOW_BLOCKS`` bounds it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..format import BLOCK_SZ, OUTPUT_SZ

OUT_N = BLOCK_SZ
PAY_N = OUTPUT_SZ
MAX_TOKENS = BLOCK_SZ // 2 + 8


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with each index clamped into range (``jnp.take``'s
    ``mode="clip"``)."""
    return x[idx.clamp(0, x.numel() - 1)]


def _segment_ids(dst: torch.Tensor, n_total: int) -> torch.Tensor:
    """Per-byte token index: t(i) with dst[t] <= i < dst[t+1], flat layout.
    A token whose dst lies outside [0, n_total), a padding token, is
    dropped; where tokens share a start the later one wins. A dropped
    token lands in a spare last slot (no boolean mask, so the host never
    waits for the device here)."""
    idx = torch.where((dst >= 0) & (dst < n_total), dst, n_total)
    tok = torch.arange(dst.numel(), dtype=torch.int64, device=dst.device)
    ids = torch.zeros(n_total + 1, dtype=torch.int64, device=dst.device)
    ids.scatter_reduce_(0, idx, tok, reduce="amax")
    return torch.cummax(ids[:n_total], 0).values


def decode_flat_xla(dst, src, lit, payload_u8, n_total: int, *,
                    rounds: int = 23) -> torch.Tensor:
    """Decode a flat batch of token streams to bytes, with no loop over
    tokens.

    dst, src, lit: (T,) int64 token fields in GLOBAL byte coordinates
    (block b's positions offset by b*n_out, literal ``src`` into the flat
    payload by b*pay_n). dst ascends; padding tokens carry dst >= n_total
    and lit = 1. payload_u8: (P,) uint8 flat payloads. Returns (n_total,)
    uint8; the caller reshapes to (B, n_out) and slices. ``rounds`` is the
    fixed pointer-doubling trip count; rounds past convergence change
    nothing (literal bytes are fixed points).
    """
    t = _segment_ids(dst, n_total)
    token_dst, token_src = _take(dst, t), _take(src, t)
    is_lit = _take(lit, t) == 1
    del t
    i = torch.arange(n_total, dtype=torch.int64, device=dst.device)
    s = token_src + (i - token_dst)
    del token_src, token_dst
    # match bytes point strictly earlier (format invariant); the clamps
    # only engage on corrupt streams and keep the map acyclic
    P = torch.where(is_lit, i, torch.minimum(s, i - 1).clamp(min=0))
    paysrc = torch.where(is_lit, s, torch.zeros_like(s))
    del s, is_lit, i
    for _ in range(rounds):
        P = P[P]
    return _take(payload_u8, _take(paysrc, P))


def decode_batch_xla(dst, src, ln, lit, payload_u8, *, n_out: int = OUT_N,
                     rounds: int = 23) -> torch.Tensor:
    """Batch decode: (B, T) block-local int32 tokens + (B, P) uint8
    payloads -> (B, n_out) uint8, on the tensors' device. ``ln`` is
    implied by consecutive dst starts and not read."""
    del ln
    B, T = dst.shape
    pay_n = payload_u8.shape[1]
    boff = torch.arange(B, dtype=torch.int64, device=dst.device)[:, None]
    dst, src = dst.to(torch.int64), src.to(torch.int64)
    gdst = (dst + boff * n_out).reshape(-1)
    gsrc = (src + boff * torch.where(lit == 1, pay_n, n_out)).reshape(-1)
    out = decode_flat_xla(gdst, gsrc, lit.reshape(-1),
                          payload_u8.reshape(-1), B * n_out, rounds=rounds)
    return out.reshape(B, n_out)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_token_batch(parsed, n_out: int):
    """Pad a list of (dst, src, ln, lit) token arrays into batch planes.

    Returns (dst, src, ln, lit) of shape (B, T) int32, block-local, with
    the padding decode_batch_xla expects (dst = n_out, lit = 1, src = 0).
    T is bucketed to a multiple of 8192, as in the JAX package.
    """
    B = len(parsed)
    T = _round_up(max(len(p[0]) for p in parsed) + 1, 8192)
    planes = [np.full((B, T), fill, dtype=np.int32) for fill in (n_out, 0,
                                                                  0, 1)]
    for b, fields in enumerate(parsed):
        for plane, v in zip(planes, fields):
            plane[b, :len(v)] = v
    return tuple(planes)


def pack_payload_batch(payloads, pay_n: int | None = None):
    """Pad payload byte strings to a common length (bucketed)."""
    B = len(payloads)
    P = pay_n or _round_up(max(len(p) for p in payloads) + 1, 1 << 16)
    out = np.zeros((B, P), dtype=np.uint8)
    for b, p in enumerate(payloads):
        out[b, :len(p)] = np.frombuffer(p, dtype=np.uint8)
    return out
