"""Encode phase A, the match-candidate finder, in plain PyTorch ops: the
port of ``turbosqueeze_tpu/kernels/encode_xla.py``.

The reference computes this with XLA sorts outside any Pallas kernel, so
tensor ops on the block's device are its counterpart here::

    cand[i] = the nearest j < i with hash4(j) == hash4(i) and an equal
              4-byte window at j, else -1

A stable sort keyed on the hash keeps positions ascending within equal
hashes, so each position's sorted predecessor is its nearest earlier
occurrence. Only that predecessor is checked: a hash collision there gives
-1, even when an entry further back would match, exactly as the host hash
chain (``native.build_candidates``) does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format import HASH_MASK


def hash4_words(v4: torch.Tensor) -> torch.Tensor:
    """The format's 17-bit hash of each 4-byte window. An arithmetic shift
    leaves the 17 kept bits as a logical one would: they come from bits
    12-28 of ``v4``."""
    return (v4 ^ (v4 >> 12)) & HASH_MASK


def bytes_to_v4(blocks: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte windows at every position of ``(..., N)`` byte
    values, as int32 bit patterns.

    Zeros are shifted in past the end, the format's buffer contract (the
    native core reads zeroed slack). A ``roll`` would wrap the block's
    first bytes into its last three windows and can hand those positions
    false candidates (``encode_xla.py:42-58``).
    """
    x = blocks.to(torch.int32)
    v4 = x.clone()
    for k in (1, 2, 3):
        v4[..., :-k] |= x[..., k:] << (8 * k)
    return v4


def find_candidates(blocks: torch.Tensor) -> torch.Tensor:
    """Phase-A candidates of a batch: ``(B, N)`` byte values (uint8 or
    int32) -> ``(B, N)`` int32 candidate positions, -1 where none.

    Runs on the blocks' device. Positions past a block's size see its zero
    padding; they sort after every earlier position of their hash, so they
    never change the entries below the size.
    """
    v4 = bytes_to_v4(blocks)
    shash, spos = torch.sort(hash4_words(v4), dim=-1, stable=True)
    sv4 = torch.gather(v4, -1, spos)
    ok = torch.zeros_like(shash, dtype=torch.bool)
    ok[..., 1:] = (shash[..., 1:] == shash[..., :-1]) & (sv4[..., 1:]
                                                         == sv4[..., :-1])
    prev = torch.full_like(shash, -1)
    prev[..., 1:] = spos[..., :-1].to(torch.int32)
    cand_sorted = torch.where(ok, prev, torch.full_like(prev, -1))
    # un-permute: spos is a permutation of each row's positions
    return torch.empty_like(cand_sorted).scatter_(-1, spos, cand_sorted)


def find_candidates_host(block: bytes) -> np.ndarray:
    """One block's bytes -> its candidate array (numpy int32), on the CPU."""
    arr = torch.from_numpy(np.frombuffer(block, dtype=np.uint8).copy())
    return find_candidates(arr[None])[0].numpy()
