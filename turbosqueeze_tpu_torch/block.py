"""Single-block device decode: host token parse, byte movement on the
device. The port of ``turbosqueeze_tpu/block.py``; the multi-block engine
is ``parallel/pipeline.py``.
"""

from __future__ import annotations

import numpy as np

from .format import FormatError

from .kernels import decode_tokens as K
from .kernels.decode_tokens import planes_to_torch


def dict_prefix_tokens(payload_len: int, dict_len: int):
    """Synthetic literal tokens staging a preset dictionary on the device.

    The device decoders know nothing about dictionaries: the dictionary is
    appended AFTER the payload and these tokens copy it to output positions
    [0, dict_len) like ordinary literals; the real stream's tokens (emitted
    in dict-extended coordinates by ``tokenize_block(dict_len=...)``) then
    reference it as decoded history. The count is kept EVEN, with a
    trailing zero-length no-op if needed, so the real stream's format
    pairs stay pairs. Returns (dst, src, ln, lit) int32 arrays.
    """
    dst = np.arange(0, dict_len, 16, dtype=np.int32)
    ln = np.minimum(16, dict_len - dst).astype(np.int32)
    src = (payload_len + dst).astype(np.int32)
    if len(dst) % 2:
        dst = np.append(dst, np.int32(dict_len))
        src = np.append(src, np.int32(payload_len))
        ln = np.append(ln, np.int32(0))  # no-op keeps the pair phase
    return dst, src, ln, np.ones(len(dst), np.int32)


def tokenize_with_dict(payload: bytes, ext: bool, dictionary: bytes | None):
    """Tokenize a payload for the device decoders, staging the dictionary.

    Returns (extended_payload, dst, src, ln, lit, size, base) where
    positions live in the dict-extended output space [0, base + size).
    """
    from .runtime import native

    base = len(dictionary) if dictionary else 0
    dst, src, ln, lit, size = native.tokenize_block(payload, ext, base)
    if not base:
        return payload, dst, src, ln, lit, size, 0
    prefix = dict_prefix_tokens(len(payload), base)
    return (payload + dictionary,
            *(np.concatenate([p, np.asarray(v, np.int32)])
              for p, v in zip(prefix, (dst, src, ln, lit))),
            size, base)


def decode_block_device(payload: bytes, ext: bool, *, device,
                        n_chunks: int | None = None,
                        dictionary: bytes | None = None) -> bytes:
    """Decode one block payload with the token-chunk kernel on ``device``
    (``"cpu"`` runs its plain version).

    The token parse runs on the host (the native tokenizer), all byte
    movement on the device. With ``dictionary`` the preset context is
    staged by synthetic literal tokens (the device twin of the native
    core's dictionary decode).
    """
    pay2, dst, src, ln, lit, size, base = tokenize_with_dict(
        payload, ext, dictionary)
    if n_chunks is None:
        n_chunks = K.n_chunks_for_tokens(len(dst))
    pay_rows = -(-(len(pay2) + 1) // K.ROW_BYTES) + 16
    pay_rows = max(-(-pay_rows // 8) * 8, 8)
    out_rows = -(-(base + size + 1) // K.ROW_BYTES) + 16
    out_rows = max(-(-out_rows // 8) * 8, 8)
    tok_a, tok_b = K.pack_tokens(dst, src, ln, lit, n_chunks,
                                 pay_rows=pay_rows)
    words = K.decode_tokens_batch(
        *planes_to_torch(K.pack_payload_words(pay2, pay_rows)[None],
                         tok_a[None], tok_b[None], device=device),
        out_rows=out_rows)
    out = K.words_to_bytes(words[0], base + size)[base:]
    if len(out) != size:
        raise FormatError("device decode size mismatch")
    return out


def decode_block_reference_tokens(payload: bytes, ext: bool) -> bytes:
    """Pure-numpy token replay (checks the tokenizer's contract)."""
    from .runtime import native

    dst, src, ln, lit, size = native.tokenize_block(payload, ext)
    out = np.zeros(size + 80, dtype=np.uint8)
    pay = np.frombuffer(payload, dtype=np.uint8)
    pay = np.concatenate([pay, np.zeros(64, np.uint8)])
    for d, s, l, is_lit in zip(dst, src, ln, lit):
        if is_lit:
            out[d:d + l] = pay[s:s + l]
        else:
            out[d:d + l] = out[s:s + l]
    return out[:size].tobytes()
