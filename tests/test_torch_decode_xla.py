"""The port's scatter/gather decode (turbosqueeze_tpu_torch/kernels/
decode_xla.py, torch ops) against the JAX package's XLA formulation on the
CPU: the same numpy token and payload planes go through both, and the
decoded byte planes must be equal, every byte (tolerance zero)."""

import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX package is the reference)
import numpy as np
import pytest
import torch

from turbosqueeze_tpu import reference_codec as rc
from turbosqueeze_tpu.format import iter_container
from turbosqueeze_tpu.kernels import decode_xla as RX
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import decode_xla as PX

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import jax_core  # noqa: E402

N_OUT = 1 << 17  # small static shape keeps CPU tests fast


def _planes(payloads_and_ext, n_out=N_OUT):
    parsed, payloads, sizes = [], [], []
    for payload, ext in payloads_and_ext:
        dst, src, ln, lit, size = rc.tokenize_block(payload, ext)
        parsed.append(tuple(np.asarray(x, np.int32)
                            for x in (dst, src, ln, lit)))
        payloads.append(payload)
        sizes.append(size)
    toks = PX.pack_token_batch(parsed, n_out=n_out)
    for g, r in zip(toks, RX.pack_token_batch(parsed, n_out=n_out)):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    pay = PX.pack_payload_batch(payloads)
    assert np.array_equal(pay, RX.pack_payload_batch(payloads))
    return toks, pay, sizes


def _both(payloads_and_ext, n_out=N_OUT, rounds=23):
    """Decode through the JAX formulation and the port; the whole (B,
    n_out) planes must be equal. Returns each block's decoded bytes."""
    toks, pay, sizes = _planes(payloads_and_ext, n_out)
    ref = np.asarray(RX.decode_batch_xla(*toks, pay, n_out=n_out,
                                         rounds=rounds))
    got = PX.decode_batch_xla(*(torch.from_numpy(a) for a in (*toks, pay)),
                              n_out=n_out, rounds=rounds)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    assert np.array_equal(got.numpy(), ref)
    return [ref[b, :n].tobytes() for b, n in enumerate(sizes)]


def test_redeclared_constants():
    for name in ("OUT_N", "PAY_N", "MAX_TOKENS"):
        assert getattr(PX, name) == getattr(RX, name), name


@pytest.mark.parametrize("ext", [False, True])
def test_roundtrip_corpus(corpus_cases, ext):
    cases = [c for c in corpus_cases if 0 < len(c) <= N_OUT][:6]
    got = _both([(rc.encode_block(c, ext), ext) for c in cases])
    for g, want in zip(got, cases):
        assert g == want


def test_mixed_ext_batch():
    """ext and no-ext blocks decode together in one flat batch; the first
    block's padding tokens land on the second block's first byte, where
    the scatter-max keeps the second block's own token."""
    a = synthetic_text(60_000, seed=51)
    b = synthetic_binary(90_000, seed=52)
    got = _both([(rc.encode_block(a, True), True),
                 (rc.encode_block(b, False), False)])
    assert got == [a, b]


def test_deep_chain_rle():
    """Long runs make match-of-match chains that only full-depth pointer
    doubling resolves."""
    native = jax_core()

    data = (b"ab" * 4096 + b"\x00" * 50_000 + b"xyz" * 9999)[:N_OUT]
    (_, payload, ext), = iter_container(native.compress(data, True, level=1))
    assert _both([(payload, ext)]) == [data]


def test_insufficient_rounds_same_garbage():
    """With rounds=0 deep chains stay unresolved: both give the same wrong
    bytes, bounded, with no exception."""
    native = jax_core()

    data = b"ab" * 30_000
    (_, payload, ext), = iter_container(native.compress(data, True, level=1))
    assert _both([(payload, ext)], rounds=0) != [data]


def test_out_of_range_tokens_are_clamped_or_dropped():
    """Hand-made planes: a padding dst past the flat space is dropped, a
    negative dst too, a literal source past the payload reads its last
    byte (clip), and a match source at or past its own byte is clamped."""
    dst = np.array([[0, 3, 5, 9, 16]], np.int32)
    src = np.array([[2, 1, 40, 0, 0]], np.int32)
    lit = np.array([[1, 0, 1, 0, 1]], np.int32)
    ln = np.zeros_like(dst)
    pay = np.arange(1, 9, dtype=np.uint8)[None]
    dst2 = dst.copy()
    dst2[0, 2] = -7
    for d in (dst, dst2):
        ref = np.asarray(RX.decode_batch_xla(d, src, ln, lit, pay, n_out=16))
        got = PX.decode_batch_xla(*(torch.from_numpy(a) for a in
                                    (d, src, ln, lit, pay)), n_out=16)
        assert np.array_equal(got.numpy(), ref)
