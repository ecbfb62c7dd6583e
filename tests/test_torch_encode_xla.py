"""The port's encode phase A (turbosqueeze_tpu_torch/kernels/encode_xla.py)
against the JAX package's ``find_candidates`` and the native core's hash
chain (``native.build_candidates``): the same numpy-seeded blocks go
through all three, and the candidate arrays must be equal."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import encode_xla as RX
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import encode_xla as PX

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import port_core  # noqa: E402


@pytest.fixture(scope="module")
def native():
    return port_core()


def _cases():
    rng = np.random.default_rng(12)
    text = synthetic_text(60_000, seed=51)
    return {
        "text": text,
        "binary": synthetic_binary(40_000, seed=52),
        "zeros": bytes(9_000),
        "random": rng.bytes(30_000),
        "five": b"abcab",
        # a periodic tail cut mid-window: the last three windows see zeros
        "tail": (b"\xff\xfe\x80\x81" * 3000) + b"\xff\xfe",
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_matches_jax_and_native(native, name):
    blk = _cases()[name]
    got = PX.find_candidates_host(blk)
    assert got.dtype == np.int32 and got.shape == (len(blk),)
    assert np.array_equal(got, native.build_candidates(blk))
    assert np.array_equal(got, RX.find_candidates_host(blk))


def test_batch_rows_are_independent(native):
    """A padded (B, N) batch gives each row the entries of its block alone
    below its size, whatever the other rows and the zero padding hold."""
    cases = list(_cases().values())
    n = max(map(len, cases))
    batch = np.zeros((len(cases), n), dtype=np.uint8)
    for b, blk in enumerate(cases):
        batch[b, :len(blk)] = np.frombuffer(blk, dtype=np.uint8)
    got = PX.find_candidates(torch.from_numpy(batch))
    assert got.dtype == torch.int32 and tuple(got.shape) == batch.shape
    for b, blk in enumerate(cases):
        assert np.array_equal(got[b, :len(blk)].numpy(),
                              native.build_candidates(blk)), b


def test_dictionary_concat(native):
    """The dictionary form searches concat(dict, block), as the reference's
    ``_sharded_candidates_dict`` does."""
    d = synthetic_text(33_000, seed=113)
    blk = synthetic_text(20_000, seed=114)
    concat = d + blk
    want = np.asarray(RX.find_candidates(
        jnp.asarray(np.frombuffer(concat, np.uint8).astype(np.int32))))
    got = PX.find_candidates_host(concat)
    assert np.array_equal(got, want)
    assert np.array_equal(got, native.build_candidates(concat))
    assert (got[len(d):] < len(d)).any()  # blocks do reach the dictionary


def test_v4_and_hash_match_reference():
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, 4099, dtype=np.int64)
    v4 = PX.bytes_to_v4(torch.from_numpy(b))
    ref = RX.bytes_to_v4(jnp.asarray(b.astype(np.int32)))
    assert np.array_equal(v4.numpy(), np.asarray(ref))
    assert np.array_equal(PX.hash4_words(v4).numpy(),
                          np.asarray(RX.hash4_words(ref)))
