"""The port's raw-payload stream decoder (turbosqueeze_tpu_torch/kernels/
decode_stream.py) against the JAX package's Pallas kernel, run interpreted
on the CPU: the same payload words and meta go through both, and each
block's decoded bytes must match exactly (tolerance zero)."""

import subprocess

import jax  # noqa: F401  (the JAX package is the reference)
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.format import iter_container
from turbosqueeze_tpu.kernels import decode_stream as RS
from turbosqueeze_tpu.kernels import decode_tokens as RT
from turbosqueeze_tpu.utils.corpus import synthetic_text
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch


@pytest.fixture(scope="module", autouse=True)
def _native():
    from turbosqueeze_tpu.runtime import native

    if not native.available():
        subprocess.run(["make", "-C", "csrc"], check=True)
        native._SEARCHED = False
    assert native.available()


def _rows_for(nbytes):
    rows = -(-(nbytes + 1) // PT.ROW_BYTES) + 16
    return max(-(-rows // 8) * 8, 8)


def _both(payloads, exts, sizes, dictionary=None):
    """Decode one batch through both kernels; returns each block's bytes
    from the reference and from the port."""
    dlen = len(dictionary) if dictionary else 0
    pay_rows = _rows_for(max(map(len, payloads)))
    out_rows = _rows_for(dlen + max(sizes))
    pw = np.stack([PT.pack_payload_words(p, pay_rows) for p in payloads])
    meta = PS.pack_meta(exts, sizes, dict_len=dlen)
    dw = PS.pack_dict_words(dictionary) if dictionary else None
    ref = np.asarray(RS.decode_stream_batch(pw, meta, dw, interpret=True,
                                            out_rows=out_rows))
    planes = planes_to_torch(pw, meta, *([dw] if dictionary else []),
                             device="cpu")
    got = PS.decode_stream_batch(*planes, out_rows=out_rows)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    got = got.numpy()
    return ([RT.words_to_bytes(ref[b], dlen + n)[dlen:]
             for b, n in enumerate(sizes)],
            [PT.words_to_bytes(got[b], dlen + n)[dlen:]
             for b, n in enumerate(sizes)])


@pytest.mark.parametrize("ext", [True, False])
def test_corpus_matches_reference(corpus_cases, ext):
    """The shared small corpus, levels 0/1/2, ext on and off, in one
    batch."""
    from turbosqueeze_tpu.runtime import native

    datas = [c for c in corpus_cases if 0 < len(c) <= (1 << 17)]
    payloads = [native.compress(d, ext, level=k % 3)[19:]
                for k, d in enumerate(datas)]
    ref, got = _both(payloads, [ext] * len(datas), list(map(len, datas)))
    for k, d in enumerate(datas):
        assert ref[k] == d, f"reference block {k}"
        assert got[k] == d, f"ext={ext}: block {k} differs"


def test_dictionary_matches_reference():
    """The preset dictionary is staged at the head of the output, where
    matches reaching before the block find it."""
    from turbosqueeze_tpu.runtime import native

    d = synthetic_text(33_000, seed=113)
    data = synthetic_text(60_000, seed=114)
    (_, payload, ext), = iter_container(native.compress_dict(data, d, True))
    ref, got = _both([payload], [ext], [len(data)], dictionary=d)
    assert ref[0] == data
    assert got[0] == data


def test_oversized_declared_size_stops_at_output_end():
    """A declared size far past the output plane parses only up to the
    plane's end (a group there writes nothing) and leaves the block's own
    bytes as they are."""
    from turbosqueeze_tpu.runtime import native

    data = synthetic_text(20_000, seed=118)
    pw = PT.pack_payload_words(native.compress(data, True)[19:], 64)
    for size in (len(data), 2**31 - 1):
        meta = PS.pack_meta([True], [size])
        out = PS.decode_stream_batch(*planes_to_torch(pw[None], meta,
                                                      device="cpu"),
                                     out_rows=_rows_for(len(data)))
        assert PT.words_to_bytes(out[0], len(data)) == data, size


def test_corrupt_payload_stays_in_bounds():
    """A stomped payload decodes to garbage without faulting: every read
    and write is bounded, and the output keeps its shape."""
    from turbosqueeze_tpu.runtime import native

    data = synthetic_text(20_000, seed=117)
    payload = bytearray(native.compress(data, True)[19:])
    payload[40:80] = bytes(40)
    pw = PT.pack_payload_words(bytes(payload), _rows_for(len(payload)))
    meta = PS.pack_meta([True], [len(data)])
    out = PS.decode_stream_batch(*planes_to_torch(pw[None], meta,
                                                  device="cpu"),
                                 out_rows=_rows_for(len(data)))
    assert tuple(out.shape) == (1, _rows_for(len(data)), 128)
