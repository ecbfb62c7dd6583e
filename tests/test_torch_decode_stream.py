"""The port's raw-payload stream decoder (turbosqueeze_tpu_torch/kernels/
decode_stream.py) against the JAX package's Pallas kernel, run interpreted
on the CPU: the same payload words and meta go through both, and each
block's decoded bytes must match exactly (tolerance zero)."""

import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX package is the reference)
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.format import iter_container
from turbosqueeze_tpu.kernels import decode_stream as RS
from turbosqueeze_tpu.kernels import decode_tokens as RT
from turbosqueeze_tpu.utils.corpus import synthetic_text
from turbosqueeze_tpu_torch.format import OUTPUT_SZ
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import (CORRUPT, check_corrupt_difference,  # noqa: E402
                          corrupt_container)
from test_torch_host_copies import jax_core, port_core  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _native():
    jax_core()  # the tests' containers come from it
    port_core()


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


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_documented_differences_from_reference(case):
    """Corrupt containers that ``native.decompress`` accepts
    (``gang_streams.CORRUPT``, ROADMAP §3) through ``impl="stream"``: a
    match reads output bytes no token wrote, where the JAX kernel gives
    its scratch (0x80 in interpret mode) and the port 0. The two differ
    on exactly the listed bytes (none on the 300-byte container)."""
    from turbosqueeze_tpu_torch.runtime import native

    check_corrupt_difference(case, "stream", native)


# -- the stream route's payload planes, cut to the window -------------------

@pytest.mark.parametrize("longest", [0, 1, 300, 511, 512, 60_000, 1 << 20,
                                     (1 << 22) + 3, PT.PAY_ROWS * 512
                                     - (1 << 16) - 16 * 512 - 1,
                                     OUTPUT_SZ - 1000, OUTPUT_SZ])
def test_payload_rows_hold_the_payload_and_the_guard(longest):
    """A window's payload plane: a multiple of the parse window's 8 rows,
    the longest payload, 64 KiB of zeros and 16 rows of slack, at most
    ``PAY_ROWS``; a payload near the format's largest gets the full
    plane."""
    rows = PS.payload_rows(longest)
    assert rows % 8 == 0 and 8 <= rows <= PT.PAY_ROWS
    if rows < PT.PAY_ROWS:
        assert rows * PT.ROW_BYTES >= longest + (1 << 16) + 16 * PT.ROW_BYTES
    if longest > OUTPUT_SZ - (1 << 16):
        assert rows == PT.PAY_ROWS


def _random_corrupt(seed):
    """A level-0 container whose payloads carry a few random bytes: the
    header, block table and each block's declared size stay intact."""
    from turbosqueeze_tpu_torch.format import scan_block_table
    from turbosqueeze_tpu_torch.runtime import native

    rng = np.random.default_rng(seed)
    data = synthetic_text(int(rng.integers(2_000, 24_000)), seed=seed)
    c = bytearray(native.compress(data, bool(seed % 2), level=0))
    _, table = scan_block_table(bytes(c))
    for off, psz, _ in table:
        for i in rng.integers(off + 3, off + psz, int(rng.integers(1, 6))):
            c[i] = int(rng.integers(0, 256))
    return bytes(c)


@pytest.mark.parametrize("case", [*sorted(CORRUPT),
                                  *(f"random{s}" for s in range(6))])
def test_narrowed_payload_planes_decode_as_full_ones(case, monkeypatch):
    """``impl="stream"`` through planes cut to the window's longest payload
    gives every byte that full ``PAY_ROWS`` planes give, on corrupt
    containers too: the zero guard keeps each read where it lands in a
    full plane."""
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native

    stream = (corrupt_container(case, native)[1] if case in CORRUPT
              else _random_corrupt(int(case[len("random"):])))
    rows, cut = [], PS.payload_rows
    monkeypatch.setattr(PS, "payload_rows",
                        lambda n: rows.append(cut(n)) or rows[-1])
    narrowed = pipeline.decompress(stream, device="cpu", impl="stream")
    assert rows and max(rows) < PT.PAY_ROWS
    monkeypatch.setattr(PS, "payload_rows", lambda n: PT.PAY_ROWS)
    assert narrowed == pipeline.decompress(stream, device="cpu",
                                           impl="stream")


@pytest.mark.parametrize("with_dict", [False, True])
def test_a_recycled_plane_is_packed_as_a_zeroed_one(monkeypatch, with_dict):
    """The stream route's planes come from ``torch.empty``, which may hand
    back an earlier window's bytes (here every byte 0xFF): each byte of
    each plane is written, so the planes equal zero-padded ones and the
    container decodes to its input."""
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native

    d = synthetic_text(3_000, seed=120) if with_dict else None
    data = synthetic_text(30_000, seed=121) + bytes(9_000)
    stream = (native.compress_dict(data, d, True) if d
              else native.compress(data, True, level=0))
    empty, seen = torch.empty, []
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **kw: empty(*a, **kw).fill_(-1))
    launch = PS.decode_stream_batch

    def seeing(*planes, **kw):
        seen.append([p.clone() for p in planes])
        return launch(*planes, **kw)

    monkeypatch.setattr(PS, "decode_stream_batch", seeing)
    assert pipeline.decompress(stream, device="cpu", impl="stream",
                               dictionary=d) == data
    (pw, meta, *dw), = seen
    payloads = [p for _, p, _ in iter_container(stream)]
    assert pw.shape[1] == PS.payload_rows(max(map(len, payloads)))
    assert np.array_equal(pw.numpy(), np.stack(
        [PT.pack_payload_words(p, pw.shape[1]) for p in payloads]))
    assert np.array_equal(meta.numpy(), PS.pack_meta(
        [True] * len(payloads), [len(data)], dict_len=len(d or b"")))
    assert [w.numpy().tolist() for w in dw] == (
        [PS.pack_dict_words(d).tolist()] if d else [])
