"""The port's token-chunk decode (turbosqueeze_tpu_torch/kernels/
decode_tokens.py and block.py) against the JAX package's Pallas kernel,
run interpreted on the CPU: the same numpy token and payload planes go
through both, and each block's decoded bytes must match exactly
(tolerance zero). The host glue (pack_tokens, tokenize_with_dict,
dict_prefix_tokens) must give the JAX package's arrays exactly."""

import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX package is the reference)
import numpy as np
import pytest
import torch

from turbosqueeze_tpu import block as RBL
from turbosqueeze_tpu.format import iter_container
from turbosqueeze_tpu.kernels import decode_tokens as RT
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch import block as PBL
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import CORRUPT, check_corrupt_difference  # noqa: E402
from test_torch_host_copies import jax_core, port_core  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def native():
    port_core()  # the port's block.py runs on it
    return jax_core()


def _rows_for(nbytes):
    rows = -(-(nbytes + 1) // PT.ROW_BYTES) + 16
    return max(-(-rows // 8) * 8, 8)


def _mixed(native, ext):
    """(payload, data) of text, zeros, binary and random blocks at levels
    0-2: literal runs, long RLE matches and short matches."""
    datas = [synthetic_text(40_000, seed=31), bytes(20_000),
             synthetic_binary(30_000, seed=32),
             np.random.default_rng(33).bytes(9_000), b"abcab" * 7]
    return [(native.compress(d, ext, level=k % 3)[19:], d)
            for k, d in enumerate(datas)]


def _both(blocks, ext, dictionary=None):
    """Decode (payload, data) blocks through the JAX kernel (interpreted)
    and the port's plain version, from the same planes; returns each
    block's bytes from both."""
    parsed = [PBL.tokenize_with_dict(p, ext, dictionary) for p, _ in blocks]
    base = parsed[0][6]
    pay_rows = _rows_for(max(len(p[0]) for p in parsed))
    out_rows = _rows_for(base + max(p[5] for p in parsed))
    n_chunks = max(PT.n_chunks_for_tokens(len(p[1])) for p in parsed)
    pw = np.stack([PT.pack_payload_words(p[0], pay_rows) for p in parsed])
    toks = [PT.pack_tokens(*p[1:5], n_chunks, pay_rows=pay_rows)
            for p in parsed]
    ta, tb = (np.stack([t[k] for t in toks]) for k in (0, 1))
    ref = np.asarray(RT.decode_tokens_batch(pw, ta, tb, interpret=True,
                                            out_rows=out_rows))
    got = PT.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cpu"),
                                 out_rows=out_rows)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    got = got.numpy()
    sizes = [p[5] for p in parsed]
    return ([RT.words_to_bytes(ref[b], base + n)[base:]
             for b, n in enumerate(sizes)],
            [PT.words_to_bytes(got[b], base + n)[base:]
             for b, n in enumerate(sizes)], n_chunks)


@pytest.mark.parametrize("n", [0, 1, 2, 1021, 1022, 1023, 2045, 3000])
def test_pack_tokens_matches_reference(n):
    """Empty, odd and even counts, exactly full chunks and spares, at two
    payload extents: the planes are the JAX package's, bit for bit."""
    rng = np.random.default_rng(n)
    dst = np.sort(rng.integers(0, 1 << 22, n)).astype(np.int32)
    src = rng.integers(0, 1 << 22, n).astype(np.int32)
    ln = rng.integers(0, 128, n).astype(np.int32)
    lit = rng.integers(0, 2, n).astype(np.int32)
    need = PT.n_chunks_for_tokens(n)
    assert need == RT.n_chunks_for_tokens(n)
    for n_chunks in (need, need + 2):
        for pay_rows in (64, PT.PAY_ROWS):
            got = PT.pack_tokens(dst, src, ln, lit, n_chunks, pay_rows)
            ref = RT.pack_tokens(dst, src, ln, lit, n_chunks, pay_rows)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype == np.int32
                assert np.array_equal(g, r)
    if n:
        with pytest.raises(ValueError, match="capacity"):
            PT.pack_tokens(dst, src, ln, lit, need - 1 if need > 1 else 0)


@pytest.mark.parametrize("payload_len, dict_len",
                         [(100, 0), (100, 16), (100, 17), (9, 33_000),
                          (5, 32)])
def test_dict_prefix_tokens_match_reference(payload_len, dict_len):
    for g, r in zip(PBL.dict_prefix_tokens(payload_len, dict_len),
                    RBL.dict_prefix_tokens(payload_len, dict_len)):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert len(PBL.dict_prefix_tokens(payload_len, dict_len)[0]) % 2 == 0


@pytest.mark.parametrize("with_dict", [False, True])
def test_tokenize_with_dict_matches_reference(native, with_dict):
    d = synthetic_text(20_000, seed=34) if with_dict else None
    data = synthetic_text(30_000, seed=35)
    stream = (native.compress_dict(data, d, True) if d
              else native.compress(data, True, level=1))
    (_, payload, ext), = iter_container(stream)
    got = PBL.tokenize_with_dict(payload, ext, d)
    ref = RBL.tokenize_with_dict(payload, ext, d)
    assert got[0] == ref[0] and got[5:] == ref[5:]
    for g, r in zip(got[1:5], ref[1:5]):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.parametrize("ext", [True, False])
def test_plain_matches_reference_kernel(native, ext):
    """Mixed classes in one batch, several chunks (the text block): the
    plain version equals the JAX kernel and the input."""
    blocks = _mixed(native, ext)
    ref, got, n_chunks = _both(blocks, ext)
    assert n_chunks >= 3
    for k, (_, d) in enumerate(blocks):
        assert ref[k] == d, f"reference block {k}"
        assert got[k] == d, f"ext={ext}: block {k} differs"


def test_odd_final_count_matches_reference_kernel(native):
    """The tokenizer emits whole pairs; dropping a block's last token
    leaves an odd count in its last chunk, whose last pair's second token
    is then dead. Both kernels decode the bytes before it the same."""
    data = synthetic_text(40_000, seed=41)
    payload = native.compress(data, True, level=1)[19:]
    dst, src, ln, lit, size = native.tokenize_block(payload, True)
    n = len(dst) - 1
    assert n % PT._TOKENS_CAP % 2 == 1 and n > 2 * PT._TOKENS_CAP
    end = min(int(dst[n]), size)  # the dropped token's first byte
    pay_rows, out_rows = _rows_for(len(payload)), _rows_for(size)
    n_chunks = PT.n_chunks_for_tokens(n)
    ta, tb = PT.pack_tokens(dst[:n], src[:n], ln[:n], lit[:n], n_chunks,
                            pay_rows=pay_rows)
    assert ta.reshape(n_chunks, -1)[-1, 0] % 2 == 1
    pw = PT.pack_payload_words(payload, pay_rows)[None]
    ref = np.asarray(RT.decode_tokens_batch(pw, ta[None], tb[None],
                                            interpret=True,
                                            out_rows=out_rows))
    got = PT.decode_tokens_batch(*planes_to_torch(pw, ta[None], tb[None],
                                                  device="cpu"),
                                 out_rows=out_rows)
    assert PT.words_to_bytes(got[0], end) == data[:end]
    assert RT.words_to_bytes(ref[0], end) == data[:end]


def test_dictionary_prefix_matches_reference_kernel(native):
    """The dictionary staged by synthetic literal tokens (with the no-op
    that keeps the pair phase) and matches reaching back into it."""
    d = synthetic_text(16_400, seed=36)  # 1025 prefix tokens: odd, padded
    assert len(PBL.dict_prefix_tokens(9, len(d))[0]) == 1026
    datas = [synthetic_text(30_000, seed=37), bytes(5_000)]
    blocks = [(next(iter_container(native.compress_dict(x, d, True)))[1], x)
              for x in datas]
    ref, got, _ = _both(blocks, True, dictionary=d)
    for k, x in enumerate(datas):
        assert ref[k] == x and got[k] == x, f"block {k}"


@pytest.mark.parametrize("ext", [True, False])
def test_decode_block_device_matches_reference(native, corpus_cases, ext):
    from turbosqueeze_tpu import reference_codec as rc

    for k, data in enumerate(corpus_cases[:6]):
        payload = rc.encode_block(data, ext)
        got = PBL.decode_block_device(payload, ext, device="cpu")
        assert got == data, f"case {k}"
        assert PBL.decode_block_reference_tokens(payload, ext) == data
        if k < 2:
            assert got == RBL.decode_block_device(payload, ext,
                                                  interpret=True)


def test_decode_block_device_dictionary(native):
    d = synthetic_text(25_000, seed=38)
    data = synthetic_text(35_000, seed=39)
    (_, payload, ext), = iter_container(native.compress_dict(data, d, True))
    got = PBL.decode_block_device(payload, ext, device="cpu", dictionary=d)
    assert got == data
    assert got == RBL.decode_block_device(payload, ext, interpret=True,
                                          dictionary=d)
    # more chunks than the tokens need: the spares are empty
    assert PBL.decode_block_device(payload, ext, device="cpu",
                                   dictionary=d, n_chunks=40) == data


def test_garbage_planes_stay_in_bounds():
    """Random token words: counts past the chunk, sources past the space,
    destinations below the output plane. The plain version clamps the
    count, reads zeros past the space and writes only the output plane."""
    rng = np.random.default_rng(40)
    pay_rows, out_rows = 16, 24
    pw = rng.integers(-2**31, 2**31, (2, pay_rows, 128), dtype=np.int32)
    ta = rng.integers(-2**31, 2**31, (2, 3, 8, 128), dtype=np.int32)
    tb = rng.integers(-2**31, 2**31, (2, 3, 8, 128), dtype=np.int32)
    ta[0, :, 0, 0] = (5000, -3, 7)
    out = PT.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cpu"),
                                 out_rows=out_rows)
    assert tuple(out.shape) == (2, out_rows, 128)

    # one pair: token 1 copies payload bytes 0..9 to a dst that starts 4
    # bytes below the output plane; token 2 reads past the space
    pay_bytes = pay_rows * 512
    ta, tb = np.zeros((2, 1, 8, 128), np.int32), np.zeros((2, 1, 8, 128),
                                                           np.int32)
    flat_a, flat_b = ta.reshape(2, -1), tb.reshape(2, -1)
    flat_a[:, 0] = 2
    flat_a[:, 1] = (pay_bytes - 4) | (10 << 24)
    flat_b[:, 1] = 0
    flat_a[:, 2] = (pay_bytes + 100) | (5 << 24)
    flat_b[:, 2] = -1  # 0xFFFFFFFF: far past the space
    out = PT.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cpu"),
                                 out_rows=out_rows)
    got = PT.words_to_bytes(out[0], 200)
    assert got[:6] == pw[0].reshape(-1).view(np.uint8)[4:10].tobytes()
    assert got[6:] == bytes(194)


def test_wrapper_refuses_bad_planes_and_counts_no_cpu_launch():
    pay = torch.zeros((2, 16, 128), dtype=torch.int32)
    tok = torch.zeros((2, 1, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="tok_a"):
        PT.decode_tokens_batch(pay, tok[:, :, :4], tok)
    with pytest.raises(ValueError, match="tok_b"):
        PT.decode_tokens_batch(pay, tok, tok.to(torch.int64))
    with pytest.raises(ValueError, match="2 GiB"):
        PT.decode_tokens_batch(pay, tok, tok, out_rows=1 << 22)
    before = PT.launches
    out = PT.decode_tokens_batch(pay, tok, tok, out_rows=8)
    assert PT.launches == before and not out.any()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_documented_differences_from_reference(native, case):
    """Corrupt containers that ``native.decompress`` accepts
    (``gang_streams.CORRUPT``, ROADMAP §3) through ``impl="pallas"``: a
    match reads output bytes no token wrote, where the JAX kernel gives
    its scratch (0x80 in interpret mode) and the port 0. The two differ
    on exactly the listed bytes."""
    check_corrupt_difference(case, "pallas", native)
