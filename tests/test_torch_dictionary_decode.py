"""The port's host-tokenized decode routes and preset dictionaries on the
card's decode (turbosqueeze_tpu_torch/parallel/pipeline.py, runtime/
api.py) on the CPU, where the kernels run their plain versions: every
route's bytes are held against the input, ``native.decompress_dict`` /
``native.decompress`` and the JAX pipeline (interpret mode), exactly."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.format import FormatError as RefFormatError
from turbosqueeze_tpu.format import scan_block_table
from turbosqueeze_tpu.kernels import decode_tokens as RT
from turbosqueeze_tpu.parallel import mesh as ref_mesh
from turbosqueeze_tpu.parallel import pipeline as ref_pipeline
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.format import FormatError
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels import decode_xla as PX
from turbosqueeze_tpu_torch.parallel import pipeline

import turbosqueeze_tpu_torch as tsq

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import jax_core, port_core  # noqa: E402

MiB = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def native():
    jax_core()  # the JAX pipeline's reference runs on it
    return port_core()


@pytest.fixture(scope="module")
def dictionary():
    return synthetic_text(20_000, seed=500)


@pytest.fixture(scope="module")
def small(native, dictionary):
    """A ~45 KB dictionary container and its input."""
    data = synthetic_text(30_000, seed=97) + synthetic_binary(15_000, seed=98)
    stream = native.compress_dict(data, dictionary, True)
    assert native.decompress_dict(stream, dictionary) == data
    return data, stream


@pytest.fixture
def routes(monkeypatch):
    """Records each kernel wrapper's calls: the route a decode took, and
    the keyword arguments it passed."""
    calls = []

    def spy(name, mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapped(*a, **k):
            calls.append((name, k))
            return fn(*a, **k)

        monkeypatch.setattr(mod, fn_name, wrapped)

    spy("gang", PG, "decode_gang_batch")
    spy("stream", PS, "decode_stream_batch")
    spy("pallas", PT, "decode_tokens_batch")
    spy("xla", PX, "decode_batch_xla")
    return calls


def _jax(stream, **kw):
    return ref_pipeline.decompress(
        stream, mesh=ref_mesh.block_mesh(jax.devices()[:1]), **kw)


@pytest.mark.parametrize("impl", ["pallas", "xla", "stream", "gang"])
def test_dictionary_routes_match_native_and_jax(small, dictionary, routes,
                                                native, impl):
    """Each route with the dictionary. The JAX gang route with a
    dictionary interprets three windows (about half a minute), so the
    port's gang route is held to the JAX xla route instead."""
    data, stream = small
    got = pipeline.decompress(stream, device="cpu", impl=impl,
                              dictionary=dictionary)
    assert got == native.decompress_dict(stream, dictionary) == data
    ref = _jax(stream, impl="xla" if impl == "gang" else impl,
               dictionary=dictionary)
    assert got == ref
    assert [name for name, _ in routes] == [impl]
    if impl == "gang":
        assert routes[0][1]["max_win"] == 3


def test_api_routes_the_dictionary_to_the_device(small, dictionary, routes):
    data, stream = small
    ticks = []
    assert tsq.decompress(stream, backend="cuda", device="cpu",
                          dictionary=dictionary,
                          progress=lambda *a: ticks.append(a)) == data
    assert [name for name, _ in routes] == ["gang"]
    assert ticks == [(1, 1)]


def test_full_block_dictionary_takes_the_third_gang_window(native, routes):
    """A full 4 MiB block plus a 33 KB dictionary spans three 2 MiB
    windows of the dict-extended space: the resolver's gang stream has
    three windows and the route decodes them (max_win = 3); the xla route
    decodes the same container."""
    d = synthetic_text(33_000, seed=113)
    data = synthetic_text(4 * MiB + 30_000, seed=114)
    stream = native.compress_dict(data, d, True)
    want = native.decompress_dict(stream, d)
    assert want == data
    _, table = scan_block_table(stream)
    off, psz, ext = table[0]
    _, _, gmeta, _ = PG.prep_gang([(stream[off:off + psz], ext)], 1, 8,
                                  dictionary=d)
    assert gmeta[0, 8] == 3  # windows of block 0
    assert tsq.decompress(stream, backend="cuda", device="cpu",
                          dictionary=d) == want
    assert pipeline.decompress(stream, device="cpu", impl="xla",
                               dictionary=d) == want
    gang = [k for name, k in routes if name == "gang"]
    assert len(gang) == 1 and gang[0]["max_win"] == 3
    assert [name for name, _ in routes][1:] == ["xla"]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_tokenized_routes_without_dictionary(native, routes, impl):
    """A small two-class container, equal to the JAX pipeline's decode,
    and the empty container, through the token routes."""
    data = synthetic_text(40_000, seed=71) + bytes(30_000)
    stream = native.compress(data, True, level=1)
    assert pipeline.decompress(stream, device="cpu", impl=impl) == data
    assert pipeline.decompress(stream, device="cpu", impl=impl) == \
        _jax(stream, impl=impl)
    empty = native.compress(b"", True)
    assert pipeline.decompress(empty, device="cpu", impl=impl) == b""
    assert [name for name, _ in routes] == [impl] * 2


@pytest.mark.parametrize("impl", ["pallas", "stream"])
def test_decompress_to_words_matches_jax(native, impl):
    data = synthetic_text(30_000, seed=72)
    stream = native.compress(data, True, level=1)
    words, sizes, hdr = pipeline.decompress_to_words(stream, device="cpu",
                                                     impl=impl)
    ref, rsizes, rhdr = ref_pipeline.decompress_to_words(
        stream, ref_mesh.block_mesh(jax.devices()[:1]), impl=impl)
    ref = np.asarray(ref)
    assert words.shape == ref.shape == (1, PT.OUT_ROWS, 128)
    [shard] = words.shards
    assert shard.index == slice(0, 1) and shard.device == torch.device("cpu")
    words = shard.data
    assert words.dtype == torch.int32 and tuple(words.shape) == ref.shape
    assert sizes == rsizes == [len(data)]
    # the port's header is its own class, with the same fields
    assert (hdr.n_blocks, hdr.total_size) == (rhdr.n_blocks,
                                              rhdr.total_size)
    assert PT.words_to_bytes(words[0], len(data)) == data
    assert PT.words_to_bytes(words[0], len(data)) == \
        RT.words_to_bytes(ref[0], len(data))


def test_decompress_to_words_windows_fill_one_tensor(native):
    """Two blocks in windows of one: each window's words land in its slice
    of the one output tensor; the empty container gives B = 1."""
    data = bytes(4 * MiB) + synthetic_text(20_000, seed=73)
    stream = native.compress(data, True, level=1)
    words, sizes, hdr = pipeline.decompress_to_words(stream, device="cpu",
                                                     window_blocks=1)
    [shard] = words.shards
    assert words.shape == tuple(shard.data.shape) == (2, PT.OUT_ROWS, 128)
    assert shard.index == slice(0, 2)
    assert sizes == [4 * MiB, 20_000] and hdr.n_blocks == 2
    assert b"".join(PT.words_to_bytes(shard.data[b], n)
                    for b, n in enumerate(sizes)) == data
    words, sizes, hdr = pipeline.decompress_to_words(
        native.compress(b"", True), device="cpu")
    [shard] = words.shards
    assert words.shape == tuple(shard.data.shape) == (1, PT.OUT_ROWS, 128)
    assert sizes == [] and not shard.data.any()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_corrupt_containers_raise(native, impl):
    """Truncated containers, a block header claiming a huge payload, and a
    payload the tokenizer rejects fail loudly, as in the JAX package."""
    data = synthetic_text(100_000, seed=55)
    stream = bytearray(native.compress(data, True))
    with pytest.raises(FormatError):
        pipeline.decompress(bytes(stream[:40]), device="cpu", impl=impl)
    bad = bytes(stream[:16]) + b"\xff\xff\x7f" + bytes(stream[19:])
    with pytest.raises(FormatError):
        pipeline.decompress(bad, device="cpu", impl=impl)
    stomped = bytes(stream[:22]) + b"\xff" * (len(stream) - 22)
    with pytest.raises(FormatError):
        pipeline.decompress(stomped, device="cpu", impl=impl)
    with pytest.raises(RefFormatError):
        _jax(stomped, impl=impl)


def test_unported_and_unknown_routes(native, small, dictionary):
    _, stream = small
    for impl in ("bulk", "bulk2", "bulkn"):  # words stay with two routes
        with pytest.raises(ValueError, match="impl"):
            pipeline.decompress_to_words(stream, device="cpu", impl=impl)
    with pytest.raises(ValueError, match="impl"):
        pipeline.decompress(stream, device="cpu", impl="nonesuch")
    with pytest.raises(ValueError, match="impl"):
        pipeline.decompress_to_words(stream, device="cpu", impl="xla")
    with pytest.raises(ValueError, match="dictionary"):
        pipeline.decompress(stream, device="cpu",
                            dictionary=bytes(native.MAX_DICT + 1))
