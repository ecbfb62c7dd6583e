"""The port's container decode (turbosqueeze_tpu_torch/parallel/
pipeline.py and the public API) on the CPU, where the kernels run their
plain versions: held against the JAX pipeline and the native core."""

import subprocess

import jax
import pytest

from turbosqueeze_tpu.format import CONTAINER_HEADER_SZ, FormatError
from turbosqueeze_tpu.parallel import mesh as ref_mesh
from turbosqueeze_tpu.parallel import pipeline as ref_pipeline
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.parallel import pipeline

import turbosqueeze_tpu_torch as tsq


@pytest.fixture(scope="module", autouse=True)
def native():
    from turbosqueeze_tpu.runtime import native

    if not native.available():
        subprocess.run(["make", "-C", "csrc"], check=True)
        native._SEARCHED = False
    assert native.available()
    return native


@pytest.fixture
def routes(monkeypatch):
    """Counts the windows each kernel wrapper decodes."""
    calls = {"gang": 0, "stream": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(PG, "decode_gang_batch",
                        spy("gang", PG.decode_gang_batch))
    monkeypatch.setattr(PS, "decode_stream_batch",
                        spy("stream", PS.decode_stream_batch))
    return calls


@pytest.fixture(scope="module")
def small(native):
    """A ~300 KB one-block container and its input."""
    data = synthetic_text(200_000, seed=61) + synthetic_binary(100_000,
                                                               seed=62)
    return data, native.compress(data, True, level=1)


def _jax_gang(stream):
    return ref_pipeline.decompress(
        stream, impl="gang", mesh=ref_mesh.block_mesh(jax.devices()[:1]))


def test_matches_jax_gang_pipeline(small, routes):
    data, stream = small
    ref = _jax_gang(stream)
    assert ref == data
    assert pipeline.decompress(stream, device="cpu") == ref
    assert routes == {"gang": 1, "stream": 0}  # auto: gang with the core


def test_multiblock_ragged_tail_matches_native(native, routes):
    """Two full blocks and a ragged tail in windows of two blocks: the
    second window is a single short block."""
    data = synthetic_text(2 * (1 << 22) + 54_321, seed=19)
    stream = native.compress(data, True, level=1)
    out = pipeline.decompress(stream, device="cpu", impl="gang",
                              window_blocks=2)
    assert out == native.decompress(stream) == data
    assert routes == {"gang": 2, "stream": 0}


def test_declined_block_routes_its_window_to_stream(native, routes,
                                                    monkeypatch):
    """A block the resolver declines sends its whole window through the
    stream kernel; the other window still takes the gang kernel."""
    data = synthetic_text((1 << 22) + 150_000, seed=23)
    stream = native.compress(data, True, level=2)
    real = native.bulk_prep

    def declines_short_blocks(payload, ext, dictionary=None):
        size = payload[0] | payload[1] << 8 | payload[2] << 16
        return None if size < (1 << 22) else real(payload, ext, dictionary)

    monkeypatch.setattr(native, "bulk_prep", declines_short_blocks)
    assert pipeline.decompress(stream, device="cpu", window_blocks=1) == data
    assert routes == {"gang": 1, "stream": 1}


def test_stream_impl(native, routes):
    data = synthetic_binary(120_000, seed=116)
    stream = native.compress(data, False)
    assert pipeline.decompress(stream, device="cpu", impl="stream") == data
    assert routes == {"gang": 0, "stream": 1}


def test_declared_size_mismatch_raises(small):
    """The same planes as test_matches_jax_gang_pipeline (the JAX kernel is
    compiled once) under a header declaring one byte more."""
    stream = bytearray(small[1])
    total = int.from_bytes(stream[8:CONTAINER_HEADER_SZ], "little")
    stream[8:CONTAINER_HEADER_SZ] = (total + 1).to_bytes(8, "little")
    with pytest.raises(FormatError, match="declares"):
        _jax_gang(bytes(stream))
    with pytest.raises(FormatError, match="declares"):
        pipeline.decompress(bytes(stream), device="cpu")


def test_unknown_impl_raises(native):
    stream = native.compress(b"abc" * 100, True)
    with pytest.raises(ValueError, match="impl"):
        pipeline.decompress(stream, device="cpu", impl="pallas")


@pytest.mark.parametrize("backend", ["auto", "native", "oracle"])
def test_api_host_backends_roundtrip(backend):
    data = synthetic_text(30_000, seed=71)
    stream = tsq.compress(data, backend=backend, level=0)
    assert tsq.decompress(stream, backend=backend) == data


def test_api_rejects_unported_routes(native):
    stream = native.compress(b"hello world " * 50, True)
    with pytest.raises(NotImplementedError):
        tsq.decompress(b"TSQX" + bytes(60), backend="cuda")
    with pytest.raises(NotImplementedError):
        tsq.decompress(stream, backend="cuda", dictionary=b"dict")
    with pytest.raises(NotImplementedError):
        tsq.compress(b"data", backend="cuda")
    with pytest.raises(NotImplementedError):
        tsq.compress(b"data", dictionary=b"dict")
    with pytest.raises(FormatError):
        tsq.decompress(b"not a tsq stream", backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tsq.decompress(stream, backend="tpu")
