"""The port's container encode (``pipeline.compress`` and the public API)
on the CPU, where the kernels run their plain versions: every container
must be byte-identical to the native core's and to the JAX pipeline's, and
decode back through the port. Also the API's repaired routes:
``dictionary=`` on the host backends and ``progress=``."""

import sys
import time
from pathlib import Path

import jax
import pytest
import torch

from turbosqueeze_tpu.parallel import mesh as ref_mesh
from turbosqueeze_tpu.parallel import pipeline as ref_pipeline
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import encode_emit as PE
from turbosqueeze_tpu_torch.parallel import pipeline

import turbosqueeze_tpu_torch as tsq

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import jax_core, port_core  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def native():
    jax_core()  # the JAX pipeline's reference runs on it
    return port_core()


@pytest.fixture(scope="module")
def data():
    return (synthetic_text(120_000, seed=81) + bytes(5_000)
            + synthetic_binary(60_000, seed=82))


@pytest.fixture
def matchers(monkeypatch):
    """Counts the emit calls of each matcher."""
    calls = {"cand": 0, "table": 0}
    real = PE.emit_batch

    def spy(*a, matcher="cand", **k):
        calls[matcher] += 1
        return real(*a, matcher=matcher, **k)

    monkeypatch.setattr(PE, "emit_batch", spy)
    return calls


@pytest.mark.parametrize("level, route", [(0, {"cand": 0, "table": 1}),
                                          (1, {"cand": 1, "table": 0}),
                                          (2, {"cand": 0, "table": 0})])
@pytest.mark.parametrize("ext", [True, False])
def test_matches_native_and_roundtrips(native, data, matchers, level, route,
                                       ext):
    stream = pipeline.compress(data, ext, level=level, device="cpu")
    assert stream == native.compress(data, ext, level=level)
    assert matchers == route
    assert pipeline.decompress(stream, device="cpu") == data


def test_level2_matches_jax_pipeline(native, data):
    ref = ref_pipeline.compress(data, True, level=2,
                                mesh=ref_mesh.block_mesh(jax.devices()[:1]))
    assert pipeline.compress(data, True, level=2, device="cpu") == ref


def test_multiblock_level2(native):
    """Two blocks, the second short, in windows of one block: phase A in
    torch, the lazy parse on the host."""
    data = synthetic_text((1 << 22) + 70_000, seed=83)
    seen = []
    stream = pipeline.compress(data, True, level=2, device="cpu",
                               window_blocks=1,
                               progress=lambda *a: seen.append(a))
    assert stream == native.compress(data, True, level=2)
    assert seen == [(1, 2), (2, 2)]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_dictionary_matches_native(native, level):
    d = synthetic_text(33_000, seed=84)
    data = synthetic_text(90_000, seed=85)
    want = native.compress_dict(data, d, True, level=max(level, 1))
    assert pipeline.compress(data, True, level=level, device="cpu",
                             dictionary=d) == want
    assert native.decompress_dict(want, d) == data


def test_empty_input(native):
    assert pipeline.compress(b"", device="cpu") == native.compress(b"")


@pytest.mark.parametrize("with_dict", [False, True], ids=["plain", "dict"])
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("emit_impl", ["bulk", "flat"])
def test_emitters_match_native(native, data, emit_impl, level, with_dict):
    """The two-pass and flat emitters through ``compress``: the native
    core's containers at every level, with and without a dictionary (which
    lifts the level to 1); the emitter runs only where the level-1 parse
    does."""
    from turbosqueeze_tpu_torch.kernels import encode_bulk as PEB
    from turbosqueeze_tpu_torch.kernels import encode_flat as PEF

    d = synthetic_text(33_000, seed=84) if with_dict else None
    calls = []
    real = {"bulk": PEB.emit_bulk_batch, "flat": PEF.flat_emit_batch}
    mod = PEB if emit_impl == "bulk" else PEF
    name = real[emit_impl].__name__
    spy = lambda *a, **k: calls.append(1) or real[emit_impl](*a, **k)  # noqa
    setattr(mod, name, spy)
    try:
        got = pipeline.compress(data, True, level=level, device="cpu",
                                dictionary=d, emit_impl=emit_impl)
    finally:
        setattr(mod, name, real[emit_impl])
    want = (native.compress_dict(data, d, True, level=max(level, 1)) if d
            else native.compress(data, True, level=level))
    assert got == want
    assert len(calls) == (1 if level == 1 or (d and level < 2) else 0)


@pytest.mark.parametrize("emit_impl", ["bulk", "flat"])
def test_overflowed_blocks_take_the_host(native, monkeypatch, emit_impl):
    """A block the emitter flags as overflowed is emitted on the host from
    the device's candidates: the container is still the native core's,
    and ``overflow_blocks`` counts the block."""
    from turbosqueeze_tpu_torch.kernels import encode_bulk as PEB
    from turbosqueeze_tpu_torch.kernels import encode_flat as PEF

    data = synthetic_text((1 << 22) + 90_000, seed=90)
    mod, name = ((PEB, "emit_bulk_batch") if emit_impl == "bulk"
                 else (PEF, "flat_emit_batch"))
    real = getattr(mod, name)

    def flags_block_1(*a, **k):
        words, osz = real(*a, **k)
        osz[1, 0], osz[1, 2] = -1, 1  # the size is no use once flagged
        return words, osz

    monkeypatch.setattr(mod, name, flags_block_1)
    before = pipeline.overflow_blocks
    got = pipeline.compress(data, True, level=1, device="cpu",
                            emit_impl=emit_impl)
    assert got == native.compress(data, True, level=1)
    assert pipeline.overflow_blocks == before + 1


def test_unknown_emit_impl_raises():
    with pytest.raises(ValueError, match="emit_impl"):
        pipeline.compress(b"abc" * 100, device="cpu", emit_impl="tree")


def test_bad_dictionary_raises():
    for d in (b"", bytes(65_533)):
        with pytest.raises(ValueError, match="dictionary"):
            pipeline.compress(b"abc" * 100, device="cpu", dictionary=d)


def test_cuda_backend_without_gpu_raises(monkeypatch, data):
    """No GPU: the cuda backend raises and never falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for kwargs in ({}, {"level": 1}, {"level": 2},
                   {"dictionary": b"abcd" * 100}):
        for backend in ("cuda", "auto"):
            with pytest.raises(RuntimeError, match="CUDA"):
                tsq.compress(data, backend=backend, **kwargs)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsq.compress(data, **kwargs)  # the default runs on the card
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.compress(b"", device="cuda:0")


def test_progress_cadence(native):
    """One call per block, in block order, on the port's pipeline and the
    public API, for compress and decompress."""
    data = bytes(3 << 22) + synthetic_text(1_000, seed=86)  # fast to decode
    seen = []
    stream = pipeline.compress(data, True, level=2, device="cpu",
                               window_blocks=2,
                               progress=lambda *a: seen.append(a))
    assert seen == [(1, 4), (2, 4), (3, 4), (4, 4)]
    seen.clear()
    assert pipeline.decompress(stream, device="cpu", window_blocks=3,
                               progress=lambda *a: seen.append(a)) == data
    assert seen == [(1, 4), (2, 4), (3, 4), (4, 4)]
    for backend in ("native", "cuda"):
        seen.clear()
        kw = {"device": "cpu"} if backend == "cuda" else {}
        out = tsq.decompress(stream, backend=backend,
                             progress=lambda *a: seen.append(a), **kw)
        assert out == data and seen[-1] == (4, 4) and len(seen) == 4
    seen.clear()
    assert tsq.compress(data, backend="native", level=2,
                        progress=lambda *a: seen.append(a)) == stream
    assert sorted(seen) == [(1, 4), (2, 4), (3, 4), (4, 4)]


def test_api_dictionary_on_host_backends(native):
    """``dictionary=`` routes as in the JAX package: native compress to
    ``compress_dict`` (level >= 1), native decompress to
    ``decompress_dict``, oracle decompress to the oracle's own."""
    d = synthetic_text(20_000, seed=87)
    data = synthetic_text(50_000, seed=88)
    stream = tsq.compress(data, backend="native", dictionary=d)
    assert stream == native.compress_dict(data, d, True, level=1)
    assert tsq.compress(data, backend="cuda", device="cpu", dictionary=d,
                        level=0) == stream
    for backend in ("native", "oracle"):
        assert tsq.decompress(stream, backend=backend, dictionary=d) == data
    assert tsq.decompress(stream, backend="auto", device="cpu",
                          dictionary=d) == data  # auto is the card's route
    with pytest.raises(NotImplementedError, match="native or cuda"):
        tsq.compress(data, backend="oracle", dictionary=d)
    # and the cuda decode to the device pipeline's dictionary routes
    assert tsq.decompress(stream, backend="cuda", device="cpu",
                          dictionary=d) == data


@pytest.mark.parametrize("route", ["compress", "decompress"])
def test_first_native_use_in_the_pool(native, monkeypatch, route):
    """The native core loads on first use, under a lock: a pipeline whose
    first native call runs in its thread pool gets the core in every
    thread."""
    data = bytes(3 << 22) + synthetic_text(1_000, seed=89)
    stream = native.compress(data, True, level=2)
    real_cdll = native.ctypes.CDLL

    def slow_cdll(*a, **k):  # a first load from disk takes a while
        time.sleep(0.2)
        return real_cdll(*a, **k)

    monkeypatch.setattr(native.ctypes, "CDLL", slow_cdll)
    monkeypatch.setattr(native, "_lib", None)
    if route == "compress":
        assert pipeline.compress(data, True, level=2, device="cpu") == stream
    else:
        assert pipeline.decompress(stream, device="cpu", impl="gang") == data
