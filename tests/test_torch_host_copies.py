"""The port's own copies of the JAX package's host modules, held against
the originals on the CPU with tolerance "equal": ``format``, the oracle
codec, the corpus generators and the ctypes binding to the C++ host core
(``turbosqueeze_tpu_torch/runtime/native.py``), function for function.

This module also holds the native-core helpers of the port's tests.
``port_core()`` is the port's binding, built by its own locked build
(``build/torch_core/``). ``jax_core()`` is the JAX package's binding,
which loads ``build/libtsq_core.so``: where that library does not load,
the helper builds ``csrc`` there with the Makefile's flags (a build of
its own, not a copy of the port's) through the port's library builder
(``utils/sharedlib.py``), which skips the build if another process has
just made the library current. The two bindings then load two builds of
the same sources. No test of the port
runs ``make``. Importing this module runs both
helpers once: pytest imports every test module in every worker before it
runs a test, so the library exists before any fixture looks for it.
"""

import ctypes
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import turbosqueeze_tpu.format as RF
from turbosqueeze_tpu import reference_codec as RC
from turbosqueeze_tpu.utils import corpus as RCORP
from turbosqueeze_tpu_torch import format as PF
from turbosqueeze_tpu_torch import reference_codec as PC
from turbosqueeze_tpu_torch.runtime import native as PN
from turbosqueeze_tpu_torch.utils import corpus as PCORP
from turbosqueeze_tpu_torch.utils import sharedlib

REPO = Path(__file__).resolve().parents[1]
MiB = 1 << 20


def port_core():
    """The port's native binding, built at first use under its lock."""
    assert PN.available()
    return PN


def _loads(ref) -> bool:
    ref._SEARCHED = False  # search again: the library may be new
    try:
        return ref.available()
    except OSError:  # a library another process is still writing
        return False


def jax_core():
    """The JAX package's native binding, for the tests' reference."""
    from turbosqueeze_tpu.runtime import native as ref

    if not _loads(ref):  # a build of its own, as make would give
        sharedlib.build([PN.CSRC / s for s in PN.SOURCES],
                        [PN.CSRC / h for h in PN.HEADERS],
                        REPO / "build" / "libtsq_core.so", lambda: [PN.CXX],
                        PN.CXXFLAGS, PN.CXXFLAGS, what="native core")
    assert _loads(ref)
    return ref


def _prebuild():
    try:
        port_core()
        jax_core()
    except Exception:  # noqa: BLE001 - the fixtures raise it again
        pass


_prebuild()


@pytest.fixture(scope="module")
def cores():
    return port_core(), jax_core()


# --- format ------------------------------------------------------------------

def test_format_constants_equal():
    for name in ("BLOCK_SZ", "OUTPUT_SZ", "HASH_MASK", "HASH_ENTRIES",
                 "MLEN_TABLE", "MAGIC", "CONTAINER_HEADER_SZ",
                 "BLOCK_HEADER_SZ", "EXT_FLAG", "BLOCK_PAYLOAD_MASK",
                 "EXT_CODE_LENGTHS"):
        assert getattr(PF, name) == getattr(RF, name), name
    assert PF.FormatError is not RF.FormatError
    assert issubclass(PF.FormatError, ValueError)


def _containers(ref):
    data = (PCORP.synthetic_text(3 * MiB, seed=5) + bytes(2 * MiB)
            + PCORP.synthetic_binary(100_000, seed=6))
    return [ref.compress(data, ext, level=lv)
            for ext, lv in ((True, 0), (False, 1), (True, 2))] + [
        ref.compress(b"", True), RC.compress(b"abc" * 500, False)]


def test_format_containers_equal(cores):
    _, ref = cores

    def fields(h):
        return h.n_blocks, h.total_size

    for c in _containers(ref):
        (ph, pt), (rh, rt) = PF.scan_block_table(c), RF.scan_block_table(c)
        assert (fields(ph), pt) == (fields(rh), rt)
        assert fields(PF.ContainerHeader.unpack(c)) == fields(rh)
        assert list(PF.iter_container(c)) == list(RF.iter_container(c))
    data = PCORP.synthetic_text(9 * MiB + 7, seed=8)
    assert PF.split_blocks(data) == RF.split_blocks(data)
    assert PF.split_blocks(b"") == RF.split_blocks(b"") == []
    for n, ext in ((1, True), (5000, False), (PF.BLOCK_PAYLOAD_MASK, True)):
        assert PF.pack_block_header(n, ext) == RF.pack_block_header(n, ext)
    assert (PF.ContainerHeader(3, 12_345).pack()
            == RF.ContainerHeader(3, 12_345).pack())


def test_format_errors_on_the_same_containers(cores):
    _, ref = cores
    good = _containers(ref)[0]
    bad = [good[:10], b"TSQ2" + good[4:], good[:16] + good[16:18],
           good[:-1], good[:16] + b"\xff\xff\x7f" + good[19:]]
    for c in bad:
        for scan in (lambda c: PF.scan_block_table(c),
                     lambda c: list(PF.iter_container(c))):
            with pytest.raises(PF.FormatError):
                scan(c)
        for scan in (lambda c: RF.scan_block_table(c),
                     lambda c: list(RF.iter_container(c))):
            with pytest.raises(RF.FormatError):
                scan(c)
    for fmt in (PF, RF):
        with pytest.raises(ValueError):
            fmt.pack_block_header(0, True)


# --- the oracle codec and the corpora ----------------------------------------

def test_oracle_codec_equal():
    cases = [b"x", b"a" * 1000, bytes(range(256)) * 8,
             PCORP.synthetic_text(40_000, seed=2),
             PCORP.synthetic_binary(30_000, seed=3)]
    for data in cases:
        for ext in (True, False):
            payload = PC.encode_block(data, ext)
            assert payload == RC.encode_block(data, ext)
            assert PC.decode_block(payload, ext) == data
            assert PC.tokenize_block(payload, ext) == RC.tokenize_block(
                payload, ext)
    stream = PC.compress(cases[3], True)
    assert stream == RC.compress(cases[3], True)
    assert PC.decompress(stream) == RC.decompress(stream) == cases[3]
    with pytest.raises(PF.FormatError):
        PC.decompress(stream[:-5])


@pytest.mark.parametrize("seed", [1, 99, 1234])
def test_corpus_generators_equal(seed):
    assert PCORP.synthetic_text(70_000, seed) == RCORP.synthetic_text(
        70_000, seed)
    assert PCORP.synthetic_binary(70_000, seed) == RCORP.synthetic_binary(
        70_000, seed)


def test_real_files_equal():
    got, want = PCORP.real_files(), RCORP.real_files()
    assert set(got) == set(want) and len(got) == 4
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("seed", [3, 7, 303])
def test_incompressible_and_checksum_equal(seed):
    for size in (0, 1, 5000, 70_001):
        got = PCORP.incompressible(size, seed)
        assert got == RCORP.incompressible(size, seed) and len(got) == size
        assert PCORP.checksum(got) == RCORP.checksum(got)
    assert PCORP.incompressible(100) == RCORP.incompressible(100)  # seed 7


def test_standard_cases_equal():
    got, want = PCORP.standard_cases(), RCORP.standard_cases()
    assert len(got) == len(want) == 11
    assert all(g == w for g, w in zip(got, want))


@pytest.mark.parametrize("include_real", [True, False])
def test_ratio_sweep_files_equal(include_real):
    got = PCORP.ratio_sweep_files(include_real)
    want = RCORP.ratio_sweep_files(include_real)
    assert list(got) == list(want)
    assert len(got) == (9 if include_real else 5)
    assert all(got[k] == want[k] for k in want)
    assert [len(v) for v in got.values()][:5] == [MiB] * 4 + [1_000_000]


# --- the native binding ------------------------------------------------------

_DATA = (PCORP.synthetic_text(300_000, seed=21) + bytes(50_000)
         + PCORP.synthetic_binary(120_000, seed=22)
         + np.random.default_rng(23).bytes(40_000))
_DICT = PCORP.synthetic_text(20_000, seed=24)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_native_codec_equal(cores, level):
    port, ref = cores
    for ext in (True, False):
        stream = port.compress(_DATA, ext, level=level)
        assert stream == ref.compress(_DATA, ext, level=level)
        assert port.decompress(stream) == ref.decompress(stream) == _DATA
    if level:
        stream = port.compress_dict(_DATA, _DICT, True, level=level)
        assert stream == ref.compress_dict(_DATA, _DICT, True, level=level)
        assert (port.decompress_dict(stream, _DICT)
                == ref.decompress_dict(stream, _DICT) == _DATA)


def test_native_progress_equal(cores):
    port, ref = cores
    data = bytes(3 * (4 * MiB)) + _DATA
    ticks = {}
    for name, mod in (("port", port), ("ref", ref)):
        seen = []
        stream = mod.compress(data, True, level=1,
                              progress=lambda *a: seen.append(a))
        mod.decompress(stream, progress=lambda *a: seen.append(a))
        ticks[name] = sorted(seen)
    assert ticks["port"] == ticks["ref"]
    assert ticks["port"][-1] == (4, 4) and len(ticks["port"]) == 8


def test_native_emission_helpers_equal(cores):
    port, ref = cores
    blk = _DATA[:200_000]
    cand = port.build_candidates(blk)
    assert np.array_equal(cand, ref.build_candidates(blk))
    for level in (1, 2, 4):
        for ext in (True, False):
            assert (port.encode_block_candidates(blk, cand, ext, level)
                    == ref.encode_block_candidates(blk, cand, ext, level))
            dcand = port.build_candidates(_DICT + blk)
            assert (port.encode_block_dict(blk, _DICT, dcand, ext, level)
                    == ref.encode_block_dict(blk, _DICT, dcand, ext, level))


def test_native_decode_prep_equal(cores):
    port, ref = cores
    stream = port.compress(_DATA, True, level=1)
    (_, payload, ext), = PF.iter_container(stream)
    for dlen in (0, 1000):
        a, b = port.tokenize_block(payload, ext, dlen), ref.tokenize_block(
            payload, ext, dlen)
        assert a[4] == b[4] and all(np.array_equal(x, y)
                                    for x, y in zip(a[:4], b[:4]))
    dstream = port.compress_dict(_DATA, _DICT, True)
    (_, dpayload, _), = PF.iter_container(dstream)
    preps = []
    for pl, d in ((payload, None), (dpayload, _DICT)):
        p, r = port.bulk_prep(pl, True, d), ref.bulk_prep(pl, True, d)
        assert all(np.array_equal(x, y) for x, y in zip(p, r))
        preps.append(p)
    merged = port.bulk_merge2(preps[0][1], preps[0][2], preps[1][1],
                              preps[1][2])
    assert all(np.array_equal(x, y) for x, y in zip(merged, ref.bulk_merge2(
        preps[0][1], preps[0][2], preps[1][1], preps[1][2])))
    for nblk in (1, 2, 3, 4):
        recs = [preps[k % 2][1] for k in range(nblk)]
        metas = [preps[k % 2][2] for k in range(nblk)]
        assert all(np.array_equal(x, y) for x, y in zip(
            port.bulk_mergen(recs, metas), ref.bulk_mergen(recs, metas)))
        assert all(np.array_equal(x, y) for x, y in zip(
            port.bulk_gang(recs, metas, 16), ref.bulk_gang(recs, metas, 16)))
    with pytest.raises(ValueError):
        port.bulk_mergen([preps[0][1]] * 5, [preps[0][2]] * 5)


def test_native_file_pipeline_equal(cores, tmp_path):
    """``compress_file`` and ``decompress_file`` write the JAX binding's
    files, with the same per-block progress, on several blocks."""
    port, ref = cores
    src = tmp_path / "src"
    src.write_bytes(bytes(2 * (4 * MiB)) + _DATA)
    files, ticks = {}, {}
    for name, mod in (("port", port), ("ref", ref)):
        tsq, out = tmp_path / f"{name}.tsq", tmp_path / f"{name}.out"
        seen = []
        n = mod.compress_file(str(src), str(tsq), True, 1,
                              progress=lambda *a: seen.append(a))
        assert n == tsq.stat().st_size
        assert mod.decompress_file(str(tsq), str(out),
                                   progress=lambda *a: seen.append(a)) == (
            src.stat().st_size)
        assert out.read_bytes() == src.read_bytes()
        files[name], ticks[name] = tsq.read_bytes(), sorted(seen)
    assert files["port"] == files["ref"] == port.compress(
        src.read_bytes(), True, level=1)
    assert ticks["port"] == ticks["ref"] and ticks["port"][-1] == (3, 3)
    # the port's binding takes path objects too
    assert port.decompress_file(tmp_path / "port.tsq", tmp_path / "again") \
        == src.stat().st_size
    with pytest.raises(PF.FormatError):
        port.decompress_file(str(src), str(tmp_path / "bad"))
    with pytest.raises(RuntimeError):
        port.compress_file(str(tmp_path / "missing"), str(tmp_path / "x"))
    assert port.streaming_ok("native")
    assert not any(port.streaming_ok(b) for b in ("auto", "cuda", "oracle"))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_native_array_api_equal(cores, level):
    """``compress_array`` and ``decompress_array``: numpy uint8 in and out,
    the JAX binding's bytes, the input back."""
    port, ref = cores
    arr = np.frombuffer(_DATA, np.uint8)
    for ext in (True, False):
        got = port.compress_array(arr, ext, level=level)
        want = ref.compress_array(arr, ext, level=level)
        assert got.dtype == np.uint8 and got.ndim == 1
        assert np.array_equal(got, want)
        assert got.tobytes() == port.compress(_DATA, ext, level=level)
        back = port.decompress_array(got)
        assert back.dtype == np.uint8 and np.array_equal(back, arr)
        assert np.array_equal(back, ref.decompress_array(want))
    empty = port.compress_array(np.zeros(0, np.uint8), level=level)
    assert np.array_equal(empty, ref.compress_array(np.zeros(0, np.uint8),
                                                    level=level))
    assert port.decompress_array(empty).size == 0


def test_native_array_api_errors_equal(cores):
    """A ``FormatError`` of each package on the same bad streams: a cut
    stream, a wrong magic, a block header past the stream."""
    port, ref = cores
    good = port.compress_array(np.frombuffer(_DATA, np.uint8), level=1)
    bad = [good[:20], np.concatenate([np.frombuffer(b"TSQ2", np.uint8),
                                      good[4:]]),
           good[:-1], np.zeros(3, np.uint8)]
    for arr in bad:
        with pytest.raises(PF.FormatError) as got:
            port.decompress_array(arr)
        with pytest.raises(RF.FormatError) as want:
            ref.decompress_array(arr)
        assert str(got.value) == str(want.value)


def test_native_errors(cores):
    port, _ = cores
    stream = port.compress(_DATA, True)
    with pytest.raises(PF.FormatError):
        port.decompress(stream[:100])
    with pytest.raises(PF.FormatError):
        port.bulk_prep(b"\x10\x00\x00\x00", True)  # shorter than 5
    with pytest.raises(ValueError, match="dictionary"):
        port.compress_dict(_DATA, b"", True)


def test_first_load_from_many_threads(monkeypatch):
    """A first load entered from several threads at once loads once, and
    every thread gets the core."""
    real_cdll, calls = ctypes.CDLL, []

    def slow_cdll(*a, **k):
        calls.append(a)
        time.sleep(0.2)
        return real_cdll(*a, **k)

    monkeypatch.setattr(PN.ctypes, "CDLL", slow_cdll)
    monkeypatch.setattr(PN, "_lib", None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(PN._load()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)
