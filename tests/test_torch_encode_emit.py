"""The port's token emitter (turbosqueeze_tpu_torch/kernels/encode_emit.py)
on the CPU, where ``emit_batch`` runs its plain version: held against the
JAX package's Pallas kernel (interpret mode), the native core's emission
and the upstream parse. Tolerance zero: the first ``osz[b, 0]`` bytes of
each block and ``osz`` itself must be equal."""

import collections
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu.format import iter_container
from turbosqueeze_tpu.kernels import encode_emit as RE
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import encode_emit as PE
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_encode_emit import (  # noqa: E402
    _dead_size_slot_case, _window_edge_case)
from test_torch_host_copies import port_core  # noqa: E402


@pytest.fixture(scope="module")
def native():
    return port_core()


def _planes(native, blocks, dictionary=b"", cand=True):
    iw = np.stack([RE.pack_input_words(dictionary + b) for b in blocks])
    planes = [iw]
    if cand:
        planes.append(np.stack([RE.pack_cand_words(
            native.build_candidates(dictionary + b)) for b in blocks]))
    planes.append(PE.pack_meta([len(b) for b in blocks], len(dictionary)))
    return planes


def _port(planes, ext, matcher):
    t = planes_to_torch(*planes, device="cpu")
    if matcher == "table":
        t.insert(1, None)
    words, osz = PE.emit_batch(*t, ext=ext, matcher=matcher)
    assert words.dtype == osz.dtype == torch.int32
    assert tuple(words.shape) == (len(planes[0]), PE.OUT_ROWS, 128)
    assert tuple(osz.shape) == (len(planes[0]), 8)
    assert not osz[:, 1:].any()
    return [PE.payload_from_words(words[b], int(osz[b, 0]))
            for b in range(words.shape[0])]


def _edge_blocks():
    rng = np.random.default_rng(6)
    text = synthetic_text(30_000, seed=32)
    period = synthetic_text(65_300, seed=33)
    return {
        "max_matches": [bytes(20_000)],
        "incompressible": [rng.bytes(40_000)],
        "batch_edges": [text, text[:5_000] + rng.bytes(4_000) + bytes(3_000),
                        text[:37], b"x", synthetic_binary(20_000, seed=9)],
        "far_offsets": [(period * 2)[:100_000]],
        "dead_size_slot": list(_dead_size_slot_case())[:8],
        "window_edge": [_window_edge_case(q)
                        for q in (65535, 65544, 65554, 65565)],
    }


@pytest.mark.parametrize("ext", [True, False])
def test_cand_matches_jax_kernel(native, ext):
    """One batch through the Pallas kernel (interpret mode) and the port:
    a 40 KB text block, a 5-byte block and an empty block."""
    blocks = [synthetic_text(40_000, seed=31), b"abcab", b""]
    planes = _planes(native, blocks)
    out, osz = RE.emit_batch(*planes, ext=ext, interpret=True)
    out, osz = np.asarray(out), np.asarray(osz)
    want = [RE.payload_from_words(out[b], int(osz[b, 0]))
            for b in range(len(blocks))]
    assert _port(planes, ext, "cand") == want
    assert len(want[2]) == 5  # an empty block is its header and two slots


@pytest.mark.parametrize("matcher", ["cand", "table"])
@pytest.mark.parametrize("case", list(_edge_blocks()))
def test_matches_native(native, case, matcher):
    """``"cand"`` against ``native.encode_block_candidates`` (level 1) and
    ``"table"`` against native level 0, ext on and off."""
    blocks = _edge_blocks()[case]
    planes = _planes(native, blocks, cand=matcher == "cand")
    for ext in (True, False):
        if matcher == "cand":
            want = [native.encode_block_candidates(
                b, native.build_candidates(b), ext) for b in blocks]
        else:
            want = [next(iter_container(native.compress(b, ext, level=0)))[1]
                    for b in blocks]
        assert _port(planes, ext, matcher) == want, ext


def test_cand_dictionary_base(native):
    """concat(dict, block) input, the parse starting at the base offset:
    byte-identical to the host dictionary emission."""
    d = synthetic_text(33_000, seed=34)
    blocks = [synthetic_text(8_000, seed=34)[4_000:] + bytes(2_000),
              synthetic_text(50_000, seed=35)]
    planes = _planes(native, blocks, dictionary=d)
    for ext in (True, False):
        want = [native.encode_block_dict(
            b, d, native.build_candidates(d + b), ext) for b in blocks]
        assert _port(planes, ext, "cand") == want


def test_table_matches_upstream_parse(native):
    """``"table"`` against the executable spec of the upstream parse (the
    oracle codec), which native level 0 reproduces."""
    from turbosqueeze_tpu import reference_codec

    blocks = [synthetic_text(20_000, seed=42),
              np.random.default_rng(7).bytes(6_000) + bytes(3_000)]
    planes = _planes(native, blocks, cand=False)
    for ext in (True, False):
        want = [reference_codec.encode_block(b, ext) for b in blocks]
        assert _port(planes, ext, "table") == want


def test_table_matches_upstream_binary(native, golden_harness, tmp_path):
    blk = synthetic_text(50_000, seed=44) + bytes(3_000)
    src, dst = tmp_path / "in", tmp_path / "out"
    src.write_bytes(blk)
    subprocess.run([str(golden_harness), "eb", "1", str(src), str(dst)],
                   check=True)
    assert _port(_planes(native, [blk], cand=False), True, "table") == [
        dst.read_bytes()]


def test_host_glue_matches_reference():
    rng = np.random.default_rng(4)
    blk = rng.bytes(70_001)
    assert np.array_equal(PE.pack_input_words(blk), RE.pack_input_words(blk))
    cand = rng.integers(-1, 70_000, 70_001, dtype=np.int32)
    assert np.array_equal(PE.pack_cand_words(cand), RE.pack_cand_words(cand))
    words = RE.pack_input_words(blk)
    assert PE.payload_from_words(words, 5000) == RE.payload_from_words(
        words, 5000)
    assert PE.payload_from_words(torch.from_numpy(words), 5000) == blk[:5000]


def test_wrapper_checks(native):
    iw, cw, meta = planes_to_torch(*_planes(native, [b"hello hello hello"]),
                                   device="cpu")
    with pytest.raises(ValueError, match="int32"):
        PE.emit_batch(iw.to(torch.int64), cw, meta)
    with pytest.raises(ValueError, match="cand_words"):
        PE.emit_batch(iw, cw[:, :8], meta)
    with pytest.raises(ValueError, match="meta"):
        PE.emit_batch(iw, cw, meta[:, :4])
    with pytest.raises(ValueError, match="needs cand_words"):
        PE.emit_batch(iw, None, meta)
    with pytest.raises(ValueError, match="matcher"):
        PE.emit_batch(iw, cw, meta, matcher="bulk")
    with pytest.raises(ValueError, match="meta is on meta"):
        PE.emit_batch(iw, cw, meta.to("meta"))
    before = dict(PE.launches)
    PE.emit_batch(iw, cw, meta)
    PE.emit_batch(iw, None, meta, matcher="table")
    assert PE.launches == before  # CPU: the plain version, no launch


def test_refuses_meta_past_the_planes(native):
    """A size or base that does not fit the planes gets ``osz = -1`` and
    no payload; the other blocks are emitted as usual."""
    blocks = [b"abcabcabcabc", b"xyz"]
    iw, cw, meta = planes_to_torch(*_planes(native, blocks), device="cpu")
    meta[0, 0] = (1 << 22) + 1
    meta[1, 1] = PE.IN_ROWS * 512
    words, osz = PE.emit_batch(iw, cw, meta)
    assert osz[:, 0].tolist() == [-1, -1]
    assert not words.any()


def test_garbage_candidates_end(native):
    """A candidate chain that does not decrease ends where it stops: the
    parse terminates and its reads stay inside the planes."""
    rng = np.random.default_rng(8)
    blk = synthetic_text(20_000, seed=45)
    iw, cw, meta = planes_to_torch(*_planes(native, [blk]), device="cpu")
    cw[0].view(-1)[:len(blk)] = torch.from_numpy(
        rng.integers(-1, 2 * len(blk), len(blk), dtype=np.int32))
    cw[0].view(-1)[1000:1100] = torch.arange(1000, 1100, dtype=torch.int32)
    _, osz = PE.emit_batch(iw, cw, meta)
    assert 5 < int(osz[0, 0]) < 2 * len(blk)


# --- the warp kernel's premises (csrc/encode_emit.cu) ------------------------

from emit_cases import table_batches, table_cases  # noqa: E402
from gang_streams import CLASSES, class_blocks  # noqa: E402
from turbosqueeze_tpu_torch.kernels.encode_bulk import next_valid  # noqa: E402


@pytest.fixture(scope="module")
def class_cuts():
    """The eight classes of ``chip_smoke.py``'s input, each cut to 256
    KiB."""
    return [b[:1 << 18] for b in class_blocks(len(CLASSES))]


def _parse_cand_both(block, cand, ext, dictionary=b""):
    """``_parse_cand`` on ``dictionary + block`` with the next stop read
    from ``next_valid(cand)`` and stepped one position at a time: both
    (payload, osz)."""
    d = len(dictionary)
    planes = torch.from_numpy(PE.pack_input_words(dictionary + block)[None])
    inp, v4 = PE.block_input(planes.view(torch.uint8).reshape(1, -1), 0, d,
                             len(block))
    # the plane's -1 padding past the block, as the kernels see it
    nv = next_valid(torch.from_numpy(np.append(cand, -1))[None])[0].tolist()
    cand = cand.tolist()
    out = []
    for skip in (nv, None):
        buf = bytearray(PE.OUT_ROWS * 512)
        sink = PE._TokenSink(buf, len(block), d)
        PE._parse_cand(inp, v4, cand, sink, d, len(block), ext, nv=skip)
        n = sink.finish()
        out.append((bytes(buf[:n]), n))
    return out


@pytest.mark.parametrize("ext", [True, False])
@pytest.mark.parametrize("cls", range(len(CLASSES)), ids=CLASSES)
def test_cand_next_stop_premise(native, class_cuts, cls, ext):
    """The warp kernel finds the next candidate stop by ballot over
    ``cand[j] >= 0`` (next_valid's predicate) and jumps there: the jump
    gives the same payload and size as stepping one position at a time,
    and both give the native core's payload."""
    blk = class_cuts[cls]
    cand = native.build_candidates(blk)
    jump, step = _parse_cand_both(blk, cand, ext)
    assert jump == step
    assert jump[0] == native.encode_block_candidates(blk, cand, ext)


@pytest.mark.parametrize("ext", [True, False])
def test_cand_next_stop_premise_dictionary_and_garbage(native, ext):
    """The same on a dictionary base and on garbage candidate planes
    (chains that do not decrease, entries past the block)."""
    d = synthetic_text(33_000, seed=34)
    blk = synthetic_text(60_000, seed=36) + bytes(3_000)
    cand = native.build_candidates(d + blk)
    jump, step = _parse_cand_both(blk, cand, ext, d)
    assert jump == step
    assert jump[0] == native.encode_block_dict(blk, d, cand, ext)
    rng = np.random.default_rng(9)
    blk = synthetic_text(40_000, seed=37)
    cand = rng.integers(-3, 2 * len(blk), len(blk), dtype=np.int32)
    cand[rng.random(len(blk)) < 0.5] = -1
    cand[1000:1100] = np.arange(1000, 1100, dtype=np.int32)
    jump, step = _parse_cand_both(blk, cand, ext)
    assert jump == step


# the batch rules each hand-made case must drive
_CASE_EVENTS = {
    "same_hash": ("forwarded", "shared_hash"),
    "stop_lanes": tuple(f"stop_lane_{lane}" for lane in range(32)),
    "flush_parity": ("flush_parity_0", "flush_parity_1", "near_anchor_0"),
    "end_in_batch": ("end_in_batch", "past_end_found"),
    "stale_alias": ("stale_found",),
}


@pytest.mark.parametrize("case", list(_CASE_EVENTS))
def test_table_cases_match_native(native, case):
    """``tests/emit_cases.py``'s hand-made blocks: ``"table"`` equals
    native level 0, ext on and off; so does the model of the kernel's
    32-lane batch, and the case drives the batch rules it is made for."""
    blocks = table_cases()[case]
    planes = _planes(native, blocks, cand=False)
    events = collections.Counter()
    for ext in (True, False):
        want = [next(iter_container(native.compress(b, ext, level=0)))[1]
                for b in blocks]
        assert _port(planes, ext, "table") == want, ext
        for b, w in zip(blocks, want):
            got, ev = table_batches(b, ext)
            assert got == w, ext
            events.update(ev)
    assert all(events[e] > 0 for e in _CASE_EVENTS[case]), events
