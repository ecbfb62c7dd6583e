"""The plain reference against the program's native core, whose
containers the card's must equal; the reference decoder on the native
core's payloads; the checks; and the roofline's byte counts."""

import os

import numpy as np
import pytest

from gpubench.gen import pools, text_standin
from gpubench.lib import roofline
from gpubench.reference import checks
from gpubench.reference import tsq_codec as R
from turbosqueeze_tpu_torch.runtime import native


def _classes():
    return {
        "text": pools.synthetic_text(300_000, 3),
        "binary": np.random.default_rng(4).integers(
            0, 8, 300_000, np.uint8).repeat(2)[::3].tobytes(),
        "random": os.urandom(70_000),
        "zeros": bytes(200_000),
        "licenses": pools.real_file("licenses.txt")[:250_000],
        "source": pools.real_file("source.txt")[:400_001],
        "tiny": b"abcabcabcabcabcabc",
        "one": b"x",
        "five": b"aaaaa",
        "mixed": (pools.synthetic_text(90_000, 5) + bytes(70_000)
                  + os.urandom(5000) + pools.synthetic_text(90_000, 5)),
    }


CLASSES = _classes()


def _payload(data, ext, level):
    c = native.compress(data, ext, level=level)
    n, total, table = R.parse_container(c)
    assert (n, total) == (1, len(data))
    off, size, e = table[0]
    assert e == ext
    return c[off:off + size]


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("ext", [True, False])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_reference_parse_is_the_native_parse(name, ext, level):
    data = CLASSES[name]
    assert R.encode_block(data, ext, level) == _payload(data, ext, level)


@pytest.mark.parametrize("level", [0, 1])
def test_reference_on_a_full_block_of_the_text(level):
    data = text_standin.generate(11, 4 << 20)
    assert len(data) == 4 << 20
    assert R.encode_block(data, True, level) == _payload(data, True, level)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("ext", [True, False])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_reference_decoder_reads_the_native_payloads(name, ext, level):
    data = CLASSES[name]
    assert R.decode_block(_payload(data, ext, level), ext) == data


def test_reference_decoder_refuses_broken_payloads():
    data = CLASSES["source"]
    p = _payload(data, True, 0)
    assert R.decode_block(p, True) == data
    for bad in (p[:-1], p + b"\0", p[:4], p[:3] + b"\0" * (len(p) - 3)):
        with pytest.raises(R.FormatError):
            R.decode_block(bad, True)
    with pytest.raises(R.FormatError):  # ext codes in a block without ext
        R.decode_block(_payload(CLASSES["text"], True, 0), False)


def test_candidates_are_the_native_candidates():
    data = CLASSES["mixed"]
    assert R.candidates(data) == native.build_candidates(data).tolist()


def test_parse_container_refuses_broken_layouts():
    c = native.compress(CLASSES["text"], True, level=0)
    R.parse_container(c)
    for bad in (c[:-1], c + b"\0", b"TSQ2" + c[4:], c[:10]):
        with pytest.raises(R.FormatError):
            R.parse_container(bad)


def test_container_faults_and_bad_blocks():
    data = CLASSES["text"] * 30  # two blocks and a part
    c = native.compress(data, True, level=1)
    ok = {"bad_layout": 0, "undecodable_blocks": 0, "bad_blocks": 0,
          "differing_calls": 0}
    assert checks.container_faults([c, c], data, True, 1, [0, 2], 2) == ok
    assert checks.container_faults([c], data, True, 0, [0, 2], 2) == \
        {**ok, "bad_blocks": 2}
    assert checks.container_faults([c], data, False, 1, [0], 2) == \
        {**ok, "bad_layout": 1, "undecodable_blocks": 3, "bad_blocks": 1}
    assert checks.container_faults([c, c[:-1]], data, True, 1, [2], 2) == \
        {**ok, "bad_layout": 1, "bad_blocks": 1, "differing_calls": 1}
    assert checks.container_faults([], data, True, 1, [2], 2) == \
        {**ok, "undecodable_blocks": 3}
    # one byte of block 1's payload, outside the sample: decoding finds it
    o, s, _ = R.parse_container(c)[2][1]
    bad = bytearray(c)
    bad[o + s // 2] ^= 0x5A
    assert checks.container_faults([bytes(bad)], data, True, 1, [0, 2],
                                   1) == {**ok, "undecodable_blocks": 1}
    assert checks.bad_blocks(data, data) == 0
    out = bytearray(data)
    out[(4 << 20) + 5] ^= 1
    assert checks.bad_blocks(bytes(out), data) == 1
    assert checks.bad_blocks(data[:-1], data) == 3
    assert checks.bad_blocks(None, data) == 3


@pytest.mark.parametrize("per_window", [16, 32])
def test_sample_blocks_take_one_a_window_and_the_last(per_window):
    for n in (1, 31, 239, 256):
        s = checks.sample_blocks(n, np.random.default_rng(n), per_window)
        assert s == sorted(set(s)) and s[-1] == n - 1
        assert {b // per_window for b in s} == set(
            range(-(-n // per_window)))


def test_roofline_counts_bytes_from_inputs_and_outputs():
    assert roofline.decode_bytes(451_000_000, 10**9) == 1_451_000_000
    assert roofline.compress_bytes(10**9, 451_000_000) == 1_451_000_000
    assert roofline.BYTES == {"decode": roofline.decode_bytes,
                              "compress": roofline.compress_bytes}
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.PEAK_HBM_BYTES_PER_S == 3.35e12
