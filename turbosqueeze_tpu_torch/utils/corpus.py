"""Deterministic corpora for tests and ``chip_smoke.py``: the port's own
copy of ``turbosqueeze_tpu/utils/corpus.py``.
``tests/test_torch_host_copies.py`` holds them equal to the original's
for the same seeds.

The seeded generators stand in for enwik-like text and structured binary:
word and phrase reuse, zero pages, repeating records and random spans
exercise literal runs, short and long matches and 64 KiB window edges.
"""

from __future__ import annotations

import random
import zlib
from typing import List

_WORDS = (
    "the of and a in to is was it for as on with be by at from that his he "
    "an are this which or had not but first one their its new after who they "
    "two her she been other when there all during into time may more these "
    "also world war united states city state american national government "
    "century people between history many years over war army french german "
    "system called general based against university following found however "
    "[[link]] {{cite}} &amp; &lt;ref&gt; </ref> <text> </text> == === "
).split()


def synthetic_text(size: int, seed: int = 1234) -> bytes:
    """Wiki-like text with heavy word/phrase repetition (enwik stand-in)."""
    rng = random.Random(seed)
    out = bytearray()
    phrases: List[bytes] = []
    while len(out) < size:
        r = rng.random()
        if r < 0.08 and phrases:
            out += rng.choice(phrases)  # repeat an earlier phrase (long match)
        else:
            phrase = bytearray()
            for _ in range(rng.randint(3, 12)):
                phrase += rng.choice(_WORDS).encode()
                phrase += b" "
            if rng.random() < 0.1:
                phrase += b"\n"
            if len(phrases) < 4096:
                phrases.append(bytes(phrase))
            out += phrase
    return bytes(out[:size])


def synthetic_binary(size: int, seed: int = 99) -> bytes:
    """Mixed structured binary: zero pages, repeating records, random spans."""
    rng = random.Random(seed)
    out = bytearray()
    record = bytes(rng.randrange(256) for _ in range(64))
    while len(out) < size:
        r = rng.random()
        if r < 0.25:
            out += bytes(rng.randrange(1, 4096))
        elif r < 0.6:
            out += record * rng.randrange(1, 64)
        else:
            out += bytes(rng.randrange(256) for _ in range(rng.randrange(16, 2048)))
    return bytes(out[:size])


def incompressible(size: int, seed: int = 7) -> bytes:
    """High-entropy bytes (worst case: pure literal output)."""
    rng = random.Random(seed)
    return rng.randbytes(size)


def standard_cases() -> List[bytes]:
    """Small corpus used across unit tests."""
    text = synthetic_text(40_000)
    return [
        b"x",
        b"abc",
        b"a" * 17,
        b"a" * 1000,
        bytes(range(256)) * 8,
        text[:699],
        text,
        incompressible(5000),
        synthetic_binary(30_000),
        (b"abcdefgh" * 100 + incompressible(200, seed=3)) * 3,
        synthetic_text(70_000, seed=2) + incompressible(3000, seed=4),
    ]


def real_files() -> dict:
    """Real (non-synthetic) corpus classes bundled in the repository,
    decompressed from tests/data/real/*.xz (provenance and licenses in the
    NOTICE.md beside them): English legal text, English reference
    documentation, Python source code and Python bytecode."""
    import lzma
    from pathlib import Path

    d = Path(__file__).resolve().parents[2] / "tests" / "data" / "real"
    out = {}
    for name in ("licenses.txt", "pydoc.txt", "source.txt", "binary.bin"):
        f = d / (name + ".xz")
        if f.exists():
            out["real-" + name.split(".")[0]] = lzma.decompress(
                f.read_bytes())
    return out


def ratio_sweep_files(include_real: bool = True) -> dict:
    """The file classes of the ratio sweep: 1 MiB each of synthetic text,
    structured binary records, zeros and incompressible bytes, a mixed
    file of all four, and with ``include_real`` the in-repo real files
    (``real_files``)."""
    files = {
        "text": synthetic_text(1 << 20, seed=301),
        "binary-records": synthetic_binary(1 << 20, seed=302),
        "zeros": bytes(1 << 20),
        "incompressible": incompressible(1 << 20, seed=303),
        "mixed": (synthetic_text(300_000, seed=304)
                  + incompressible(200_000, seed=305)
                  + synthetic_binary(300_000, seed=306)
                  + bytes(200_000)),
    }
    if include_real:
        files.update(real_files())
    return files


def checksum(data: bytes) -> int:
    """CRC-32 (zlib) of ``data``."""
    return zlib.crc32(data)
