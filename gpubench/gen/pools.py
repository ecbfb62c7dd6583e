"""The byte pools the generators cut their pieces from, frozen with the
benchmark so that a change to the program or its tests cannot change the
traffic.

``synthetic_text`` is a copy of the wiki-markup text recipe of
``turbosqueeze_tpu_torch/utils/corpus.py`` (the same bytes for the same
seed). ``real_file`` reads one of the xz-compressed real files under
``tests/data/real`` and refuses it unless both its compressed and its raw
SHA-256 are the ones pinned in ``gpubench/data/pins.json``.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import random
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]   # the checkout
PINS = Path(__file__).resolve().parents[1] / "data" / "pins.json"

# the real files the text stand-in reads
REAL_FILES = ("licenses.txt", "pydoc.txt", "source.txt")


class PinError(RuntimeError):
    """A pinned input file is missing or differs from its pin."""


def real_file(name: str) -> bytes:
    """The raw bytes of ``tests/data/real/<name>.xz``, checked against
    both of its pins."""
    rel = f"tests/data/real/{name}.xz"
    pin = json.loads(PINS.read_text())[rel]
    path = ROOT / rel
    if not path.is_file():
        raise PinError(f"{rel}: missing (the benchmark reads it from the "
                       "checkout)")
    packed = path.read_bytes()
    if hashlib.sha256(packed).hexdigest() != pin["xz_sha256"]:
        raise PinError(f"{rel}: SHA-256 differs from its pin")
    raw = lzma.decompress(packed)
    if hashlib.sha256(raw).hexdigest() != pin["raw_sha256"]:
        raise PinError(f"{rel}: raw SHA-256 differs from its pin")
    return raw


_WORDS = (
    "the of and a in to is was it for as on with be by at from that his he "
    "an are this which or had not but first one their its new after who they "
    "two her she been other when there all during into time may more these "
    "also world war united states city state american national government "
    "century people between history many years over war army french german "
    "system called general based against university following found however "
    "[[link]] {{cite}} &amp; &lt;ref&gt; </ref> <text> </text> == === "
).split()


def synthetic_text(size: int, seed: int) -> bytes:
    """Wiki-like text with heavy word and phrase repetition."""
    rng = random.Random(seed)
    out = bytearray()
    phrases: List[bytes] = []
    while len(out) < size:
        r = rng.random()
        if r < 0.08 and phrases:
            out += rng.choice(phrases)  # an earlier phrase again
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
