"""A text stand-in for enwik9 (the upstream's ``tsq b`` input, not in the
repository): ``n_bytes`` of pieces of 500-70,000 bytes, each a slice at a
seeded offset of one of four pools, the pool drawn uniformly:

- a 4 MiB pool of the wiki-markup ``synthetic_text`` recipe (seed 501);
- ``licenses.txt``, ``pydoc.txt`` and ``source.txt`` of ``tests/data/
  real`` (English legal text, English reference documentation, Python
  source), read through their pins.

The pools are made once a call; the pieces come from
``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np

from . import pools as P

POOL_BYTES = 4 << 20
PIECE = (500, 70_000)


def generate(seed: int, n_bytes: int = 10**9) -> bytes:
    rng = np.random.default_rng(seed)
    pools = [np.frombuffer(P.synthetic_text(POOL_BYTES, seed=501), np.uint8)]
    pools += [np.frombuffer(P.real_file(n), np.uint8)
              for n in ("licenses.txt", "pydoc.txt", "source.txt")]
    sizes = np.array([len(p) for p in pools], np.int64)
    n = n_bytes // ((PIECE[0] + PIECE[1]) // 2) + 64
    while True:  # enough pieces to cover n_bytes
        lens = rng.integers(*PIECE, size=n)
        which = rng.integers(0, len(pools), size=n)
        offs = (rng.random(n) * (sizes[which] - lens)).astype(np.int64)
        ends = np.cumsum(lens)
        if ends[-1] >= n_bytes:
            break
        n *= 2
    out = np.empty(n_bytes, np.uint8)
    pos = 0
    for ln, w, off in zip(lens.tolist(), which.tolist(), offs.tolist()):
        ln = min(ln, n_bytes - pos)
        out[pos:pos + ln] = pools[w][off:off + ln]
        pos += ln
        if pos == n_bytes:
            break
    return out.tobytes()
