"""Every kept call's answer is the container of the configuration's bytes
at its level and ext: the layout of each; every block of the first,
decoded by the reference, against the input; a seeded sample of blocks
(one in each 16, and the last), of each, against the reference parse;
and each against the first, byte for byte (``reference/checks.py``)."""

import numpy as np

from gpubench.reference import checks

PER_WINDOW = 16


def check(kept: list, data: bytes, cfg: dict, seed: int,
          workers: int) -> dict:
    n = -(-len(data) // checks.BLOCK)
    sample = checks.sample_blocks(n, np.random.default_rng([seed, 3]),
                                  PER_WINDOW)
    return checks.container_faults([c for _, c in kept], data, cfg["ext"],
                                   cfg["level"], sample, workers)
