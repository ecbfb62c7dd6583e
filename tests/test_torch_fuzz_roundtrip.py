"""Mixed-class fuzz (``tests/test_fuzz_roundtrip.py``) held on the port on
the CPU, where the kernels run their plain versions. The reference's
offset-window-wrap mis-encode survived 88 structured tests and a 256 MiB
corpus before a 1 GiB run exposed it; these inputs switch content class
at random boundaries (incompressible runs, zeros, synthetic text and
binary, re-quotes of the previous 70,000 bytes), the shapes that hid it.

- Seeds 1-4 at 150-400 KB: the port's compress at levels 0-2, through
  every level-1 emitter, ext on and off, gives ``native.compress``'s
  container and decodes back on ``gang`` and ``stream``; a dictionary of
  the first 40,000 bytes at level 2 gives ``native.compress_dict``'s and
  decodes back through ``decompress(dictionary=)``.
- Seeds 11-12 at 60-140 KB: the decide-plus-assemble plain version on one
  block gives the native level-1 payload and the JAX two-pass emitter's
  (interpreted).
- ``tests/gang_streams.py``'s ``mixed_case`` is the reference's
  ``_mixed_case``, and ``scale_blocks`` (the card's 1 GiB input) is
  seeded, keeps its pure blocks and round-trips.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from turbosqueeze_tpu_torch.kernels import encode_bulk as PB
from turbosqueeze_tpu_torch.parallel import pipeline

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import class_blocks, mixed_case, scale_blocks  # noqa: E402
from test_torch_host_copies import jax_core, port_core  # noqa: E402

EMITTERS = {0: ("scan",), 1: ("scan", "bulk", "flat"), 2: ("scan",)}


@pytest.fixture(scope="module")
def native():
    return port_core()


def _case(seed, lo, hi):
    rng = np.random.default_rng(seed)
    return mixed_case(rng, int(rng.integers(lo, hi)))


@pytest.mark.parametrize("ext", [True, False])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_fuzz_all_levels_and_emitters(native, seed, ext):
    data = _case(seed, 150_000, 400_000)
    for level, emitters in EMITTERS.items():
        want = native.compress(data, ext, level=level)
        for emit in emitters:
            got = pipeline.compress(data, ext, level=level, device="cpu",
                                    emit_impl=emit)
            assert got == want, f"seed={seed} ext={ext} {level} {emit}"
        for impl in ("gang", "stream"):
            got = pipeline.decompress(want, device="cpu", impl=impl)
            assert got == data, f"seed={seed} ext={ext} {level} {impl}"


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_fuzz_dictionary(native, seed):
    data = _case(seed, 150_000, 400_000)
    d = data[:40_000]
    got = pipeline.compress(data, True, level=2, device="cpu", dictionary=d)
    assert got == native.compress_dict(data, d, True, level=2)
    assert pipeline.decompress(got, device="cpu", dictionary=d) == data


@pytest.mark.parametrize("seed", [11, 12])
def test_fuzz_bulk_emit_identity(native, seed):
    from turbosqueeze_tpu.kernels import encode_bulk as EB

    jax_core()
    data = _case(seed, 60_000, 140_000)
    cand = native.build_candidates(data)
    want = native.encode_block_candidates(data, cand, True, level=1)
    got, ovf = PB.emit_bulk_block(data, cand, ext=True, device="cpu")
    ref, ref_ovf = EB.emit_bulk_block(data, cand, ext=True, interpret=True)
    assert ovf == ref_ovf == 0
    assert got == want == ref, f"seed={seed}"


def test_mixed_case_is_the_reference():
    from test_fuzz_roundtrip import _mixed_case

    for seed, lo, hi in ((1, 150_000, 400_000), (4, 150_000, 400_000),
                         (11, 60_000, 140_000), (12, 60_000, 140_000)):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        size = int(r1.integers(lo, hi))
        assert size == int(r2.integers(lo, hi))
        assert mixed_case(r1, size) == _mixed_case(r2, size), f"seed={seed}"


def test_scale_blocks_recipe(native):
    """``scale_blocks`` on 16 blocks with two pure ones: the same bytes
    for the same seed, other bytes for another, each pure block at its
    place in its half, and a level-1 round trip through the native
    core."""
    blk = 4 << 20
    data = scale_blocks(5, n_blocks=16, n_pure=2)
    assert len(data) == 16 * blk
    assert data == scale_blocks(5, n_blocks=16, n_pure=2)
    assert data[:blk] != scale_blocks(6, n_blocks=16, n_pure=2)[:blk]
    pure = class_blocks(2)
    for k in range(2):
        found = [b for b in range(8 * k, 8 * k + 8)
                 if data[b * blk:(b + 1) * blk] == pure[k]]
        assert len(found) == 1, f"pure block {k}: {found}"
    assert native.decompress(native.compress(data, True, level=1)) == data
