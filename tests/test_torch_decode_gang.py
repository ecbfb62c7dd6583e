"""The port's gang-stream decoder (turbosqueeze_tpu_torch/kernels/
decode_gang.py) against the JAX package's Pallas kernel, run interpreted on
the CPU: the same numpy planes from prep_gang go through both, and every
block's first ``size`` bytes must match exactly (tolerance zero)."""

import subprocess

import jax  # noqa: F401  (the JAX package is the reference)
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import decode_gang as RG
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch


@pytest.fixture(scope="module", autouse=True)
def _native():
    from turbosqueeze_tpu.runtime import native

    if not native.available():
        subprocess.run(["make", "-C", "csrc"], check=True)
        native._SEARCHED = False
    assert native.available()


def _payloads(datas, levels):
    from turbosqueeze_tpu.runtime import native

    return [(native.compress(d, True, level=lv)[19:], True)
            for d, lv in zip(datas, levels)]


def _both(datas, levels, nblk, slot_recs):
    pe = _payloads(datas, levels)
    ref_planes = RG.prep_gang(pe, nblk, slot_recs)
    planes = PG.prep_gang(pe, nblk, slot_recs)
    for a, b in zip(ref_planes, planes):  # the port's host glue agrees
        assert np.array_equal(np.asarray(a), np.asarray(b))
    lw, gw, gm, sizes = planes
    ref = np.asarray(RG.decode_gang_batch(lw, gw, gm, nblk=nblk,
                                          interpret=True,
                                          slot_recs=slot_recs))
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=nblk, slot_recs=slot_recs)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    got = got.numpy()
    for k, d in enumerate(datas):
        want = ref[k].reshape(-1).view("u1")[:sizes[k]].tobytes()
        assert want == d, f"reference block {k}"
        assert got[k].reshape(-1).view("u1")[:sizes[k]].tobytes() == want, \
            f"nblk={nblk} slot_recs={slot_recs}: block {k} differs"


_MIXED = ([synthetic_text(90_000, seed=41), bytes(40_000),
           synthetic_binary(60_000, seed=43),
           np.random.default_rng(7).bytes(40_000)], (0, 1, 2, 1))


@pytest.mark.parametrize("nblk, slot_recs", [(1, 8), (2, 16), (3, 32)])
def test_mixed_blocks_match_reference(nblk, slot_recs):
    """Text, a zeros block (FILL gangs), structured binary and random
    data at levels 0/1/2; 4 blocks pad to whole groups for nblk=3."""
    _both(*_MIXED, nblk, slot_recs)


def test_two_windows_tail_reach():
    """A 2 MiB + 200 KB block: two windows, the U plane's tail read from
    the first window, matches reaching back across the window edge."""
    base = synthetic_text(64 * 1024, seed=11)
    data = (base * ((3 << 20) // len(base) + 1))[: (1 << 21) + 200_000]
    _both([data], (1,), 1, 8)


@pytest.mark.parametrize("kwargs, msg", [
    ({"nblk": 3}, "B % nblk"),
    ({"nblk": 9, "lit": 9}, "nblk must be"),
    ({"nblk": 1, "unroll": 3}, "unroll"),
    ({"nblk": 1, "lit_rows": 12}, "multiples of 8"),
    ({"nblk": 1, "slot_recs": 12}, "slot_recs"),
])
def test_argument_errors_match_reference(kwargs, msg):
    kwargs = dict(kwargs)
    B = kwargs.pop("lit", 2)
    lit_rows = kwargs.pop("lit_rows", 8)
    G = max(B // kwargs["nblk"], 1)
    lw = np.zeros((B, lit_rows, 128), np.int32)
    gw = np.zeros((G, 8, 128), np.int32)
    gm = np.zeros((G, 32), np.int32)
    with pytest.raises(ValueError, match=msg):
        RG.decode_gang_batch(lw, gw, gm, interpret=True, **kwargs)
    with pytest.raises(ValueError, match=msg):
        PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                             **kwargs)


def test_prep_gang_declines_like_reference(monkeypatch):
    """A block the resolver declines sends the whole batch to the stream
    parser in both packages."""
    from turbosqueeze_tpu.runtime import native

    pe = _payloads(_MIXED[0][:2], (0, 1))
    monkeypatch.setattr(native, "bulk_prep", lambda payload, ext: None)
    assert RG.prep_gang(pe, 1) is None
    assert PG.prep_gang(pe, 1) is None
