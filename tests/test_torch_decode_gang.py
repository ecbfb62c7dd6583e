"""The port's gang-stream decoder (turbosqueeze_tpu_torch/kernels/
decode_gang.py) against the JAX package's Pallas kernel, run interpreted on
the CPU: the same numpy planes from prep_gang go through both, and every
block's first ``size`` bytes must match exactly (tolerance zero)."""

import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX package is the reference)
import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import decode_gang as RG
from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gang_streams import (CASES, DIFFERENCES,  # noqa: E402
                          differing_words, hand_planes)
from test_torch_host_copies import jax_core, port_core  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _native():
    jax_core()  # the JAX package's prep_gang runs on it
    port_core()


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
    ref = np.asarray(RG.decode_gang_batch(*ref_planes[:3], nblk=nblk,
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
    for mod in (native, port_core()):
        monkeypatch.setattr(mod, "bulk_prep",
                            lambda payload, ext, dictionary=None: None)
    assert RG.prep_gang(pe, 1) is None
    assert PG.prep_gang(pe, 1) is None


@pytest.mark.parametrize("slot_recs", [8, 16, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_hand_built_streams_match_reference(case, slot_recs):
    """Overlapping records, a gang reading its own row, odd segment bounds:
    the plain version gives the interpreted kernel's bytes exactly."""
    lw, gw, gm, n_win = hand_planes(case, slot_recs)
    ref = np.asarray(RG.decode_gang_batch(lw, gw, gm, nblk=1, unroll=1,
                                          interpret=True,
                                          slot_recs=slot_recs))
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=1, unroll=1, slot_recs=slot_recs).numpy()
    n = n_win * (1 << 21)
    want = ref.reshape(-1).view("u1")[:n]
    assert want.any()
    assert np.array_equal(got.reshape(-1).view("u1")[:n], want)
    assert not got.reshape(-1).view("u1")[n:].any()


@pytest.mark.parametrize("slot_recs", [8, 16, 32])
@pytest.mark.parametrize("case", list(DIFFERENCES))
def test_documented_differences_from_reference(case, slot_recs):
    """The port's deliberate differences from the interpreted kernel
    (ROADMAP §3, "Open"): a source outside the planes the kernels write
    reads zeros in the port and unwritten scratch in the reference; a
    round past the stream does nothing in the port and replays the
    stream's last 8-row chunk in the reference. The two differ on exactly
    the listed words, where the port's are zero and the reference's not."""
    lw, gw, gm, n_win = hand_planes(case, slot_recs)
    ref = np.asarray(RG.decode_gang_batch(lw, gw, gm, nblk=1, unroll=1,
                                          interpret=True,
                                          slot_recs=slot_recs))
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=1, unroll=1, slot_recs=slot_recs).numpy()
    n = n_win * (1 << 19)  # words of the decoded windows
    ref, got = ref.reshape(-1)[:n], got.reshape(-1)
    differ = np.zeros(n, bool)
    differ[differing_words(case, slot_recs)] = True
    assert got[:n][~differ].any()
    assert np.array_equal(got[:n][~differ], ref[~differ])
    assert not got[:n][differ].any() and ref[differ].all()
    assert not got[n:].any()
