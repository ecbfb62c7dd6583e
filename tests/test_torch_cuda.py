"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, the input and the native core (tolerance zero over each block's
first ``size`` bytes). Every test here needs an NVIDIA GPU and skips
without one. On a machine with the card, from the repository root (JAX is
not needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
from turbosqueeze_tpu_torch.parallel import pipeline

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
_MIXED = ((lambda: synthetic_text(90_000, seed=41), 0),
          (lambda: bytes(40_000), 1),
          (lambda: synthetic_binary(60_000, seed=43), 2),
          (lambda: np.random.default_rng(7).bytes(40_000), 1))


@pytest.fixture(scope="module")
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from turbosqueeze_tpu.runtime import native

    # build/ may hold a core built with -march=native for another CPU
    subprocess.run(["make", "-C", str(REPO / "csrc"), "-B"], check=True,
                   capture_output=True)
    native._SEARCHED = False
    assert native.available()
    return native


def _words_bytes(words, b, lo, n):
    return PT.words_to_bytes(words[b], lo + n)[lo:]


@pytest.mark.parametrize("nblk, slot_recs", [(1, 8), (2, 16), (3, 32)])
def test_gang_kernel_matches_plain(native, nblk, slot_recs):
    datas = [make() for make, _ in _MIXED]
    pe = [(native.compress(d, True, level=lv)[19:], True)
          for d, (_, lv) in zip(datas, _MIXED)]
    lw, gw, gm, sizes = PG.prep_gang(pe, nblk, slot_recs)
    before = PG.launches
    got = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                               nblk=nblk, slot_recs=slot_recs)
    torch.cuda.synchronize()
    assert PG.launches == before + 1
    ref = PG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               nblk=nblk, slot_recs=slot_recs)
    assert got.device.type == "cuda" and got.shape == ref.shape
    for k, d in enumerate(datas):
        assert _words_bytes(got, k, 0, sizes[k]) == d, f"block {k}"
        assert _words_bytes(ref, k, 0, sizes[k]) == d, f"plain block {k}"


@pytest.mark.parametrize("ext", [True, False])
def test_stream_kernel_matches_plain(native, ext):
    datas = [make()[:30_000] for make, _ in _MIXED]
    pw = np.stack([PT.pack_payload_words(
        native.compress(d, ext, level=lv)[19:], 96)
        for d, (_, lv) in zip(datas, _MIXED)])
    # the last block declares a size far past its output plane: the
    # parse stops at the plane's end, and its own bytes stay right
    sizes = [len(d) for d in datas[:-1]] + [2**31 - 1]
    meta = PS.pack_meta([ext] * len(datas), sizes)
    before = PS.launches
    got = PS.decode_stream_batch(*planes_to_torch(pw, meta, device="cuda"),
                                 out_rows=64)
    torch.cuda.synchronize()
    assert PS.launches == before + 1
    ref = PS.decode_stream_batch(*planes_to_torch(pw, meta, device="cpu"),
                                 out_rows=64)
    for k, d in enumerate(datas):
        assert _words_bytes(got, k, 0, len(d)) == d, f"block {k}"
        assert _words_bytes(ref, k, 0, len(d)) == d, f"plain block {k}"


def test_pipeline_mixes_both_kernels(native, monkeypatch):
    """Windows of one block, the short tail block declined by the
    resolver: full blocks take the gang kernel, the tail the stream
    kernel, and the container decodes exactly."""
    data = synthetic_text(2 * (1 << 22) + 54_321, seed=19)
    stream = native.compress(data, True, level=1)
    real = native.bulk_prep

    def declines_short_blocks(payload, ext, dictionary=None):
        size = payload[0] | payload[1] << 8 | payload[2] << 16
        return None if size < (1 << 22) else real(payload, ext, dictionary)

    monkeypatch.setattr(native, "bulk_prep", declines_short_blocks)
    PG.launches = PS.launches = 0
    out = pipeline.decompress(stream, device="cuda", window_blocks=1)
    assert (PG.launches, PS.launches) == (2, 1)
    assert out == data


def test_wrapper_refuses_planes_on_two_devices(native):
    lit, gang = (torch.zeros((1, 8, 128), dtype=torch.int32, device="cuda")
                 for _ in range(2))
    gmeta = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="gmeta is on cpu"):
        PG.decode_gang_batch(lit, gang, gmeta, nblk=1)
    with pytest.raises(ValueError, match="meta is on cpu"):
        PS.decode_stream_batch(lit, torch.zeros((1, 8), dtype=torch.int32))
