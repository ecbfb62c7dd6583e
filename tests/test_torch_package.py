"""The PyTorch port's package boundary: it never loads JAX, its
re-declared constants and host glue equal the JAX package's, and its
planes keep u32 bit patterns."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from turbosqueeze_tpu.kernels import decode_bulk as RB
from turbosqueeze_tpu.kernels import decode_gang as RG
from turbosqueeze_tpu.kernels import decode_stream as RS
from turbosqueeze_tpu.kernels import decode_tokens as RT
from turbosqueeze_tpu.parallel import pipeline as RP
from turbosqueeze_tpu_torch.kernels import decode_bulk as PB
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.parallel import mesh as PM
from turbosqueeze_tpu_torch.parallel import pipeline as PP

REPO = Path(__file__).resolve().parents[1]

_NO_JAX = """
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")

for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]
sys.meta_path.insert(0, _NoJax())
import turbosqueeze_tpu_torch
import turbosqueeze_tpu_torch.kernels._build
import turbosqueeze_tpu_torch.kernels.decode_gang
import turbosqueeze_tpu_torch.kernels.decode_stream
import turbosqueeze_tpu_torch.parallel.pipeline
import turbosqueeze_tpu_torch.runtime.api
assert "torch" in sys.modules
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
assert not loaded, loaded
print("ok")
"""


def test_import_never_loads_jax():
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("port, ref, names", [
    (PT, RT, ("LANES", "ROW_BYTES", "OUT_ROWS", "PAY_ROWS")),
    (PB, RB, ("WIN_BYTES", "WIN_ROWS", "TAIL_ROWS", "TAIL_BYTES", "MAX_WIN")),
    (PG, RG, ("GANG_WORDS", "GMETA_WORDS")),
    (PS, RS, ("_WIN_ROWS",)),
    (PP, RP, ("GANG_SRECS",)),
], ids=["decode_tokens", "decode_bulk", "decode_gang", "decode_stream",
        "pipeline"])
def test_redeclared_constants(port, ref, names):
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n


def test_host_glue_matches_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 511, 512, 513, 4096, 70_001):
        assert PB.rows_for_bytes(n) == RB.rows_for_bytes(n)
    lit = rng.integers(0, 256, 5000, dtype=np.uint8)
    assert np.array_equal(PB.pack_lit_words(lit, 16),
                          RB.pack_lit_words(lit, 16))
    rec = rng.integers(0, 1 << 32, 3000, dtype=np.uint32)
    assert np.array_equal(PB.pack_rec_words(rec, 24),
                          RB.pack_rec_words(rec, 24))
    assert np.array_equal(PG.pack_gang_words(rec, 24),
                          RG.pack_gang_words(rec, 24))
    payload = rng.bytes(9000)
    assert np.array_equal(PT.pack_payload_words(payload, 24),
                          RT.pack_payload_words(payload, 24))
    assert np.array_equal(PS.pack_meta([True, False], [7, 9], 5),
                          RS.pack_meta([True, False], [7, 9], 5))
    assert np.array_equal(PS.pack_dict_words(payload),
                          RS.pack_dict_words(payload))
    words = RT.pack_payload_words(payload, 24)
    assert PT.words_to_bytes(words, 9000) == RT.words_to_bytes(words, 9000)
    assert PT.words_to_bytes(torch.from_numpy(words), 9000) == payload


def test_planes_to_torch_keeps_u32_bits():
    u = np.array([[0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF,
                   0x80000041, 0xDEADBEEF, 0x20000000] * 16] * 8,
                 dtype=np.uint32)
    i = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) - 500
    tu, ti = PT.planes_to_torch(u, i, device="cpu")
    assert tu.dtype == ti.dtype == torch.int32
    assert tuple(tu.shape) == (8, 128) and tu.is_contiguous()
    assert np.array_equal(tu.numpy().view(np.uint32), u)
    assert np.array_equal(ti.numpy(), i)
    with pytest.raises(TypeError):
        PT.planes_to_torch(u.astype(np.int64), device="cpu")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_cuda_backend_without_gpu_raises(no_gpu):
    import turbosqueeze_tpu_torch as tsq

    stream = tsq.compress(b"hello hello hello hello", backend="oracle")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsq.decompress(stream, backend="cuda")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            PP.decompress(stream, device=device)
    assert PM.block_devices("cpu") == [torch.device("cpu")]


def test_kernel_wrappers_refuse_bad_planes():
    lit = torch.zeros((2, 8, 128), dtype=torch.int32)
    gang = torch.zeros((2, 8, 128), dtype=torch.int32)
    gmeta = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        PG.decode_gang_batch(lit, gang.to(torch.int64), gmeta, nblk=1)
    with pytest.raises(ValueError, match="gmeta"):
        PG.decode_gang_batch(lit, gang, gmeta[:, :16], nblk=1)
    with pytest.raises(ValueError, match="out_rows"):
        PG.decode_gang_batch(lit, gang, gmeta, nblk=1, out_rows=4096)
    pay = torch.zeros((2, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="meta"):
        PS.decode_stream_batch(pay, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="pay_rows"):
        PS.decode_stream_batch(pay[:, :4], torch.zeros((2, 8),
                                                       dtype=torch.int32))
    for fn, args in ((PG.decode_gang_batch, (lit, gang, gmeta)),
                     (PS.decode_stream_batch,
                      (pay, torch.zeros((2, 8), dtype=torch.int32)))):
        before = (PG.launches, PS.launches)
        fn(*args, **({"nblk": 1} if fn is PG.decode_gang_batch else {}))
        assert (PG.launches, PS.launches) == before  # CPU: plain, no launch
