"""The PyTorch port's package boundary: it never loads JAX, its
re-declared constants and host glue equal the JAX package's, and its
planes keep u32 bit patterns."""

import re
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
from turbosqueeze_tpu.kernels import encode_bulk as REB
from turbosqueeze_tpu.kernels import encode_emit as RE
from turbosqueeze_tpu.kernels import encode_flat as REF
from turbosqueeze_tpu.parallel import pipeline as RP
from turbosqueeze_tpu_torch.kernels import decode_bulk as PB
from turbosqueeze_tpu_torch.kernels import decode_gang as PG
from turbosqueeze_tpu_torch.kernels import decode_stream as PS
from turbosqueeze_tpu_torch.kernels import decode_tokens as PT
from turbosqueeze_tpu_torch.kernels import encode_bulk as PEB
from turbosqueeze_tpu_torch.kernels import encode_emit as PE
from turbosqueeze_tpu_torch.kernels import encode_flat as PEF
from turbosqueeze_tpu_torch.parallel import mesh as PM
from turbosqueeze_tpu_torch.parallel import pipeline as PP

REPO = Path(__file__).resolve().parents[1]

_NO_JAX = """
import sys

_BLOCKED = ("jax", "jaxlib", "turbosqueeze_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError(f"{name} is blocked")

for m in [m for m in sys.modules if m.split(".")[0] in _BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, _Block())
import turbosqueeze_tpu_torch as tsq
import turbosqueeze_tpu_torch.block
import turbosqueeze_tpu_torch.kernels._build
import turbosqueeze_tpu_torch.kernels.decode_bulk
import turbosqueeze_tpu_torch.kernels.decode_gang
import turbosqueeze_tpu_torch.kernels.decode_stream
import turbosqueeze_tpu_torch.kernels.decode_tokens
import turbosqueeze_tpu_torch.kernels.decode_xla
import turbosqueeze_tpu_torch.kernels.encode_bulk
import turbosqueeze_tpu_torch.kernels.encode_emit
import turbosqueeze_tpu_torch.kernels.encode_flat
import turbosqueeze_tpu_torch.kernels.encode_xla
import turbosqueeze_tpu_torch.parallel.pipeline as pipeline
import turbosqueeze_tpu_torch.parallel._worker
import turbosqueeze_tpu_torch.reference_codec
import turbosqueeze_tpu_torch.runtime.api
import turbosqueeze_tpu_torch.runtime.native
import turbosqueeze_tpu_torch.utils.corpus as corpus
import turbosqueeze_tpu_torch.cli as cli
import turbosqueeze_tpu_torch.runtime.jobs as jobs
import turbosqueeze_tpu_torch.tsqx as tsqx
import turbosqueeze_tpu_torch.utils.profiling as profiling
assert "torch" in sys.modules
data = corpus.synthetic_text(60_000, seed=3) + bytes(5_000)
d = corpus.synthetic_text(9_000, seed=4)
for backend in ("native", "oracle"):
    stream = tsq.compress(data, backend=backend)
    assert tsq.decompress(stream, backend=backend) == data
stream = tsq.compress(data, backend="cuda", device="cpu", level=1)
for emit_impl in ("bulk", "flat"):
    assert pipeline.compress(data, device="cpu", emit_impl=emit_impl,
                             dictionary=d) == tsq.compress(
        data, backend="native", dictionary=d)
    assert pipeline.compress(data, device="cpu",
                             emit_impl=emit_impl) == stream
for impl in ("gang", "bulk", "bulk2", "bulkn", "stream", "pallas", "xla"):
    assert pipeline.decompress(stream, device="cpu", impl=impl) == data
from turbosqueeze_tpu_torch.parallel.mesh import init_distributed
init_distributed(None)  # one process: nothing to join
assert pipeline.decompress(stream, device=["cpu", "cpu"]) == data
stream = tsq.compress(data, backend="native", dictionary=d)
assert tsq.decompress(stream, backend="cuda", device="cpu",
                      dictionary=d) == data
assert tsq.decompress(tsqx.pack(tsq.compress(data, backend="native"), nblk=2),
                      device="cpu") == data
import os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    out = os.path.join(tmp, "out")
    pipeline.decompress_to_file(stream, out, device="cpu", dictionary=d)
    assert open(out, "rb").read() == data
    src = os.path.join(tmp, "src")
    open(src, "wb").write(data)
    import contextlib, io
    with contextlib.redirect_stdout(io.StringIO()):  # the verbs' reports
        assert cli.main(["--device", "cpu", "c", src, out]) == 0
        assert cli.main(["--device", "cpu", "verify", src, out]) == 0
with jobs.JobEngine(device="cpu") as eng, profiling.device_trace(None):
    assert eng.decompress(eng.compress(data)) == data
import numpy as np
from turbosqueeze_tpu_torch.runtime import native
arr = np.frombuffer(corpus.incompressible(3000) + data, np.uint8)
assert np.array_equal(native.decompress_array(native.compress_array(arr)), arr)
assert len(corpus.standard_cases()) == 11
assert corpus.checksum(data) == corpus.checksum(bytes(data))
assert len(corpus.ratio_sweep_files(include_real=False)) == 5
sys.path.insert(0, "tests")
import chip_smoke
from gang_streams import mixed_case, scale_blocks
assert len(mixed_case(np.random.default_rng(1), 90_000)) == 90_000
assert len(scale_blocks(1, n_blocks=1, n_pure=0)) == 4 << 20
loaded = [m for m in sys.modules if m.split(".")[0] in _BLOCKED]
assert not loaded, loaded
print("ok")
"""


def test_import_never_loads_jax():
    """Neither JAX nor the JAX package is loaded by the port: importing
    every module, compressing and decoding on the CPU through the pipeline
    (every route, and over two shards), the native and oracle backends,
    TSQX, ``decompress_to_file``, the CLI and the job engine, the corpus
    helpers and the native array API; nor by ``chip_smoke.py`` and the
    inputs it builds (``tests/gang_streams.py``)."""
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


_IMPORT = re.compile(r"^\s*(from|import)\s+turbosqueeze_tpu(\.|\s|$)",
                     re.MULTILINE)


def test_no_source_imports_the_jax_package():
    files = sorted((REPO / "turbosqueeze_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("port, ref, names", [
    (PT, RT, ("LANES", "ROW_BYTES", "OUT_ROWS", "PAY_ROWS",
              "TOKENS_PER_CHUNK", "_TOKENS_CAP", "_SLOT_ROWS", "_DST_MASK",
              "_LEN_SHIFT", "_LEN_MASK")),
    (PB, RB, ("WIN_BYTES", "WIN_ROWS", "TAIL_ROWS", "TAIL_BYTES", "MAX_WIN",
              "METAN_WORDS")),
    (PG, RG, ("GANG_WORDS", "GMETA_WORDS")),
    (PS, RS, ("_WIN_ROWS",)),
    (PE, RE, ("IN_ROWS", "OUT_ROWS", "CAND_ROWS", "_DICT_ROWS")),
    (PEB, REB, ("IN_BYTES", "SIDE_ROWS", "REC_ROWS", "OUT_WIN",
                "OUT_ROWS_BULK", "U_IN", "U_SIDE", "_MAX_ENTRY_RECS")),
    (PEF, REF, ("DESC_ROWS",)),
    (PP, RP, ("GANG_SRECS", "_DICT_PAD")),
], ids=["decode_tokens", "decode_bulk", "decode_gang", "decode_stream",
        "encode_emit", "encode_bulk", "encode_flat", "pipeline"])
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
    for backend in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tsq.decompress(stream, backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsq.decompress(stream)  # the default runs on the card
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
