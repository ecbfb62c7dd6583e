"""The port's TSQX serving profile (``turbosqueeze_tpu_torch/tsqx.py``)
against the JAX package's ``turbosqueeze_tpu/tsqx.py`` on the CPU:
``pack`` byte for byte at nblk 1, 2, 4 and 8, the view's fields, the
decoded words against the JAX decode (the Pallas gang kernel interpreted,
one case), the decode through ``tsqx.decompress`` and the API, and the
header checks the JAX view does not make. Tolerance: equal bytes over each
block's defined bytes.
"""

import struct

import jax
import numpy as np
import pytest
import torch

from test_torch_host_copies import jax_core, port_core
from turbosqueeze_tpu import tsqx as RX
from turbosqueeze_tpu.parallel import mesh as RM
from turbosqueeze_tpu_torch import tsqx as PX
from turbosqueeze_tpu_torch.format import FormatError
from turbosqueeze_tpu_torch.kernels.decode_bulk import rows_for_bytes
from turbosqueeze_tpu_torch.runtime import api
from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                 synthetic_text)

NBLKS = (1, 2, 4, 8)
# two blocks: text, a zero run across the 4 MiB boundary, binary
DATA = (synthetic_text(200_000, seed=71) + bytes(4 << 20)
        + synthetic_binary(90_000, seed=72))
_FIELDS = ("nblk", "slot_recs", "n_blocks", "lit_rows", "rec_rows",
           "total_size", "n_pad", "n_groups", "sizes")
_PLANES = ("gmeta", "lit_words", "gang_words")


@pytest.fixture(scope="module")
def streams():
    native = port_core()
    jax_core()  # the JAX package's pack resolves with its own binding
    return {"mixed": native.compress(DATA, True, level=1),
            "empty": native.compress(b"", True)}


@pytest.fixture(scope="module")
def packed(streams):
    return {nblk: PX.pack(streams["mixed"], nblk=nblk) for nblk in NBLKS}


@pytest.mark.parametrize("nblk", NBLKS)
def test_pack_is_byte_identical(streams, packed, nblk):
    assert packed[nblk] == RX.pack(streams["mixed"], nblk=nblk)
    assert PX.pack(streams["empty"], nblk=nblk) == RX.pack(
        streams["empty"], nblk=nblk)
    assert PX.is_tsqx(packed[nblk]) and not PX.is_tsqx(streams["mixed"])


@pytest.mark.parametrize("nblk", NBLKS)
def test_view_fields_equal_the_reference(packed, nblk):
    pv, rv = PX.TsqxView(packed[nblk]), RX.TsqxView(packed[nblk])
    for name in _FIELDS:
        assert getattr(pv, name) == getattr(rv, name), name
    for name in _PLANES:
        p, r = getattr(pv, name), getattr(rv, name)
        assert p.dtype == r.dtype and np.array_equal(p, r), name
    assert pv.sizes == [4 << 20, len(DATA) - (4 << 20)]
    assert pv.n_pad == -(-2 // nblk) * nblk


def test_row_bucketing_equals_the_reference():
    for n in (0, 1, 511, 512, 513, 3 * 512, 3 * 512 + 1, 4096, 70_001,
              (4 << 20) + 999):
        want = RX._bucket(max(8, -(-max(n, 1) // RX.ROW_BYTES) + 2), 8)
        assert rows_for_bytes(n) == want, n


def test_decode_to_words_equals_the_jax_decode():
    data = synthetic_text(300_000, seed=73)
    packed = PX.pack(port_core().compress(data, True), nblk=2)
    view = PX.TsqxView(packed)
    rw, rs = RX.decode_to_words(RX.TsqxView(packed),
                                mesh=RM.block_mesh(jax.devices()[:1]))
    pw, ps = PX.decode_to_words(view, device="cpu")
    assert ps == list(rs) == [len(data), 0]
    [shard] = pw.shards
    assert pw.shape == np.shape(rw) and shard.index == slice(0, 2)
    pw = shard.data
    assert pw.dtype == torch.int32 and tuple(pw.shape) == np.shape(rw)
    rw = np.asarray(rw)
    for b, size in enumerate(ps):
        got = pw[b].numpy().reshape(-1).view("u1")[:size].tobytes()
        assert got == rw[b].reshape(-1).view("u1")[:size].tobytes()
    assert got == b"" and pw[0].numpy().reshape(-1).view("u1")[
        :len(data)].tobytes() == data


@pytest.mark.parametrize("nblk", NBLKS)
def test_decompress_on_the_cpu(packed, nblk, monkeypatch):
    monkeypatch.setattr(PX, "BATCH_GROUPS", 1)  # two batches at nblk 1
    assert PX.decompress(packed[nblk], device="cpu") == DATA
    if nblk == 2:
        assert api.decompress(packed[nblk], device="cpu") == DATA
        assert PX.decompress(RX.pack(b"TSQ1" + bytes(12)),
                             device="cpu") == b""


def test_api_refuses_a_dictionary_or_a_host_backend(packed):
    with pytest.raises(FormatError, match="embed their context"):
        api.decompress(packed[1], device="cpu", dictionary=b"dict")
    for backend in ("native", "oracle"):
        with pytest.raises(ValueError, match="on the card only"):
            api.decompress(packed[1], backend=backend)
    with pytest.raises(ValueError):
        PX.pack(b"TSQ1" + bytes(12), nblk=9)


def test_decode_without_a_gpu_raises(packed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (lambda: PX.decompress(packed[1]),
                 lambda: api.decompress(packed[1]),
                 lambda: PX.decode_to_words(PX.TsqxView(packed[1]))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _u32_at(buf: bytes, off: int, value: int) -> bytes:
    return buf[:off] + struct.pack("<I", value) + buf[off + 4:]


def _gmeta_at(buf: bytes, word: int) -> int:
    """Byte offset of group 0's gmeta word ``word``."""
    return 48 + 4 * struct.unpack_from("<I", buf, 16)[0] + 4 * word


def _rounds(buf: bytes) -> int:
    return struct.unpack_from("<I", buf, _gmeta_at(buf, 30))[0]


_MALFORMED = {
    "header cut": lambda b: b[:47],
    "half": lambda b: b[:len(b) // 2],
    "last byte cut": lambda b: b[:-1],
    "magic": lambda b: b"TSQY" + b[4:],
    "version 2": lambda b: _u32_at(b, 4, 2),
    "nblk 0": lambda b: _u32_at(b, 8, 0),
    "nblk 9": lambda b: _u32_at(b, 8, 9),
    "slot_recs 12": lambda b: _u32_at(b, 12, 12),
    "lit_rows 12": lambda b: _u32_at(b, 20, 12),
    "rec_rows 0": lambda b: _u32_at(b, 24, 0),
    "n_blocks past the sections": lambda b: _u32_at(b, 16, 1 << 20),
    "gmeta[30] past the stream": lambda b: _u32_at(b, _gmeta_at(b, 30),
                                                  1 << 30),
    "segment bound past the rounds": lambda b: _u32_at(
        b, _gmeta_at(b, 17), _rounds(b) + 1),
    "block size past 4 MiB": lambda b: _u32_at(b, 48, (4 << 20) + 1),
    "sizes sum != total_size": lambda b: b[:32] + struct.pack(
        "<Q", len(DATA) + 1) + b[40:],
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_malformed_headers_raise_format_error(packed, case):
    bad = _MALFORMED[case](packed[2])
    assert bad != packed[2]
    with pytest.raises(FormatError):
        PX.TsqxView(bad)
    with pytest.raises(FormatError):
        PX.decompress(bad, device="cpu")
