"""The port's ``pipeline.decompress_to_file`` on the CPU (the kernels'
plain versions): every route of its set, with and without a preset
dictionary, writes the file ``native.decompress`` gives, on a container of
two blocks decoded a window a block, so that blocks land at their 4 MiB
offsets while the next window decodes; and one route's file equals the
JAX package's ``decompress_to_file``. Tolerance: equal bytes.
"""

import pytest
import torch

from test_torch_host_copies import jax_core, port_core
from turbosqueeze_tpu.parallel import pipeline as RP
from turbosqueeze_tpu_torch.format import FormatError
from turbosqueeze_tpu_torch.parallel import pipeline as PP
from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                 synthetic_text)

# two blocks: text, a zero run across the 4 MiB boundary, binary, text
DATA = (synthetic_text(150_000, seed=61) + bytes(4 << 20)
        + synthetic_binary(60_000, seed=62) + synthetic_text(50_000, seed=63))
DICT = synthetic_text(9_000, seed=64)


@pytest.fixture(scope="module")
def streams():
    native = port_core()
    return (native.compress(DATA, True, level=1),
            native.compress_dict(DATA, DICT, True))


@pytest.mark.parametrize("impl", PP._FILE_IMPLS)
def test_every_route_writes_the_native_file(streams, impl, tmp_path):
    native = port_core()
    stream, dstream = streams
    assert native.decompress(stream) == DATA
    out = tmp_path / "out"
    for s, d in ((stream, None), (dstream, DICT)):
        n = PP.decompress_to_file(s, out, device="cpu", impl=impl,
                                  window_blocks=1, dictionary=d)
        assert n == len(DATA)
        assert out.read_bytes() == DATA


def test_auto_is_gang_and_files_are_rewritten(streams, tmp_path, monkeypatch):
    out = tmp_path / "out"
    out.write_bytes(b"x" * (len(DATA) + 999))  # truncated to the new size
    seen, gang = [], PP._WINDOW_ROUTES["gang"]
    monkeypatch.setitem(PP._WINDOW_ROUTES, "gang", lambda *a: seen.append(
        len(a[1])) or gang(*a))
    assert PP.decompress_to_file(streams[0], out, device="cpu") == len(DATA)
    assert out.read_bytes() == DATA
    assert seen == [2]  # one window of WINDOW_BLOCKS


def test_equals_the_jax_package_file(streams, tmp_path):
    jax_core()
    stream = streams[0]
    RP.decompress_to_file(stream, tmp_path / "ref", impl="xla")
    PP.decompress_to_file(stream, tmp_path / "port", device="cpu",
                          impl="xla")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


def test_refuses_other_routes_bad_streams_and_no_gpu(streams, tmp_path,
                                                     monkeypatch):
    """Each refusal raises before the file is opened: a file already at
    ``out_path`` is left as it was."""
    out = tmp_path / "out"
    out.write_bytes(b"kept")
    for impl in ("pallas", "tokens", ""):
        with pytest.raises(ValueError, match="unknown impl"):
            PP.decompress_to_file(streams[0], out, device="cpu", impl=impl)
    with pytest.raises(FormatError):
        PP.decompress_to_file(streams[0][:-7], out, device="cpu")
    with pytest.raises(ValueError, match="dictionary"):
        PP.decompress_to_file(streams[1], out, device="cpu",
                              dictionary=bytes(PP.native.MAX_DICT + 1))
    with pytest.raises(RuntimeError):
        PP.decompress_to_file(streams[0], out, device="nonesuch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PP.decompress_to_file(streams[0], out)
    assert out.read_bytes() == b"kept"
