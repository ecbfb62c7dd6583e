"""The port's entry points spread over several devices in one process, on
the CPU (the kernels' plain versions): ``device=["cpu", "cpu", "cpu"]`` is
three shards of each window. A three-block level-1 container decodes at
``window_blocks`` 2 and 3, which gives an empty shard and a short tail
window, to the input, to the one-device result and to the JAX package's
``decompress(impl="xla")``; ``decompress_to_file``, ``compress`` and TSQX
run the same way. Tolerance: equal bytes.
"""

import pytest
import torch

from test_torch_host_copies import jax_core, port_core
from turbosqueeze_tpu.parallel import pipeline as RP
from turbosqueeze_tpu_torch import tsqx
from turbosqueeze_tpu_torch.parallel import mesh
from turbosqueeze_tpu_torch.parallel import pipeline as PP
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

DATA = synthetic_text(2 * (4 << 20) + 300_000, seed=61)
THREE = ["cpu"] * 3


@pytest.fixture(scope="module")
def stream():
    return port_core().compress(DATA, True, level=1)


@pytest.fixture(scope="module")
def references(stream):
    """The one-device result of each impl and the JAX package's."""
    jax_core()
    return {"jax": RP.decompress(stream, impl="xla"),
            **{impl: PP.decompress(stream, device="cpu", impl=impl)
               for impl in ("gang", "xla")}}


@pytest.mark.parametrize("n, shards, want", [
    (3, 3, [(0, 1), (1, 2), (2, 3)]),
    (2, 3, [(0, 1), (1, 2), (2, 2)]),
    (1, 3, [(0, 1), (1, 1), (1, 1)]),
    (7, 3, [(0, 3), (3, 6), (6, 7)]),
    (0, 2, [(0, 0), (0, 0)]),
])
def test_shard_bounds(n, shards, want):
    assert mesh.shard_bounds(n, shards) == want


def test_block_devices_sequences(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.block_devices(THREE) == [cpu] * 3
    assert mesh.block_devices((cpu, "cpu")) == [cpu] * 2
    assert mesh.block_devices("cpu") == [cpu]
    for bad in (["cpu", "cuda:0"], [], ("cuda:0", cpu)):
        with pytest.raises(ValueError):
            mesh.block_devices(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for cuda in (["cuda:0", "cuda:0"], None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.block_devices(cuda)


def test_window_scales_with_the_shards():
    spread = PP._Spread(THREE, 200, 0, PP.WINDOW_BLOCKS)
    assert spread.n_shards == 3 and spread.window == 3 * PP.WINDOW_BLOCKS
    assert list(spread.shards(96, 100)) == [
        (96, 98, 0, torch.device("cpu"), 0),
        (98, 100, 0, torch.device("cpu"), 1)]
    assert PP._Spread("cpu", 200, 5, PP.WINDOW_BLOCKS).window == 5


@pytest.mark.parametrize("impl", ["gang", "xla"])
@pytest.mark.parametrize("window_blocks", [2, 3])
def test_decompress_over_three_shards(stream, references, impl,
                                      window_blocks, monkeypatch):
    """Every shard of window k + 1 is launched before window k drains, and
    progress runs 1..n in block order."""
    events, route = [], PP._WINDOW_ROUTES[impl]
    monkeypatch.setitem(PP._WINDOW_ROUTES, impl, lambda s, win, *a: (
        events.append(("launch", len(win))) or route(s, win, *a)))
    views = PP._Pending.views
    monkeypatch.setattr(PP._Pending, "views", lambda self: (
        events.append(("drain", len(self.sizes))) or views(self)))
    seen = []
    out = PP.decompress(stream, device=THREE, impl=impl,
                        window_blocks=window_blocks,
                        progress=lambda *a: seen.append(a))
    assert out == DATA == references[impl] == references["jax"]
    assert seen == [(1, 3), (2, 3), (3, 3)]
    if window_blocks == 2:  # shards of 1, 1, 0 blocks, then 1, 0, 0
        assert events == [("launch", 1), ("launch", 1), ("launch", 1),
                          ("drain", 1), ("drain", 1), ("drain", 1)]
    else:
        assert events == [("launch", 1)] * 3 + [("drain", 1)] * 3


def test_decompress_to_file_over_three_shards(stream, tmp_path):
    out = tmp_path / "out"
    out.write_bytes(b"x" * (len(DATA) + 999))  # truncated to the new size
    assert PP.decompress_to_file(stream, out, device=THREE, impl="gang",
                                 window_blocks=2) == len(DATA)
    assert out.read_bytes() == DATA


@pytest.mark.parametrize("level", [0, 1])
def test_compress_over_three_shards(stream, level):
    want = stream if level == 1 else port_core().compress(DATA, True, level=0)
    seen = []
    assert PP.compress(DATA, level=level, device=THREE, window_blocks=2,
                       emit_impl="scan",
                       progress=lambda *a: seen.append(a)) == want
    assert seen == [(1, 3), (2, 3), (3, 3)]


@pytest.mark.parametrize("nblk", [1, 4])
def test_tsqx_over_three_shards(stream, nblk):
    """nblk 1: three groups, a shard each; nblk 4: one group, two empty
    shards."""
    assert tsqx.decompress(tsqx.pack(stream, nblk=nblk), device=THREE) == DATA


def test_one_device_entry_points_refuse_several(stream):
    """The device-resident decodes, once limited to one device, give one
    shard a device: three devices, three shards of the padded rows, each
    block equal to the input (the JAX package's geometry:
    ``tests/test_torch_sharded_words.py``); a device list that mixes the
    CPU and CUDA still raises."""
    words, sizes, _ = PP.decompress_to_words(stream, device=THREE)
    assert words.shape[0] == 3 and len(words.shards) == 3
    assert [sh.index for sh in words.shards] == [
        slice(0, 1), slice(1, 2), slice(2, 3)]
    got = b"".join(sh.data.numpy().reshape(-1).view("u1")[:n].tobytes()
                   for sh, n in zip(words.shards, sizes))
    assert got == DATA
    view = tsqx.TsqxView(tsqx.pack(stream, nblk=4))
    words, sizes = tsqx.decode_to_words(view, device=["cpu", "cpu"])
    assert words.shape[0] == 8 and sizes == view.sizes + [0] * 5
    assert [sh.index for sh in words.shards] == [slice(0, 4), slice(4, 8)]
    assert not words.shards[1].data.any()
    with pytest.raises(ValueError, match="mix"):
        PP.decompress_to_words(stream, device=["cpu", "cuda:0"])


def test_cli_takes_a_device_list(tmp_path, monkeypatch):
    """``--device cpu,cpu`` reaches the pipeline as two shards."""
    import contextlib
    import io

    from turbosqueeze_tpu_torch.cli import main

    seen, block_devices = [], mesh.block_devices
    monkeypatch.setattr(mesh, "block_devices", lambda d=None: seen.append(
        block_devices(d)) or seen[-1])
    data = synthetic_text(70_000, seed=62)
    src, tsq, out = tmp_path / "in", tmp_path / "a.tsq", tmp_path / "out"
    src.write_bytes(data)
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--device", "cpu,cpu", "c", "--level", "1", str(src),
                     str(tsq)]) == 0
        assert main(["--device", "cpu,cpu", "d", str(tsq), str(out)]) == 0
    assert seen == [[torch.device("cpu")] * 2] * 2
    assert tsq.read_bytes() == port_core().compress(data, True, level=1)
    assert out.read_bytes() == data
