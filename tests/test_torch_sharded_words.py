"""The port's device-resident decodes over three shards on the CPU against
the JAX package's on a 3-device mesh: ``pipeline.decompress_to_words``
(``pallas``, ``stream``) and ``tsqx.decode_to_words`` (nblk 1, whose five
groups pad to six; nblk 2, whose three groups need no padding group).

The container holds five short text blocks, built by hand, so that the
JAX side (the Pallas kernels interpreted) costs seconds a call: each call
runs once a module. The port runs with ``device=["cpu"] * 3``. Checked:
the global shape, each shard's rows against the JAX array's
``addressable_shards``, each block's defined bytes against the input and
the JAX words, the padding rows all zero, and ``sizes``. Port-only cases:
one-block windows, the empty container (one zero row a shard) and the
shard geometry of a rank of several processes. Tolerance: equal bytes.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_host_copies import jax_core
from turbosqueeze_tpu import tsqx as RX
from turbosqueeze_tpu.parallel import mesh as RM
from turbosqueeze_tpu.parallel import pipeline as RP
from turbosqueeze_tpu_torch import reference_codec, tsqx
from turbosqueeze_tpu_torch.format import ContainerHeader, pack_block_header
from turbosqueeze_tpu_torch.kernels.decode_tokens import OUT_ROWS
from turbosqueeze_tpu_torch.parallel import mesh
from turbosqueeze_tpu_torch.parallel import pipeline as PP
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

THREE = ["cpu"] * 3
BLOCKS = [synthetic_text(30_000 + 7 * i, seed=80 + i) for i in range(5)]
DATA = b"".join(BLOCKS)
CASES = ("pallas", "stream", "tsqx:1", "tsqx:2")


def _container(blocks) -> bytes:
    parts = [ContainerHeader(len(blocks), sum(map(len, blocks))).pack()]
    for b in blocks:
        payload = reference_codec.encode_block(b, True)
        parts += [pack_block_header(len(payload), True), payload]
    return b"".join(parts)


STREAM = _container(BLOCKS)


def _port(case: str, stream: bytes = STREAM, **kw):
    """(BlockShards, sizes) of the port's call for ``case``."""
    kind, _, nblk = case.partition(":")
    if kind == "tsqx":
        return tsqx.decode_to_words(
            tsqx.TsqxView(tsqx.pack(stream, nblk=int(nblk))), device=THREE)
    return PP.decompress_to_words(stream, device=THREE, impl=kind, **kw)[:2]


@pytest.fixture(scope="module")
def jax_words():
    """Each case through the JAX package on three virtual CPU devices:
    {case: (jax.Array, sizes)}."""
    jax_core()  # the JAX pallas route tokenizes with its own binding
    ref_mesh = RM.block_mesh(jax.devices()[:3])
    out = {}
    for case in CASES:
        kind, _, nblk = case.partition(":")
        if kind == "tsqx":
            out[case] = RX.decode_to_words(
                RX.TsqxView(RX.pack(STREAM, nblk=int(nblk))), mesh=ref_mesh)
        else:
            out[case] = RP.decompress_to_words(STREAM, ref_mesh,
                                               impl=kind)[:2]
    return out


def _rows(words: mesh.BlockShards):
    """(global row, its bytes as a uint8 array) of every local shard."""
    for sh in words.shards:
        flat = sh.data.numpy().reshape(sh.data.shape[0], -1).view("u1")
        for i, row in enumerate(flat):
            yield sh.index.start + i, row


@pytest.mark.parametrize("case", CASES)
def test_shards_equal_the_jax_arrays(jax_words, case):
    words, sizes = _port(case)
    ref, ref_sizes = jax_words[case]
    assert words.shape == ref.shape == (6, OUT_ROWS, 128)
    assert list(sizes) == list(ref_sizes)
    want = [s.index[0] for s in sorted(ref.addressable_shards,
                                       key=lambda s: s.index[0].start)]
    assert [(sh.index.start, sh.index.stop) for sh in words.shards] == [
        (w.start, w.stop) for w in want] == [(0, 2), (2, 4), (4, 6)]
    assert all(sh.device == torch.device("cpu")
               and sh.data.dtype == torch.int32
               and tuple(sh.data.shape) == (2, OUT_ROWS, 128)
               for sh in words.shards)
    ref = np.asarray(ref).reshape(6, -1).view("u1")
    seen = []
    for b, row in _rows(words):
        seen.append(b)
        if b < len(BLOCKS):
            n = sizes[b]
            assert n == len(BLOCKS[b])
            assert row[:n].tobytes() == BLOCKS[b] == ref[b, :n].tobytes()
        else:
            assert not row.any(), f"padding row {b}"
    assert seen == list(range(6))


@pytest.mark.parametrize("impl", ["pallas", "stream"])
def test_one_block_windows(impl):
    """Each shard's windows of one block land in their rows: the words
    equal the default window's."""
    words, sizes = _port(impl, window_blocks=1)
    whole, _ = _port(impl)
    assert sizes == [len(b) for b in BLOCKS]
    for sh, ref in zip(words.shards, whole.shards):
        assert sh.index == ref.index and torch.equal(sh.data, ref.data)


@pytest.mark.parametrize("case", CASES)
def test_empty_container_gives_one_zero_row_a_shard(case):
    words, sizes = _port(case, _container([]))
    rows = 3 * (int(case[-1]) if case.startswith("tsqx") else 1)
    assert words.shape == (rows, OUT_ROWS, 128)
    assert list(sizes) == ([0] * rows if case.startswith("tsqx") else [])
    assert [sh.index for sh in words.shards] == [
        slice(s * rows // 3, (s + 1) * rows // 3) for s in range(3)]
    assert not any(sh.data.any() for sh in words.shards)


@pytest.mark.parametrize("n, n_local, world, rank, want", [
    (5, 3, 1, 0, (6, [(0, 2), (2, 4), (4, 6)])),
    (6, 3, 1, 0, (6, [(0, 2), (2, 4), (4, 6)])),
    (0, 2, 1, 0, (2, [(0, 1), (1, 2)])),
    (64, 1, 1, 0, (64, [(0, 64)])),
    (5, 1, 2, 1, (6, [(3, 6)])),
    (5, 2, 2, 1, (8, [(4, 6), (6, 8)])),
    (64, 2, 2, 0, (64, [(0, 16), (16, 32)])),
])
def test_padded_shards(monkeypatch, n, n_local, world, rank, want):
    """The reference's padded batch: B = pad_batch(n, S), at least S;
    process r holds shards [r * n_local, (r + 1) * n_local)."""
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    monkeypatch.setattr(mesh, "process_index", lambda: rank)
    B, rows = mesh.padded_shards(n, n_local)
    assert (B, [(r.start, r.stop) for r in rows]) == want
    assert B == max(RM.pad_batch(n, n_local * world), n_local * world)


def test_groups_slice_pads_and_clamps():
    """A group range pads to the shard count and is clamped to the
    container: groups 1.. of five at nblk 1 are four groups, padded to
    six; ``sizes`` starts at the range's first block."""
    view = tsqx.TsqxView(tsqx.pack(STREAM, nblk=1))
    words, sizes = tsqx.decode_to_words(view, device=THREE,
                                        groups=slice(1, 99))
    assert words.shape == (6, OUT_ROWS, 128)
    assert sizes == [len(b) for b in BLOCKS[1:]] + [0, 0]
    for b, row in _rows(words):
        n = sizes[b]
        assert row[:n].tobytes() == (BLOCKS[1 + b] if n else b"")
        assert not row[n:].any()
