"""One rank of a multi-process run of the port's entry points, with checks.

    python -m turbosqueeze_tpu_torch.parallel._worker COORDINATOR WORLD RANK \
        DIR [--device D[,D...]] [--ops OP[,OP...]] [--reps N] [--window N]

``DIR`` holds ``input.bin`` (the bytes) and ``input.tsq`` (their level-1
container from ``native.compress``), and for the words ops ``words.tsq``,
any container, and ``words.bin``, its bytes. Every rank joins the gloo
process group at ``COORDINATOR`` (``host:port``), then runs each op
``--reps`` times (default 1) through the public entry points on
``--device`` (default: every CUDA device; ``--window`` sets the decode
ops' ``window_blocks``) and checks what it gets:

  * ``decompress:IMPL``: ``pipeline.decompress`` gives the input on rank 0
    and ``b""`` on the others;
  * ``file:IMPL``: ``pipeline.decompress_to_file`` into ``DIR/out.IMPL``
    returns the input's size on every rank; rank 0 reads the file back;
  * ``compress:LEVEL``: ``pipeline.compress`` gives ``native.compress``'s
    bytes on every rank (``input.tsq`` at level 1);
  * ``tsqx:NBLK``: ``tsqx.decompress`` of ``tsqx.pack(input.tsq, NBLK)``
    gives the input on rank 0 and ``b""`` on the others;
  * ``words:IMPL``: ``pipeline.decompress_to_words`` of ``words.tsq``, and
    ``tsqx_words:NBLK``: ``tsqx.decode_to_words`` of ``tsqx.pack(words.tsq,
    NBLK)``: the global shape is the reference's padded batch over every
    device of every rank, this rank holds exactly its own shards' rows,
    each on its device, every real block in them equals its bytes in
    ``words.bin`` and every padding row is zero; the timed call
    ends when every shard's device has finished;
  * ``mismatch``: ranks pass different ``window_blocks`` to ``decompress``
    (``mismatch:words``: to ``decompress_to_words``) and each must raise
    ``ValueError``;
  * ``hop``: the host-0 hop alone (``pipeline._to_host0``) on 32 MiB a
    rank of host words.

Each run prints one JSON line: the op, the rank, its wall ms and host cores
(CPU seconds of the process over wall seconds), and for ``hop`` the MB/s
of the bytes that crossed to rank 0. A failed check raises, so the process
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from .. import tsqx
from ..format import scan_block_table
from ..runtime import native
from . import mesh, pipeline


def _timed(fn):
    cpu0, t0 = time.process_time(), time.perf_counter()
    r = fn()
    wall = time.perf_counter() - t0
    return r, wall * 1e3, (time.process_time() - cpu0) / wall


def _hop(rank: int, world: int) -> float:
    """MB/s of the blocks that reach rank 0 from the others, 32 MiB a rank
    in 4 MiB blocks of host words, through ``_to_host0``: the median of
    three runs after a warm one. Rank 0 checks every block it gets."""
    per = 8
    sizes = [4 << 20] * (per * world)
    words = [torch.from_numpy(np.random.default_rng(r).integers(
        -2**31, 2**31, (per, (4 << 20) // 512, 128), dtype=np.int32))
        for r in range(world)]
    shards = [pipeline._Shard(r * per, (r + 1) * per, r,
                              pipeline._Pending(words[r], sizes[:per])
                              if r == rank else None) for r in range(world)]
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        out = pipeline._to_host0([shards], sizes, sum(sizes))
        times.append(time.perf_counter() - t0)
    if rank == 0 and out != b"".join(w.numpy().tobytes() for w in words):
        raise RuntimeError("hop: rank 0 got other bytes")
    return (world - 1) * (per << 22) / statistics.median(times[1:]) / 1e6


def _synced(result):
    """A words op's result, once every CUDA shard of it has finished."""
    for sh in result[0].shards:
        if sh.device.type == "cuda":
            torch.cuda.synchronize(sh.device)
    return result


def _words_ok(result, blocks, per_item: int, n_items: int, devices,
              world: int, rank: int) -> bool:
    """Whether a words op's (BlockShards, sizes) holds the reference's
    geometry for ``n_items`` blocks (TSQX: groups of ``per_item`` blocks)
    over ``devices`` in each of ``world`` ranks, this rank's shards
    exactly, each on its device, every real block equal to ``blocks`` and
    every padding row zero."""
    words, sizes = result
    n_shards = len(devices) * world
    k = max(-(-n_items // n_shards), 1) * per_item
    first = rank * len(devices)
    if (words.shape[0] != k * n_shards
            or [sh.index for sh in words.shards]
            != [slice(s * k, (s + 1) * k)
                for s in range(first, first + len(devices))]
            or [sh.device for sh in words.shards] != devices
            or list(sizes[:len(blocks)]) != [len(b) for b in blocks]
            or any(sizes[len(blocks):])):
        return False
    for sh in words.shards:
        host = sh.data.cpu().numpy().reshape(sh.data.shape[0], -1).view("u1")
        for i, row in enumerate(host):
            b = sh.index.start + i
            if (row[:len(blocks[b])].tobytes() != blocks[b] if b < len(blocks)
                    else row.any()):
                return False
    return True


def _container_blocks(stream: bytes, raw: bytes) -> list:
    """Each block's bytes of ``raw``, the container's decoded bytes, at
    the sizes its blocks declare."""
    offs = np.cumsum([0] + pipeline._declared_sizes(
        stream, scan_block_table(stream)[1])).tolist()
    return [raw[a:b] for a, b in zip(offs, offs[1:])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("coordinator")
    p.add_argument("world", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("dir", type=Path)
    p.add_argument("--device", default=None,
                   type=lambda v: v.split(",") if "," in v else v)
    p.add_argument("--ops", default="decompress:gang,file:gang,compress:1,"
                                    "tsqx:4,mismatch,hop")
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--window", type=int, default=0,
                   help="window_blocks of the decode ops (default: the "
                        "entry points' own)")
    a = p.parse_args(argv)
    mesh.init_distributed(a.coordinator, a.world, a.rank)
    data = (a.dir / "input.bin").read_bytes()
    stream = (a.dir / "input.tsq").read_bytes()
    lead = a.rank == 0
    want = data if lead else b""
    words_stream = words_blocks = devices = None
    if any(op.startswith(("words", "tsqx_words", "mismatch:words"))
           for op in a.ops.split(",")):
        words_stream = (a.dir / "words.tsq").read_bytes()
        words_blocks = _container_blocks(
            words_stream, (a.dir / "words.bin").read_bytes())
        devices = mesh.block_devices(a.device)
    for op in a.ops.split(","):
        kind, _, arg = op.partition(":")
        out_path = a.dir / f"out.{arg}"
        packed = (tsqx.pack(stream, nblk=int(arg)) if kind == "tsqx" else
                  tsqx.pack(words_stream, nblk=int(arg))
                  if kind == "tsqx_words" else None)
        for rep in range(a.reps):
            rec = {"op": op, "rank": a.rank, "rep": rep}
            if kind == "decompress":
                out, ms, cores = _timed(lambda: pipeline.decompress(
                    stream, device=a.device, impl=arg,
                    window_blocks=a.window))
                ok = out == want
            elif kind == "file":
                out, ms, cores = _timed(lambda: pipeline.decompress_to_file(
                    stream, out_path, device=a.device, impl=arg,
                    window_blocks=a.window))
                ok = out == len(data) and (not lead
                                           or out_path.read_bytes() == data)
            elif kind == "compress":
                out, ms, cores = _timed(lambda: pipeline.compress(
                    data, level=int(arg), device=a.device))
                ok = out == (stream if arg == "1" else
                             native.compress(data, level=int(arg)))
            elif kind == "tsqx":
                out, ms, cores = _timed(lambda: tsqx.decompress(
                    packed, device=a.device))
                ok = out == want
            elif kind == "words":
                out, ms, cores = _timed(lambda: _synced(
                    pipeline.decompress_to_words(
                        words_stream, device=a.device, impl=arg,
                        window_blocks=a.window)))
                ok = _words_ok(out[:2], words_blocks, 1, len(words_blocks),
                               devices, a.world, a.rank)
            elif kind == "tsqx_words":
                view = tsqx.TsqxView(packed)
                out, ms, cores = _timed(lambda: _synced(
                    tsqx.decode_to_words(view, device=a.device)))
                ok = _words_ok(out, words_blocks, view.nblk, view.n_groups,
                               devices, a.world, a.rank)
            elif kind == "mismatch":
                call = (pipeline.decompress_to_words if arg == "words"
                        else pipeline.decompress)
                try:
                    call(words_stream if arg == "words" else stream,
                         device=a.device, window_blocks=1 + a.rank)
                    ok = False
                except ValueError:
                    ok = True
                ms = cores = 0.0
            elif kind == "hop":
                rec["MBps"], ms, cores = _timed(lambda: _hop(a.rank, a.world))
                ok = True
            else:
                raise ValueError(f"unknown op {op!r}")
            rec.update(ok=ok, wall_ms=round(ms, 1), host_cores=round(cores, 2))
            print(json.dumps(rec), flush=True)
            if not ok:
                raise RuntimeError(f"rank {a.rank}: {op} gave a wrong result")
        if lead and kind == "file":
            out_path.unlink()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
