"""One rank of a multi-process run of the port's entry points, with checks.

    python -m turbosqueeze_tpu_torch.parallel._worker COORDINATOR WORLD RANK \
        DIR [--device D[,D...]] [--ops OP[,OP...]] [--reps N] [--window N]

``DIR`` holds ``input.bin`` (the bytes) and ``input.tsq`` (their level-1
container from ``native.compress``). Every rank joins the gloo process
group at ``COORDINATOR`` (``host:port``), then runs each op ``--reps`` times
(default 1) through the public entry points on ``--device`` (default:
every CUDA device; ``--window`` sets the decode ops' ``window_blocks``)
and checks what it gets:

  * ``decompress:IMPL``: ``pipeline.decompress`` gives the input on rank 0
    and ``b""`` on the others;
  * ``file:IMPL``: ``pipeline.decompress_to_file`` into ``DIR/out.IMPL``
    returns the input's size on every rank; rank 0 reads the file back;
  * ``compress:LEVEL``: ``pipeline.compress`` gives ``native.compress``'s
    bytes on every rank (``input.tsq`` at level 1);
  * ``tsqx:NBLK``: ``tsqx.decompress`` of ``tsqx.pack(input.tsq, NBLK)``
    gives the input on rank 0 and ``b""`` on the others;
  * ``mismatch``: ranks pass different ``window_blocks`` to ``decompress``
    and each must raise ``ValueError``;
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
    for op in a.ops.split(","):
        kind, _, arg = op.partition(":")
        out_path = a.dir / f"out.{arg}"
        packed = tsqx.pack(stream, nblk=int(arg)) if kind == "tsqx" else None
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
            elif kind == "mismatch":
                try:
                    pipeline.decompress(stream, device=a.device,
                                        window_blocks=1 + a.rank)
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
