"""The comparisons that decide ``correct``, against the plain reference
(``tsq_codec``) and the input the benchmark made. Nothing here imports
the program. Each returns its counts; ``correct`` holds where every count
is at most its limit, which is 0 for all of them: the comparisons are
exact."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import tsq_codec as R

BLOCK = R.BLOCK


def bad_blocks(out, data: bytes) -> int:
    """How many of ``data``'s 4 MiB blocks ``out`` does not reproduce
    exactly (every block, where the lengths differ or ``out`` is not
    bytes)."""
    n = -(-len(data) // BLOCK)
    if not isinstance(out, (bytes, bytearray)) or len(out) != len(data):
        return n
    if out == data:
        return 0
    a = np.frombuffer(out, np.uint8)
    b = np.frombuffer(data, np.uint8)
    return sum(not np.array_equal(a[k:k + BLOCK], b[k:k + BLOCK])
               for k in range(0, len(data), BLOCK))


def sample_blocks(n_blocks: int, rng, per_window: int) -> list:
    """One block drawn from each run of ``per_window`` blocks, and the
    last block, in order."""
    picks = {int(lo + rng.integers(min(per_window, n_blocks - lo)))
             for lo in range(0, n_blocks, per_window)}
    picks.add(n_blocks - 1)
    return sorted(picks)


def _job(args):
    """A parse: ``("parse", block, ext, level)``, the block's payload; or
    a decode: ``("decode", payload, ext, block)``, whether the payload
    holds exactly the block."""
    kind, x, ext, y = args
    if kind == "parse":
        return R.encode_block(x, ext, y)
    try:
        return R.decode_block(x, ext) == y
    except R.FormatError:
        return False


def run_jobs(jobs: list, workers: int) -> list:
    """The answers of ``jobs``, in order, from ``workers`` spawned
    processes."""
    workers = min(workers, len(jobs))
    if workers <= 1:
        return list(map(_job, jobs))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        return list(pool.map(_job, jobs))


def _layout(c, data: bytes, ext: bool):
    """The block table of container ``c`` where its header, block count,
    total and every ext flag are those of ``data`` compressed with
    ``ext``; else None."""
    n = -(-len(data) // BLOCK)
    try:
        if not isinstance(c, (bytes, bytearray)):
            raise R.FormatError("not bytes")
        nb, total, table = R.parse_container(bytes(c))
    except R.FormatError:
        return None
    if nb != n or total != len(data) or any(e != ext for _, _, e in table):
        return None
    return table


def container_faults(containers: list, data: bytes, ext: bool, level: int,
                     sample: list, workers: int) -> dict:
    """The faults of the containers a run's calls returned, counted
    against the input and the reference:

    - ``bad_layout``: containers whose header, block table or ext flags
      are wrong;
    - ``undecodable_blocks``: blocks of the first container that the
      reference decoder does not turn into the input's block, each one of
      them (every block, where its layout is wrong or there is none);
    - ``bad_blocks``: blocks of ``sample``, over every container, whose
      payload differs from the reference parse's (each sampled block of a
      container whose layout is wrong);
    - ``differing_calls``: containers that differ from the first, byte for
      byte."""
    n = -(-len(data) // BLOCK)
    blocks = [data[b * BLOCK:(b + 1) * BLOCK] for b in range(n)]
    tables = [_layout(c, data, ext) for c in containers]
    first = containers[0] if containers else None
    jobs = [("parse", blocks[b], ext, level) for b in sample]
    if tables and tables[0] is not None:
        jobs += [("decode", first[o:o + s], ext, blocks[b])
                 for b, (o, s, _) in enumerate(tables[0])]
    answers = run_jobs(jobs, workers)
    ref = dict(zip(sample, answers[:len(sample)]))
    decoded = answers[len(sample):]
    out = {"bad_layout": sum(t is None for t in tables),
           "undecodable_blocks": n - sum(decoded),
           "bad_blocks": 0, "differing_calls": 0}
    for c, t in zip(containers, tables):
        out["bad_blocks"] += len(sample) if t is None else sum(
            c[t[b][0]:t[b][0] + t[b][1]] != p for b, p in ref.items())
        out["differing_calls"] += c != first
    return out
