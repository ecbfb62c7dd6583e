#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port's main paths on one GPU and checks them.

The main paths are device decode and device compress of ``.tsq``
containers (``turbosqueeze_tpu_torch.decompress(stream, backend="cuda")``
and ``compress(data, backend="cuda", level=L)``), and the host-tokenized
decode (``pipeline.decompress(stream, impl="pallas")``,
``decompress_to_words``), and the bulk record-stream decode
(``pipeline.decompress(stream, impl="bulk"|"bulk2"|"bulkn")``), and the
entry points around them: the TSQX serving profile (``tsqx.pack``,
``decompress`` and ``decode_to_words``), ``pipeline.decompress_to_file``,
the CLI (``python -m turbosqueeze_tpu_torch.cli``) and the job engine
(``runtime/jobs.py``), and every one of those spread over several shards
of a window and over two processes. They run
five hand-written CUDA kernels: the gang-stream decoder, the raw-payload
stream decoder, the token emitter (two matchers: the upstream's hash table
at level 0, phase-A candidates at level 1), the token-chunk decoder and the
bulk decoder (three stream ABIs, one wrapper each). Compress also runs
with the two other level-1 emitters, ``compress(emit_impl="bulk"|"flat")``:
the decide kernel and the assemble pass (the bulk kernel's assemble
entry), and the flat decide kernel with the sort layout in torch ops.
Phases:

  0. the card; rebuild the port's native host core and build the CUDA
     kernels, at once;
  1. the gang kernel against its plain PyTorch version, per
     (nblk, slot_recs), over mixed corpora and levels, and on garbage
     planes from three seeds;
  2. the stream kernel against its plain version, ext on and off, with a
     preset dictionary, and on random payloads of 8-32 KiB (declared sizes
     inside and past the output plane, ext on and off) word for word over
     the whole output plane;
  3. end to end: a 256 MiB input (64 full blocks) compressed at levels 0,
     1 and 2, decoded through the public API (the stream kernel, the
     default on the card), checked against the input and the native host
     decoder; the gang route timed end to end and layer by layer; and the
     gang kernel on one full level-1 block of each of the eight classes
     (its U and W gangs, its time, ms per gang), against its plain
     version;
  4. the stream route end to end on a 64 MiB container, and its kernel
     alone on the route's windows;
  5. the emit kernel against its plain version and the native core, both
     matchers, ext on and off, mixed blocks (a full random block, a short
     and an empty one), a dictionary base, and the full block of each of
     the eight classes, one a launch: timed per class, with its symbols,
     the positions its literal scan steps over and its bound (block 1,
     pydoc, is the kernel's timed row);
  6. compress end to end: the 256 MiB input of phase 3 at levels 0, 1 and
     2, each container byte-identical to the native core's and decoded
     back on the card; timed, with its layers timed apart; then its first
     64 MiB with a 33 KB dictionary at levels 1 and 2, byte-identical to
     ``native.compress_dict``;
  7. the token-chunk kernel against its plain version (mixed blocks, ext
     on and off, a dictionary prefix, garbage planes, one full block,
     timed) and the gang kernel with a dictionary in three windows; phase
     3's containers through ``impl="pallas"`` and ``impl="xla"`` and
     ``decompress_to_words``, against the native decoder and timed; and a
     64 MiB dictionary container through ``decompress(backend="cuda",
     dictionary=d)`` and every route, against ``native.decompress_dict``;
  8. the bulk kernel through its three wrappers against its plain version
     (mixed blocks: levels 0-2, ext on and off, a two-window block; a
     dictionary in three windows; garbage planes; hand-built entries whose
     records overlap; one launch per ABI on the same full level-1 blocks,
     whole groups at the main path's width, timed); the token, bulk and
     stream routes against their plain versions on the corrupt containers
     where they differ from the JAX routes; phase 3's containers through
     ``impl="bulk"``,
     ``"bulk2"`` and ``"bulkn"``, against the input and the native decoder,
     timed with the layers apart; and phase 7's dictionary container
     through the three routes;
  9. the two other level-1 emitters: the decide kernel, the assemble pass
     (the bulk kernel's assemble entry) and the flat decide kernel against
     their plain versions, word for word over their whole planes (phase
     5's mixed blocks, a dense 1-literal/1-match block and three blocks
     that end with their open slots below the literal high-water mark,
     ext on and off, a dictionary base, garbage planes, the assemble entry
     on hand-built entries whose records overlap, one full 4 MiB block
     each, timed),
     their payloads against the native core; then phase 3's 256 MiB
     compressed through ``compress(emit_impl="bulk")`` and ``"flat"`` at
     level 1, byte-identical to ``native.compress``, timed with the layers
     apart and the routes' peak device memory, and 64 MiB of it with a
     33 KB dictionary through both, byte-identical to
     ``native.compress_dict``;
 10. the serving profile and the entry points around the API: phase 3's
     level-1 container packed into TSQX at nblk 1, 4 and 8 (pack time),
     each decoded through ``decompress`` (a cold run and three warm ones,
     MB/s, host CPU seconds over wall) with its layers apart (the copy
     into pinned memory, upload, the gang kernel, download), then, while
     workers run the gang kernel's plain version on group 0 of each pack,
     the CLI in one subprocess a verb on 64 MiB (``c --level 1``, ``x``,
     ``d`` of both containers, ``info``, ``verify``); every block of each
     pack through ``tsqx.decode_to_words`` and group 0's words against the
     plain version's; the level-1 container through
     ``decompress_to_file`` with every route of its set (``gang`` timed);
     eight compress jobs at once through ``JobEngine`` (levels 0 and 1,
     byte-identical to ``native.compress``) and eight decompress jobs;
 11. one call's blocks over several shards: (a) every window split into
     two shards on ``cuda:0`` (``device=["cuda:0", "cuda:0"]``), phase 3's
     level-1 container through ``gang``, ``pallas`` and ``bulk2``,
     ``compress(level=1)`` and TSQX at nblk 4, each bit-exact and timed in
     turns beside one shard; then the device-resident decodes,
     ``decompress_to_words`` (``pallas``, ``stream``) and
     ``tsqx.decode_to_words`` (nblk 4), over two shards on ``cuda:0`` and
     one, in turns, timed until the card has finished (the words stay
     there), then every block checked from the card and every shard on
     ``cuda:0``; (b) every CUDA device, the same calls and the words
     routes, where the machine has more than one (else one line says so);
     (c) two processes on the one card
     (``turbosqueeze_tpu_torch.parallel._worker``, gloo on localhost):
     decode (``gang``, ``pallas``), ``decompress_to_file`` (``gang``),
     ``compress(level=1)``, TSQX at nblk 4 and the three words routes on
     the same input, checked by the workers (each rank holds exactly its
     own shards), each rank's wall and host cores, the host-0 hop's MB/s,
     and the gang decode again in windows of 32 blocks;
 12. scale: the JAX package's format, ratio and mixed-boundary contracts
     on 1 GiB (256 full blocks, ``tests/gang_streams.py::scale_blocks``
     made from ``--seed``, default 1: seeded splices of the real files,
     synthetic pools, zeros, random bytes, byte runs and re-quotes across
     64 KiB window edges and block boundaries, with the eight pure class
     blocks one in each 32-block window): compress at level 0, level 1
     through ``emit_impl`` ``scan``, ``bulk`` and ``flat``, and level 2,
     each container byte-identical to ``native.compress`` (else the first
     differing block, window and payload byte), sizes in the reference's
     order, each call's peak device memory; the level-1 container through
     every ``decompress`` route, ``decompress_to_file`` (``gang``), both
     ``decompress_to_words`` routes and TSQX at nblk 4 (``decompress``
     and ``decode_to_words``), levels 0 and 2 through ``auto``, each
     exactly the input (else the first differing byte, block and
     window); then every class of ``ratio_sweep_files()``, the real files
     included, through every compress call, ext on and off, with its four
     sizes. Each call's MB/s and host cores are printed, not held.

Every kernel is held against its plain version at zero tolerance over the
bytes the format defines (each block's first ``size`` bytes, or each
payload's first ``osz`` bytes). Any failure raises and the script exits
non-zero. The last lines are a JSON record of the kernels (each with its
launches on a main path, its time and its plain version's on one full
block, or for the bulk kernel one launch on a whole group of full blocks,
and the least time the card could take for those bytes) and the device
line. Run from the repository root:

    python3 chip_smoke.py

``python3 chip_smoke.py --emit-only [--ab ROOT ...]`` builds the kernels
and runs only phase 5's class blocks, the emit kernel on phase 6's two
windows at levels 0 and 1, the decide and flat decide kernels on the
level-1 windows and on each class's full block (their payloads against
the native core, with symbols, ms a symbol and bound).
``python3 chip_smoke.py --bulk-only [--ab ROOT ...]`` runs only the bulk
kernel on each class's full level-1 block through every stream ABI, the
assemble entry and the gang kernel on the same blocks (against the input
or the native core, with entries or gangs, us a unit and bound).
``python3 chip_smoke.py --decode-only [--clocks] [--ab ROOT ...]`` runs
only the token and stream kernels on each class's full block at levels 0
and 1 (against the input, with format pairs, ms, ns a pair and bound);
with ``--clocks`` it also builds the kernels with the pair mover's step
clocks (``TSQ_PAIRS_CLOCKS``) and prints each warp's cycles a batch. With
``--ab``, the kernels of each other checkout ``ROOT``
(``ROOT/turbosqueeze_tpu_torch/kernels/csrc``, for instance the parent
commit unpacked by ``git archive``) run there too: each held to this
tree's outputs and timed in turns with it.
``python3 chip_smoke.py --scale-only [--seed N]`` builds the kernels and
runs only phase 12, and checks that it launched every kernel.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
MiB = 1 << 20
KERNELS = {  # name -> (source in the port, the TPU kernel it replaces)
    "decode_gang": ("turbosqueeze_tpu_torch/kernels/csrc/decode_gang.cu",
                    "turbosqueeze_tpu/kernels/decode_gang.py:139"),
    "decode_stream": ("turbosqueeze_tpu_torch/kernels/csrc/decode_stream.cu",
                      "turbosqueeze_tpu/kernels/decode_stream.py:45"),
    "encode_emit_table": ("turbosqueeze_tpu_torch/kernels/csrc/encode_emit.cu",
                          "turbosqueeze_tpu/kernels/encode_emit.py:181"),
    "encode_emit_cand": ("turbosqueeze_tpu_torch/kernels/csrc/encode_emit.cu",
                         "turbosqueeze_tpu/kernels/encode_emit.py:181"),
    "decode_tokens": ("turbosqueeze_tpu_torch/kernels/csrc/decode_tokens.cu",
                      "turbosqueeze_tpu/kernels/decode_tokens.py:171"),
    "decode_bulk": ("turbosqueeze_tpu_torch/kernels/csrc/decode_bulk.cu",
                    "turbosqueeze_tpu/kernels/decode_bulk.py:233"),
    "decode_bulk2": ("turbosqueeze_tpu_torch/kernels/csrc/decode_bulk.cu",
                     "turbosqueeze_tpu/kernels/decode_bulk.py:316"),
    "decode_bulkn": ("turbosqueeze_tpu_torch/kernels/csrc/decode_bulk.cu",
                     "turbosqueeze_tpu/kernels/decode_bulk.py:422"),
    "encode_decide": ("turbosqueeze_tpu_torch/kernels/csrc/encode_bulk.cu",
                      "turbosqueeze_tpu/kernels/encode_bulk.py:85"),
    "encode_assemble": ("turbosqueeze_tpu_torch/kernels/csrc/decode_bulk.cu",
                        "turbosqueeze_tpu/kernels/encode_bulk.py:607"),
    "encode_flat_decide": (
        "turbosqueeze_tpu_torch/kernels/csrc/encode_flat.cu",
        "turbosqueeze_tpu/kernels/encode_flat.py:296"),
}
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM5 80 GB: 3.35 TB/s


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One result line, stamped with the seconds since the script began."""
    print(f"[{phase} t={time.perf_counter() - _T0:.0f}s] "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _bytes_of(words, b: int, lo: int, n: int) -> bytes:
    """Bytes [lo, lo + n) of block b's decoded words."""
    return words[b].cpu().numpy().reshape(-1).view("u1")[lo:lo + n].tobytes()


def _blocks_of(data: bytes, sizes) -> list:
    """Each 4 MiB block of ``data``, cut to its declared size."""
    return [data[b << 22:(b << 22) + sizes[b]]
            for b in range(-(-len(data) >> 22))]


def _words_exact(words, sizes, blocks, what: str, device=None) -> None:
    """A ``mesh.BlockShards`` of decoded words against ``blocks`` (block
    b's bytes): each shard on the card (on ``device`` when given), every
    real row's first ``sizes[b]`` bytes equal to block b, every padding
    row zero, the shards covering rows ``[0, shape[0])`` in order."""
    end = 0
    for sh in words.shards:
        check(sh.data.device == sh.device
              and (sh.device == torch.device(device) if device
                   else sh.device.type == "cuda"),
              f"{what}: a shard on {sh.data.device}")
        check(sh.index.start == end, f"{what}: shard rows {sh.index}")
        end = sh.index.stop
        host = sh.data.cpu().numpy().reshape(sh.data.shape[0], -1).view("u1")
        for i, row in enumerate(host):
            b = sh.index.start + i
            if b < len(blocks):
                check(row[:sizes[b]].tobytes() == blocks[b],
                      f"{what}: block {b} != input")
            else:
                check(not row.any(), f"{what}: padding row {b} not zero")
    check(end == words.shape[0], f"{what}: shards end at row {end}")


def _compare(errs, name: str, got: bytes, ref: bytes, want: bytes,
             what: str) -> None:
    """Kernel bytes ``got`` against the plain version's ``ref`` and the
    input ``want``; the largest byte difference goes into ``errs``."""
    check(len(got) == len(ref), f"{what}: length {len(got)} != {len(ref)}")
    if got:
        diff = np.abs(np.frombuffer(got, np.uint8).astype(np.int16)
                      - np.frombuffer(ref, np.uint8).astype(np.int16))
        errs[name] = max(errs[name], int(diff.max()))
    check(got == ref, f"{what}: kernel != plain")
    check(got == want, f"{what}: kernel != input")


def _cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the device (CUDA events)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _nbytes(*tensors) -> int:
    """Bytes of the tensors a kernel reads or writes (None: no tensor)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase0():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    name = torch.cuda.get_device_name(0)
    from turbosqueeze_tpu_torch.kernels import _build
    from turbosqueeze_tpu_torch.runtime import native

    def timed(fn):
        t0 = time.perf_counter()
        r = fn()
        return r, time.perf_counter() - t0

    # both builds at once; build/ may hold a native core built with
    # -march=native for another CPU, so it is always rebuilt
    with ThreadPoolExecutor(2) as pool:
        core = pool.submit(timed, lambda: native.build(force=True))
        report, cuda_s = timed(_build.build)
        _, native_s = core.result()
    _build.library()
    check(native.available(), "the native core does not load")
    say("phase0", device=json.dumps(name), torch=torch.__version__,
        cuda=torch.version.cuda, native_build_s=f"{native_s:.1f}",
        cuda_build_s=f"{cuda_s:.1f}")
    for ln in report.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}", flush=True)
    return name


def _mixed_blocks():
    """Text, zeros, structured binary, random, and a two-window block, with
    the level each is compressed at."""
    from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                     synthetic_text)

    base = synthetic_text(64 * 1024, seed=11)
    two_win = (base * ((3 * MiB) // len(base) + 1))[:2 * MiB + 200_000]
    datas = [synthetic_text(700_000, seed=41), bytes(300_000),
             synthetic_binary(500_000, seed=43),
             np.random.default_rng(7).bytes(400_000), two_win]
    return datas, (0, 1, 2, 0, 1)


def phase1(errs):
    """Gang kernel vs its plain version, on the card's and the host's
    copies of the same planes."""
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

    datas, levels = _mixed_blocks()
    containers = [native.compress(d, True, level=lv)
                  for d, lv in zip(datas, levels)]
    for d, c in zip(datas, containers):
        check(native.decompress(c) == d, "native decode disagrees")
    pe = [(c[19:], True) for c in containers]
    for nblk, srecs in ((1, 8), (2, 16), (3, 32), (4, 16), (8, 8)):
        lw, gw, gm, sizes = DG.prep_gang(pe, nblk, srecs)
        got = DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                                   nblk=nblk, slot_recs=srecs)
        torch.cuda.synchronize()
        ref = DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                                   nblk=nblk, slot_recs=srecs)
        for k, d in enumerate(datas):
            _compare(errs, "decode_gang", _bytes_of(got, k, 0, sizes[k]),
                     _bytes_of(ref, k, 0, sizes[k]), d,
                     f"gang nblk={nblk} srecs={srecs} block {k}")
        say("phase1", nblk=nblk, slot_recs=srecs, blocks=len(datas),
            bytes=sum(sizes), exact=True)

    # garbage planes (tests/gang_streams.py): records anywhere, window
    # counts and segment bounds past the stream and below the round
    # counter; the kernels stay inside their planes and give the plain
    # version's words
    from gang_streams import garbage_planes

    for seed in (5, 6, 7):
        lw, gw, gm, nblk, srecs, max_win = garbage_planes(seed)
        kw = dict(nblk=nblk, slot_recs=srecs, max_win=max_win,
                  out_rows=max_win * 4096)
        got = DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                                   **kw)
        ref = DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                                   **kw)
        diff = (got.cpu().view(torch.uint8).to(torch.int16)
                - ref.view(torch.uint8).to(torch.int16)).abs().max()
        errs["decode_gang"] = max(errs["decode_gang"], int(diff))
        check(torch.equal(got.cpu(), ref) and bool(ref.any()),
              f"gang garbage planes, seed {seed}: kernel != plain")
    say("phase1", garbage_planes=3, exact=True)


def phase2(errs):
    """Stream kernel vs its plain version, ext on/off and a dictionary."""
    from turbosqueeze_tpu_torch.format import FormatError, iter_container
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import synthetic_text
    from turbosqueeze_tpu_torch.kernels import decode_stream as DS
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    datas, levels = _mixed_blocks()
    datas = [d[:300_000] for d in datas]

    def run(payloads, exts, datas, what, dictionary=None):
        dlen = len(dictionary) if dictionary else 0
        out_rows = DK.OUT_ROWS + (128 if dictionary else 0)
        planes = [np.stack([DK.pack_payload_words(p) for p in payloads]),
                  DS.pack_meta(exts, list(map(len, datas)), dict_len=dlen)]
        if dictionary:
            planes.append(DS.pack_dict_words(dictionary))
        got = DS.decode_stream_batch(*planes_to_torch(*planes, device="cuda"),
                                     out_rows=out_rows)
        torch.cuda.synchronize()
        ref = DS.decode_stream_batch(*planes_to_torch(*planes, device="cpu"),
                                     out_rows=out_rows)
        for b, d in enumerate(datas):
            _compare(errs, "decode_stream", _bytes_of(got, b, dlen, len(d)),
                     _bytes_of(ref, b, dlen, len(d)), d, f"{what} block {b}")

    for ext in (True, False):
        payloads = [native.compress(d, ext, level=lv)[19:]
                    for d, lv in zip(datas, levels)]
        run(payloads, [ext] * len(datas), datas, f"stream ext={ext}")
        say("phase2", ext=ext, blocks=len(datas),
            bytes=sum(map(len, datas)), exact=True)

    dictionary = synthetic_text(33_000, seed=113)
    data = synthetic_text(150_000, seed=114)
    stream = native.compress_dict(data, dictionary, True)
    check(native.decompress_dict(stream, dictionary) == data,
          "native dictionary decode disagrees")
    (_, payload, ext), = list(iter_container(stream))
    run([payload], [ext], [data], "stream dictionary", dictionary)
    say("phase2", dictionary=len(dictionary), bytes=len(data), exact=True)

    # garbage payloads of 8-32 KiB, declared sizes inside and past the
    # output plane, ext on and off: word for word over the whole plane
    rng = np.random.default_rng(9)
    for k, pay_rows in enumerate((16, 32, 48, 64)):
        pw = rng.integers(-2**31, 2**31, (4, pay_rows, 128), dtype=np.int32)
        sizes = [int(rng.integers(1, 96 * 512)), 96 * 512 + 1, 2**31 - 1,
                 int(rng.integers(1, 4000))]
        meta = DS.pack_meta([True, False, k % 2 == 0, k < 2], sizes)
        got = DS.decode_stream_batch(*planes_to_torch(pw, meta, device="cuda"),
                                     out_rows=96)
        ref = DS.decode_stream_batch(*planes_to_torch(pw, meta, device="cpu"),
                                     out_rows=96)
        diff = (got.cpu().view(torch.uint8).to(torch.int16)
                - ref.view(torch.uint8).to(torch.int16)).abs().max()
        errs["decode_stream"] = max(errs["decode_stream"], int(diff))
        check(torch.equal(got.cpu(), ref) and bool(ref.any()),
              f"stream garbage payloads, {pay_rows} rows: kernel != plain")
    say("phase2", garbage_payloads=4, exact=True)

    # corrupt payloads: random bytes declaring a full block, a declared
    # size far past the output, and a stomped stream through the pipeline;
    # every read and write stays in bounds and the parse ends
    rng = np.random.default_rng(6)
    pw = rng.integers(-2**31, 2**31, (3, DK.PAY_ROWS, 128), dtype=np.int32)
    meta = DS.pack_meta([True, False, True], [4 * MiB, 4 * MiB, 2**31 - 1])
    DS.decode_stream_batch(*planes_to_torch(pw, meta, device="cuda"))
    torch.cuda.synchronize()
    stream = bytearray(native.compress(datas[0], True))
    stream[40:80] = bytes(40)
    try:
        out = pipeline.decompress(bytes(stream), impl="stream")
        check(len(out) == len(datas[0]), "corrupt stream: wrong length")
    except FormatError:
        pass  # the declared-size check may catch it instead
    torch.cuda.synchronize()
    say("phase2", corrupt_payloads="no fault")


def _e2e_input(n_blocks: int) -> bytes:
    """Full 4 MiB blocks cycling over the in-repo real files and the
    synthetic classes (``tests/gang_streams.py::class_blocks``)."""
    from gang_streams import class_blocks

    return b"".join(class_blocks(n_blocks))


def _main_path(counts, fn):
    """Runs ``fn`` as the main path: every kernel count is 0 just before,
    and the counts are read and added up just after."""
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels import decode_stream as DS
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF

    DG.launches = DS.launches = DK.launches = EF.launches = 0
    for launches in (EE.launches, DB.launches, EB.launches):
        launches.update(dict.fromkeys(launches, 0))
    r = fn()
    counts["encode_decide"] += EB.launches["decide"]
    counts["encode_assemble"] += EB.launches["assemble"]
    counts["encode_flat_decide"] += EF.launches
    counts["decode_gang"] += DG.launches
    counts["decode_stream"] += DS.launches
    counts["decode_tokens"] += DK.launches
    for m, n in EE.launches.items():
        counts[f"encode_emit_{m}"] += n
    for abi, n in DB.launches.items():
        counts[f"decode_{abi}"] += n
    return r


def _cuda_kernels(fn):
    """CUDA kernels that one call of ``fn`` launched, as torch.profiler
    traced them: {name: count}, or None if the trace holds no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(collections.Counter(names)) if names else None


def _plain_pool(n: int):
    """Worker processes for plain versions (each a Python walk on one
    core), started fresh: the card's process does not fork."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(min(8, n))


def _plain_bulk(args):
    """The bulk kernel's plain version on host planes, in a worker:
    (words, milliseconds)."""
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB

    torch.set_num_threads(1)
    abi, nblk, planes = args
    t0 = time.perf_counter()
    words = DB.decode_bulk(abi, nblk, *(torch.from_numpy(p) for p in planes))
    return words.numpy(), (time.perf_counter() - t0) * 1e3


def _plain_gang(args):
    """The gang kernel's plain version on one block's host planes, in a
    worker: (words, milliseconds)."""
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG

    torch.set_num_threads(1)
    planes, srecs = args
    t0 = time.perf_counter()
    words = DG.decode_gang_batch(*(torch.from_numpy(p) for p in planes),
                                 nblk=1, slot_recs=srecs)
    return words.numpy(), (time.perf_counter() - t0) * 1e3


def _gang_classes(errs, timing, data, stream, dev, planes, srecs):
    """The gang kernel on each class's full block (blocks 0-7 of the first
    window of the level-1 ``stream``, at the main path's plane shapes and
    width 1): its U and W gangs per window, its time, ms per gang and CUDA
    launches per call, held to the plain version; block 0 is the kernel's
    timed row."""
    from gang_streams import CLASSES
    from turbosqueeze_tpu_torch.format import scan_block_table
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG

    def gang(planes):
        return DG.decode_gang_batch(*planes, nblk=1, slot_recs=srecs)

    _, table = scan_block_table(stream)
    with ThreadPoolExecutor() as pool:  # each block's own literal bytes
        preps = DB.resolve_blocks([(stream[o:o + n], e) for o, n, e
                                   in table[:len(CLASSES)]], pool.map)
    # the plain versions, a Python walk each, run in workers meanwhile
    with _plain_pool(len(CLASSES)) as pool:
        plain = pool.map_async(_plain_gang, [
            ([t[b:b + 1].cpu().numpy() for t in dev], srecs)
            for b in range(len(CLASSES))])
        runs = []
        for b in range(len(CLASSES)):
            blk = [t[b:b + 1] for t in dev]
            ms = _cuda_ms(lambda: gang(blk), 5)
            got = []
            kernels = _cuda_kernels(lambda: got.append(gang(blk)))
            launched = ("not measured" if kernels is None else
                        sum(n for k, n in kernels.items() if "gang_" in k))
            runs.append((blk, ms, got[0], launched))
        plain = plain.get()
    for b, (name, (blk, ms, got, launched), (ref, plain_ms)) in enumerate(
            zip(CLASSES, runs, plain)):
        meta = planes[2][b].view(np.uint32)
        r, u, w = 0, [], []
        for win in range(int(meta[8])):
            u.append(max(0, int(meta[16 + 2 * win]) - r))
            r = max(r, int(meta[16 + 2 * win]))
            w.append(max(0, int(meta[17 + 2 * win]) - r))
            r = max(r, int(meta[17 + 2 * win]))
        size = planes[3][b]
        _compare(errs, "decode_gang", _bytes_of(got, 0, 0, size),
                 _bytes_of(torch.from_numpy(ref), 0, 0, size),
                 data[b * 4 * MiB:b * 4 * MiB + size],
                 f"gang full block, {name}")
        # the bytes the block's work needs, each once: its own literals,
        # its gang stream to its last segment bound, its meta and output
        lit_b = len(preps[b][0])
        rec_b = min(r, int(meta[30])) * 2 * srecs * 4
        moved = lit_b + rec_b + _nbytes(blk[2], got)
        if b == 0:
            timing["decode_gang"] = (ms, plain_ms, moved)
        say("phase3", gang_block=name, u_gangs="/".join(map(str, u)),
            w_gangs="/".join(map(str, w)), kernel_ms=f"{ms:.4f}",
            ms_per_gang=f"{ms / max(1, sum(u) + sum(w)):.6f}",
            cuda_launches_per_call=launched, plain_ms=f"{plain_ms:.1f}",
            lit_bytes=lit_b, rec_bytes=rec_b, out_bytes=_nbytes(got),
            bound_ms=f"{moved / HBM_BYTES_PER_MS:.6f}", exact=True)


def phase3(errs, counts, timing):
    import turbosqueeze_tpu_torch as tsq
    from turbosqueeze_tpu_torch.format import scan_block_table
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    data = _e2e_input(64)
    mb = len(data) / 1e6
    srecs = pipeline.GANG_SRECS[pipeline.GANG_NBLK]
    streams = {}
    for level in (0, 1, 2):
        stream = streams[level] = native.compress(data, True, level=level)
        before = dict(counts)
        out = _main_path(counts, lambda: tsq.decompress(stream,
                                                        backend="cuda"))
        check(out == data, f"level {level}: port decode != input")
        check(out == native.decompress(stream),
              f"level {level}: port decode != native decode")
        check(counts["decode_stream"] > before["decode_stream"]
              and counts["decode_gang"] == before["decode_gang"],
              f"level {level}: the default route is not the stream kernel")
        before = counts["decode_gang"]
        check(_main_path(counts, lambda: pipeline.decompress(
            stream, impl="gang")) == data, f"level {level}: gang != input")
        check(counts["decode_gang"] > before,
              f"level {level}: the gang kernel never launched")
        e2e = [_host_ms(lambda: _main_path(
            counts, lambda: pipeline.decompress(stream, impl="gang")), 1)
            for _ in range(3)]
        e2e_ms = statistics.median(e2e)
        native_ms = _host_ms(lambda: native.decompress(stream), 3)

        # the same windows, resolved on the host and decoded kernel-only
        _, table = scan_block_table(stream)
        wins = [table[lo:lo + pipeline.WINDOW_BLOCKS]
                for lo in range(0, len(table), pipeline.WINDOW_BLOCKS)]
        cpu0, t0 = time.process_time(), time.perf_counter()
        with ThreadPoolExecutor() as pool:
            planes = [DG.prep_gang([(stream[o:o + n], e) for o, n, e in w],
                                   pipeline.GANG_NBLK, srecs,
                                   map_fn=pool.map) for w in wins]
        resolve_s = time.perf_counter() - t0
        resolve_cpu_s = time.process_time() - cpu0
        t0 = time.perf_counter()
        dev = [planes_to_torch(*p[:3], device="cuda") for p in planes]
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3

        def kernels():
            return [DG.decode_gang_batch(lw, gw, gm, nblk=pipeline.GANG_NBLK,
                                         slot_recs=srecs)
                    for lw, gw, gm in dev]

        kernel_ms = _cuda_ms(kernels, 3)
        outs = kernels()
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        download_ms = _cuda_ms(lambda: [h.copy_(o, non_blocking=True)
                                        for h, o in zip(host, outs)], 3)
        del outs, host
        if level == 1:
            _gang_classes(errs, timing, data, stream, dev[0], planes[0],
                          srecs)
        del dev
        say("phase3", level=level, input_mb=f"{mb:.1f}",
            ratio=f"{len(stream) / len(data):.4f}", exact=True,
            decode_MBps=f"{mb / e2e_ms * 1e3:.1f}",
            kernel_only_MBps=f"{mb / kernel_ms * 1e3:.1f}",
            e2e_ms="/".join(f"{t:.1f}" for t in e2e),
            kernel_ms=f"{kernel_ms:.2f}", upload_ms=f"{upload_ms:.1f}",
            download_ms=f"{download_ms:.1f}", resolve_s=f"{resolve_s:.3f}",
            resolve_cpu_s=f"{resolve_cpu_s:.3f}",
            resolve_cores_at_decode_rate=f"{resolve_cpu_s / e2e_ms * 1e3:.2f}",
            native_decode_MBps=f"{mb / native_ms * 1e3:.1f}")
    return data, streams


def phase4(errs, counts, timing):
    from turbosqueeze_tpu_torch.format import scan_block_table
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.kernels import decode_stream as DS
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    data = _e2e_input(16)
    mb = len(data) / 1e6
    stream = native.compress(data, True, level=1)
    before = counts["decode_stream"]
    out = _main_path(counts, lambda: pipeline.decompress(stream,
                                                         impl="stream"))
    check(out == data, "stream route: port decode != input")
    check(out == native.decompress(stream),
          "stream route: port decode != native decode")
    check(counts["decode_stream"] > before,
          "stream route: the stream kernel never launched")
    e2e_ms = _host_ms(lambda: _main_path(
        counts, lambda: pipeline.decompress(stream, impl="stream")), 3)

    # the kernel alone on the route's windows, packed as the route packs
    # them
    _, table = scan_block_table(stream)
    dev = []
    for lo in range(0, len(table), pipeline.WINDOW_BLOCKS):
        win = table[lo:lo + pipeline.WINDOW_BLOCKS]
        pw = np.stack([DK.pack_payload_words(stream[o:o + n])
                       for o, n, _ in win])
        dev.append(planes_to_torch(pw, DS.pack_meta(
            [e for _, _, e in win], pipeline._declared_sizes(stream, win)),
            device="cuda"))
    kernel_ms = _cuda_ms(lambda: [DS.decode_stream_batch(*p) for p in dev], 3)
    del dev

    # one full block at the main path's shapes: kernel vs plain version
    off, psz, ext = table[1]  # a text block
    size = stream[off] | stream[off + 1] << 8 | stream[off + 2] << 16
    planes = (DK.pack_payload_words(stream[off:off + psz])[None],
              DS.pack_meta([ext], [size]))
    blk = planes_to_torch(*planes, device="cuda")
    blk_h = planes_to_torch(*planes, device="cpu")
    timing["decode_stream"] = (
        _cuda_ms(lambda: DS.decode_stream_batch(*blk), 3),
        _host_ms(lambda: DS.decode_stream_batch(*blk_h), 1),
        psz + 32 + size)  # the payload, the meta row, the block's bytes
    _compare(errs, "decode_stream",
             _bytes_of(DS.decode_stream_batch(*blk), 0, 0, size),
             _bytes_of(DS.decode_stream_batch(*blk_h), 0, 0, size),
             data[4 * MiB:4 * MiB + size], "stream full block")
    say("phase4", input_mb=f"{mb:.1f}", exact=True,
        decode_MBps=f"{mb / e2e_ms * 1e3:.1f}",
        kernel_only_MBps=f"{mb / kernel_ms * 1e3:.1f}",
        kernel_ms=f"{kernel_ms:.2f}")


def _emit_compare(errs, planes, ext, matcher, what):
    """The emit kernel on the card's copy of ``planes`` against its plain
    version on the host's: ``osz`` equal and each block's first
    ``osz[b, 0]`` payload bytes equal. Returns the kernel's payloads and
    the plain version's milliseconds."""
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE

    name = f"encode_emit_{matcher}"
    dev, host = ([None if p is None else p.to(d) for p in planes]
                 for d in ("cuda", "cpu"))
    got, gsz = EE.emit_batch(*dev, ext=ext, matcher=matcher)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, rsz = EE.emit_batch(*host, ext=ext, matcher=matcher)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(gsz.cpu(), rsz), f"{what}: osz {gsz[:, 0].tolist()} "
          f"!= plain {rsz[:, 0].tolist()}")
    out = []
    for b in range(rsz.shape[0]):
        n = int(rsz[b, 0])
        check(n > 0, f"{what} block {b}: refused")
        g, r = (EE.payload_from_words(w[b], n) for w in (got, ref))
        diff = np.abs(np.frombuffer(g, np.uint8).astype(np.int16)
                      - np.frombuffer(r, np.uint8).astype(np.int16))
        errs[name] = max(errs[name], int(diff.max()))
        check(g == r, f"{what} block {b}: kernel != plain")
        out.append(g)
    return out, plain_ms


def _emit_planes(blocks, dictionary=b"", cand=True):
    """Input, candidate (phase A on the card, held against the native
    core's hash chain) and meta planes of a batch, on the card."""
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_xla as EX

    iw = torch.from_numpy(np.stack([EE.pack_input_words(dictionary + b)
                                    for b in blocks])).cuda()
    cw = None
    if cand:
        n = len(dictionary) + max(map(len, blocks))
        cands = EX.find_candidates(iw.view(len(blocks), -1)
                                   .view(torch.uint8)[:, :n]).cpu().numpy()
        for b, blk in enumerate(blocks):
            m = len(dictionary) + len(blk)
            check(np.array_equal(cands[b, :m],
                                 native.build_candidates(dictionary + blk)),
                  f"phase A block {b}: != native.build_candidates")
        cw = torch.from_numpy(np.stack([EE.pack_cand_words(c[:len(dictionary)
                                                             + len(b)])
                                        for c, b in zip(cands, blocks)]))
    meta = torch.from_numpy(EE.pack_meta([len(b) for b in blocks],
                                         len(dictionary)))
    return [iw, cw, meta]


def phase5(errs, timing):
    """Emit kernel vs its plain version and the native core: both matchers,
    ext on and off, mixed blocks, a dictionary base, full blocks."""
    from turbosqueeze_tpu_torch.format import iter_container
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                     synthetic_text)
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_xla as EX

    def want(blk, ext, matcher, dictionary=b""):
        if dictionary:
            return native.encode_block_dict(
                blk, dictionary, native.build_candidates(dictionary + blk),
                ext)
        if matcher == "cand":
            return native.encode_block_candidates(
                blk, native.build_candidates(blk), ext)
        return next(iter_container(native.compress(blk, ext, level=0)))[1]

    # a full random block expands to near the payload bound
    blocks = [synthetic_text(700_000, seed=41),
              synthetic_binary(500_000, seed=43), bytes(300_000),
              np.random.default_rng(7).bytes(4 * MiB), b"abcab", b""]
    d = synthetic_text(33_000, seed=113)
    dict_blocks = [synthetic_text(150_000, seed=114), bytes(20_000)]
    for matcher in ("table", "cand"):
        planes = _emit_planes(blocks, cand=matcher == "cand")
        for ext in (True, False):
            got, _ = _emit_compare(errs, planes, ext, matcher,
                                   f"{matcher} ext={ext}")
            for b, blk in enumerate(blocks[:-1]):  # native skips empty
                check(got[b] == want(blk, ext, matcher),
                      f"{matcher} ext={ext} block {b}: kernel != native")
            check(len(got[-1]) == 5, "empty block: not header + two slots")
            say("phase5", matcher=matcher, ext=ext, blocks=len(blocks),
                bytes=sum(map(len, blocks)),
                random_payload=len(got[3]), exact=True)
    planes = _emit_planes(dict_blocks, dictionary=d)
    for ext in (True, False):
        got, _ = _emit_compare(errs, planes, ext, "cand",
                               f"dict ext={ext}")
        for b, blk in enumerate(dict_blocks):
            check(got[b] == want(blk, ext, "cand", d),
                  f"dict ext={ext} block {b}: kernel != native")
        say("phase5", matcher="cand", dictionary=len(d), ext=ext, exact=True)

    _emit_classes(errs, timing)
    # phase A on one full block (pydoc), B=1
    x = torch.from_numpy(np.frombuffer(_e2e_input(2)[4 * MiB:], np.uint8)
                         .copy())[None].cuda()
    phase_a_ms = _cuda_ms(lambda: EX.find_candidates(x), 5)
    say("phase5", phase_a_ms_per_block=f"{phase_a_ms:.4f}")


def _plain_emit(args):
    """The emit kernel's plain version on one block's host planes, in a
    worker process: (payload, osz row, milliseconds)."""
    import torch
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE

    torch.set_num_threads(1)
    planes, ext, matcher = args
    t0 = time.perf_counter()
    words, osz = EE.emit_batch(*(None if p is None else torch.from_numpy(p)
                                 for p in planes), ext=ext, matcher=matcher)
    ms = (time.perf_counter() - t0) * 1e3
    return EE.payload_from_words(words[0], int(osz[0, 0])), osz.numpy(), ms


def _emit_moved(payload: bytes, ext: bool, matcher: str, size: int,
                base: int = 0) -> dict:
    """What one block's parse needs, from its payload's symbols (the
    native tokenizer): literal bytes (the positions the literal scan
    steps over), matches, literal stretches, and the bytes the parse must
    move, each once: the meta and osz rows, the input, the payload, and
    for ``cand`` one candidate word per parse stop (each match and each
    literal stretch), for ``table`` the 256 KiB table zeroed and one
    2-byte entry read and written per probe (each literal byte and each
    match end)."""
    from turbosqueeze_tpu_torch.format import HASH_ENTRIES
    from turbosqueeze_tpu_torch.runtime import native

    _, _, ln, lit, _ = native.tokenize_block(payload, ext, base)
    lit = lit.astype(bool)
    st = {"symbols": len(lit), "lit_bytes": int(ln[lit].sum()),
          "matches": int((~lit).sum()),
          "stretches": int(lit[:1].sum() + (lit[1:] & ~lit[:-1]).sum())}
    moved = 32 + base + size + len(payload) + 32
    if matcher == "cand":
        moved += 4 * (st["matches"] + st["stretches"])
    else:
        moved += 2 * HASH_ENTRIES + 4 * (st["lit_bytes"] + st["matches"])
    st["bytes"] = moved
    return st


def _ab_libraries(roots) -> dict:
    """The kernel libraries of other checkouts (``ROOT/
    turbosqueeze_tpu_torch/kernels/csrc``), built with the port's flags
    into ``build/cuda/ab/<name>/``, all at once, and loaded: the other
    sides of an A/B run, by the checkout's directory name."""
    from turbosqueeze_tpu_torch.kernels import _build

    roots = list(roots)
    paths = [_build.LIB_PATH.parent / "ab" / r.name / _build.LIB_PATH.name
             for r in roots]
    with ThreadPoolExecutor(len(roots)) as pool:
        list(pool.map(lambda r, p: _build.build(
            r / "turbosqueeze_tpu_torch/kernels/csrc", p), roots, paths))
    return {r.name: _build.load(p) for r, p in zip(roots, paths)}


def _with(lib, fn):
    """``fn()`` with the port's wrappers launching ``lib``'s kernels."""
    from turbosqueeze_tpu_torch.kernels import _build

    saved = _build.library()
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = saved


def _ab_ms(fns: dict, reps=3) -> dict:
    """Each ``fns`` entry timed in turns, forward then backward (a, b, ...,
    b, a), each the median of ``reps``: {name: [two times]}."""
    t = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        t[k].append(_cuda_ms(fns[k], reps))
    return t


def _emit_classes(errs, timing, others=None):
    """The emit kernel on each class's full block (``class_blocks``), one
    block a launch (B = 1, the main path's plane shapes), both matchers:
    held to its plain version (worker processes) and to the native core,
    ext on and off; its time (ext on, median of 3), symbols, ms a symbol,
    the positions the literal scan steps over and the bound from what the
    parse needs (``_emit_moved``). Block 1 (pydoc) is the kernel's timed
    row. With ``others`` (other checkouts' kernel libraries by name) each
    class is also run on each (held to this kernel's payload, ext on) and
    timed, in turns with this one ("new")."""
    from gang_streams import CLASSES
    from turbosqueeze_tpu_torch.format import iter_container
    from turbosqueeze_tpu_torch.kernels import _build
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.runtime import native

    blocks = _e2e_input(len(CLASSES))
    blocks = [blocks[b * 4 * MiB:(b + 1) * 4 * MiB]
              for b in range(len(CLASSES))]
    matchers, exts = ("table", "cand"), (True, False)
    planes = {m: [None if p is None else p.cuda()
                  for p in _emit_planes(blocks, cand=m == "cand")]
              for m in matchers}
    keys = [(m, ext, b) for m in matchers for ext in exts
            for b in range(len(blocks))]
    # the plain versions, a Python walk each, run in workers meanwhile
    with _plain_pool(len(keys)) as pool:
        plain = pool.map_async(_plain_emit, [
            ([None if p is None else p[b:b + 1].cpu().numpy()
              for p in planes[m]], ext, m) for m, ext, b in keys])
        got = {(m, ext): EE.emit_batch(*planes[m], ext=ext, matcher=m)
               for m in matchers for ext in exts}
        ms, ab = {}, {}
        for m in matchers:
            for b in range(len(blocks)):
                blk = [None if p is None else p[b:b + 1] for p in planes[m]]
                ms[m, b] = _cuda_ms(lambda: EE.emit_batch(*blk, matcher=m),
                                    3)
                if not others:
                    continue
                libs = {**others, "new": _build.library()}
                runs = {k: (lambda lib=lib: _with(lib, lambda: EE.emit_batch(
                    *blk, matcher=m))) for k, lib in libs.items()}
                want = EE.payload_from_words(got[m, True][0][b],
                                             int(got[m, True][1][b, 0]))
                for k in others:
                    o, osz = runs[k]()
                    check(EE.payload_from_words(o[0], int(osz[0, 0]))
                          == want, f"A/B {k}: {m} {CLASSES[b]} != this "
                          "kernel's")
                ab[m, b] = {f"{k}_ms": "/".join(f"{x:.4f}" for x in v)
                            for k, v in _ab_ms(runs).items()}
        plain = dict(zip(keys, plain.get()))
    for m in matchers:
        for ext in exts:
            words, gsz = got[m, ext]
            gsz = gsz.cpu()
            for b, blk in enumerate(blocks):
                ref, rsz, _ = plain[m, ext, b]
                n = int(gsz[b, 0])
                check(n == int(rsz[0, 0]) and not gsz[b, 1:].any(),
                      f"{m} ext={ext} {CLASSES[b]}: osz {n} != plain "
                      f"{int(rsz[0, 0])}")
                g = EE.payload_from_words(words[b], n)
                diff = np.abs(np.frombuffer(g, np.uint8).astype(np.int16)
                              - np.frombuffer(ref, np.uint8).astype(np.int16))
                errs[f"encode_emit_{m}"] = max(errs[f"encode_emit_{m}"],
                                               int(diff.max()))
                check(g == ref, f"{m} ext={ext} {CLASSES[b]}: kernel != "
                      "plain")
                nat = (native.encode_block_candidates(
                    blk, native.build_candidates(blk), ext)
                       if m == "cand" else next(iter_container(
                           native.compress(blk, ext, level=0)))[1])
                check(g == nat, f"{m} ext={ext} {CLASSES[b]}: kernel != "
                      "native")
            say("phase5", matcher=m, ext=ext, class_blocks=len(blocks),
                exact=True)
        for b, name in enumerate(CLASSES):
            payload, _, plain_ms = plain[m, True, b]
            st = _emit_moved(payload, True, m, len(blocks[b]))
            if b == 1:
                timing[f"encode_emit_{m}"] = (ms[m, b], plain_ms,
                                              st["bytes"])
            say("phase5", matcher=m, emit_block=name,
                kernel_ms=f"{ms[m, b]:.4f}", symbols=st["symbols"],
                ms_per_symbol=f"{ms[m, b] / max(1, st['symbols']):.7f}",
                scan_positions=st["lit_bytes"], matches=st["matches"],
                stretches=st["stretches"], bytes=st["bytes"],
                bound_ms=f"{st['bytes'] / HBM_BYTES_PER_MS:.6f}",
                plain_ms=f"{plain_ms:.1f}", **ab.get((m, b), {}))


def _emit_windows(others=None):
    """The emit kernel on both 32-block windows of phase 6's input at
    levels 0 (``table``) and 1 (``cand``, phase A on the card), and the
    decide and flat decide kernels on the level-1 planes, ms per window
    (one launch each, as phases 6 and 9); with ``others`` (kernel
    libraries by name) also on each, in turns with this one ("new"), the
    decide kernels' planes held to this one's word for word."""
    from turbosqueeze_tpu_torch.format import split_blocks
    from turbosqueeze_tpu_torch.kernels import _build
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF
    from turbosqueeze_tpu_torch.parallel import pipeline

    blocks = split_blocks(_e2e_input(64))
    wins = [blocks[lo:lo + pipeline.WINDOW_BLOCKS]
            for lo in range(0, len(blocks), pipeline.WINDOW_BLOCKS)]
    libs = {**(others or {}), "new": _build.library()}
    res = {}
    for win in wins:
        batch = pipeline._upload_window(win, None, torch.device("cuda"))
        for level, matcher in ((0, "table"), (1, "cand")):
            cands = pipeline._phase_a(batch, win, 0) if level else None
            planes = pipeline.emit_planes(batch, cands, win, 0)
            t = _ab_ms({k: (lambda lib=lib, planes=planes, matcher=matcher:
                            _with(lib, lambda: EE.emit_batch(
                                *planes, matcher=matcher)))
                        for k, lib in libs.items()}, 1)
            for side, v in t.items():
                res.setdefault(("emit", level, side), []).append(v)
        # the decide kernels on the level-1 planes, held to this library's
        iw, cw, meta = planes
        nv = EB.next_valid(cw)
        for kname, fn in (
                ("encode_decide", lambda: EB.decide_batch(iw, cw, nv, meta)),
                ("encode_flat_decide",
                 lambda: EF.flat_decide_batch(iw, cw, nv, meta))):
            runs = {k: (lambda lib=lib, fn=fn: _with(lib, fn))
                    for k, lib in libs.items()}
            want = runs["new"]()
            for k in others or ():
                check(all(torch.equal(g, r) for g, r in zip(runs[k](), want)),
                      f"A/B {k}: {kname} window != this library's")
            del want
            for side, v in _ab_ms(runs, 1).items():
                res.setdefault((kname, 1, side), []).append(v)
        del batch, cands, planes, iw, cw, nv
    for (kname, level, side), v in sorted(res.items()):
        say("phase5" if kname == "emit" else "phase9", level=level,
            kernel=side if kname == "emit" else f"{kname} {side}",
            **{f"{kname}_ms_per_window": "/".join(
                "+".join(f"{x:.2f}" for x in w) for w in v)})


def _decide_classes(others=None):
    """The decide and flat decide kernels on each class's full block
    (``class_blocks``), one block a launch (B = 1, ext on, the main path's
    plane shapes): the payloads they make (assemble, layout) against the
    native core; time (the mean of two medians of 3), symbols, ms a
    symbol and the bound from what the run wrote (``_encode_moved``).
    With ``others`` (other checkouts' kernel libraries by name), each
    other library's planes are held to this one's word for word and timed
    in turns with it ("new")."""
    from gang_streams import CLASSES
    from turbosqueeze_tpu_torch.kernels import _build
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF
    from turbosqueeze_tpu_torch.runtime import native

    blocks = _e2e_input(len(CLASSES))
    libs = {**(others or {}), "new": _build.library()}
    for b, name in enumerate(CLASSES):
        blk = blocks[b * 4 * MiB:(b + 1) * 4 * MiB]
        iw, cw, meta = (p.cuda() for p in _emit_planes([blk]))
        nv = EB.next_valid(cw)
        want = native.encode_block_candidates(
            blk, native.build_candidates(blk), True)
        side, rec, osz = EB.decide_batch(iw, cw, nv, meta)
        desc, stats = EF.flat_decide_batch(iw, cw, nv, meta)
        words, fosz = EF.layout_live(desc, stats, iw, meta)
        check(EE.payload_from_words(EB.assemble_batch(iw, side, rec, osz)[0],
                                    int(osz[0, 0])) == want,
              f"decide {name}: payload != native")
        check(EE.payload_from_words(words[0], int(fosz[0, 0])) == want,
              f"flat decide {name}: payload != native")
        moved = _encode_moved(meta, osz, desc, stats)
        n_sym = int(stats[0, 0])
        for kname, fn, outs in (
                ("encode_decide", lambda: EB.decide_batch(iw, cw, nv, meta),
                 (side, rec, osz)),
                ("encode_flat_decide",
                 lambda: EF.flat_decide_batch(iw, cw, nv, meta),
                 (desc, stats))):
            runs = {k: (lambda lib=lib, fn=fn: _with(lib, fn))
                    for k, lib in libs.items()}
            for k in others or ():
                check(all(torch.equal(g, r) for g, r in zip(runs[k](), outs)),
                      f"A/B {k}: {kname} {name} != this library's")
            t = _ab_ms(runs)
            ms = statistics.mean(t["new"])
            say("phase9", kernel=kname, block=name, kernel_ms=f"{ms:.4f}",
                symbols=n_sym, ms_per_symbol=f"{ms / max(1, n_sym):.7f}",
                bytes=moved[kname],
                bound_ms=f"{moved[kname] / HBM_BYTES_PER_MS:.6f}",
                **{f"{k}_ms": "/".join(f"{x:.4f}" for x in v)
                   for k, v in t.items()})
        del side, rec, desc, words


def phase6(counts):
    """Compress end to end through the public API, and its layers timed
    apart on the same windows."""
    import turbosqueeze_tpu_torch as tsq
    from turbosqueeze_tpu_torch.format import split_blocks
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.parallel import pipeline

    data = _e2e_input(64)
    mb = len(data) / 1e6
    blocks = split_blocks(data)
    wins = [blocks[lo:lo + pipeline.WINDOW_BLOCKS]
            for lo in range(0, len(blocks), pipeline.WINDOW_BLOCKS)]
    for level in (0, 1, 2):
        matcher = {0: "table", 1: "cand"}.get(level)
        before = dict(counts)
        stream = _main_path(counts, lambda: tsq.compress(
            data, backend="cuda", level=level))
        check(stream == native.compress(data, True, level=level),
              f"level {level}: port compress != native compress")
        if matcher:
            check(counts[f"encode_emit_{matcher}"]
                  > before[f"encode_emit_{matcher}"],
                  f"level {level}: the {matcher} emitter never launched")
        out = _main_path(counts, lambda: tsq.decompress(stream,
                                                        backend="cuda"))
        check(out == data, f"level {level}: port decode of port compress "
              "!= input")
        e2e = [_host_ms(lambda: _main_path(counts, lambda: tsq.compress(
            data, backend="cuda", level=level)), 1) for _ in range(3)]
        e2e_ms = statistics.median(e2e)
        native_ms = _host_ms(lambda: native.compress(data, True,
                                                     level=level), 3)

        # the same windows, layer by layer
        up, pa, em, down, host_s, host_cpu = [], [], [], [], 0.0, 0.0
        for win in wins:
            t0 = time.perf_counter()
            batch = pipeline._upload_window(win, None, torch.device("cuda"))
            torch.cuda.synchronize()
            up.append((time.perf_counter() - t0) * 1e3)
            cands = None
            if level >= 1:
                pa.append(_cuda_ms(lambda: pipeline._phase_a(batch, win, 0),
                                   3))
                cands = pipeline._phase_a(batch, win, 0)
            if level <= 1:
                em.append(_cuda_ms(lambda: pipeline._emit_window(
                    batch, cands, win, 0, True), 1))
                words, osz = pipeline._emit_window(batch, cands, win, 0, True)
                rows = -(-int(osz[:, 0].max()) // 512)
                pinned = torch.empty((len(win), rows, 128), dtype=torch.int32,
                                     pin_memory=True)
                down.append(_cuda_ms(lambda: pinned.copy_(
                    words[:, :rows], non_blocking=True), 3))
            else:
                t0 = time.perf_counter()
                host = cands.cpu().numpy()
                down.append((time.perf_counter() - t0) * 1e3)
                cpu0, t0 = time.process_time(), time.perf_counter()
                with ThreadPoolExecutor() as pool:
                    list(pool.map(lambda b: native.encode_block_candidates(
                        win[b], host[b, :len(win[b])], True, level=level),
                        range(len(win))))
                host_s += time.perf_counter() - t0
                host_cpu += time.process_time() - cpu0
            del batch, cands
        fmt = lambda v: "/".join(f"{t:.2f}" for t in v)  # noqa: E731
        extra = ({"host_emit_s": f"{host_s:.3f}",
                  "host_emit_cpu_s": f"{host_cpu:.3f}",
                  "host_cores": f"{host_cpu / e2e_ms * 1e3:.2f}"}
                 if level >= 2 else {"emit_ms_per_window": fmt(em)})
        say("phase6", level=level, input_mb=f"{mb:.1f}",
            ratio=f"{len(stream) / len(data):.4f}", exact=True,
            compress_MBps=f"{mb / e2e_ms * 1e3:.1f}",
            e2e_ms="/".join(f"{t:.1f}" for t in e2e),
            h2d_ms_per_window=fmt(up),
            phase_a_ms_per_window=fmt(pa) if pa else "-",
            d2h_ms_per_window=fmt(down), **extra,
            native_compress_MBps=f"{mb / native_ms * 1e3:.1f}")

    # a preset dictionary: concat(dict, block) through phase A and the
    # cand matcher (level 1), or the host's lazy parse (level 2)
    from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

    d = synthetic_text(33_000, seed=113)
    part = data[:16 * 4 * MiB]
    for level in (1, 2):
        before = counts["encode_emit_cand"]
        t0 = time.perf_counter()
        stream = _main_path(counts, lambda: tsq.compress(
            part, backend="cuda", level=level, dictionary=d))
        e2e_ms = (time.perf_counter() - t0) * 1e3
        check(stream == native.compress_dict(part, d, True, level=level),
              f"dictionary level {level}: port != native.compress_dict")
        check(native.decompress_dict(stream, d) == part,
              f"dictionary level {level}: does not decode back")
        check(level == 2 or counts["encode_emit_cand"] > before,
              "dictionary: the cand emitter never launched")
        say("phase6", dictionary=len(d), level=level,
            input_mb=f"{len(part) / 1e6:.1f}", exact=True,
            compress_MBps=f"{len(part) / 1e6 / e2e_ms * 1e3:.1f}")


def _token_compare(errs, parsed, datas, what):
    """The token kernel on the card's copy of a window's planes against
    its plain version on the host's. Returns the planes and out_rows."""
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
    from turbosqueeze_tpu_torch.parallel import pipeline

    with ThreadPoolExecutor() as pool:
        planes, out_rows = pipeline._token_planes(parsed, pool, False)
    got = DK.decode_tokens_batch(*(p.cuda() for p in planes),
                                 out_rows=out_rows)
    torch.cuda.synchronize()
    ref = DK.decode_tokens_batch(*planes, out_rows=out_rows)
    base = parsed[0][6]
    for b, d in enumerate(datas):
        _compare(errs, "decode_tokens", _bytes_of(got, b, base, len(d)),
                 _bytes_of(ref, b, base, len(d)), d, f"{what} block {b}")
    return planes, out_rows


def phase7(errs, counts, timing, data, streams):
    """The host-tokenized decode: the token kernel against its plain
    version, the gang kernel in three windows, the pallas and xla routes
    and ``decompress_to_words`` on phase 3's containers, and a dictionary
    container through every route."""
    import turbosqueeze_tpu_torch as tsq
    from turbosqueeze_tpu_torch.format import iter_container, scan_block_table
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import synthetic_text
    from turbosqueeze_tpu_torch import block
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    datas, levels = _mixed_blocks()
    datas = [d[:300_000] for d in datas]
    for ext in (True, False):
        parsed = [block.tokenize_with_dict(
            native.compress(d, ext, level=lv)[19:], ext, None)
            for d, lv in zip(datas, levels)]
        _token_compare(errs, parsed, datas, f"tokens ext={ext}")
        say("phase7", ext=ext, blocks=len(datas),
            bytes=sum(map(len, datas)), exact=True)
    d = synthetic_text(33_000, seed=113)
    dict_datas = [synthetic_text(150_000, seed=114), bytes(20_000)]
    parsed = [block.tokenize_with_dict(next(iter_container(
        native.compress_dict(x, d, True)))[1], True, d) for x in dict_datas]
    _token_compare(errs, parsed, dict_datas, "tokens dictionary")
    say("phase7", dictionary=len(d), prefix_tokens=len(
        block.dict_prefix_tokens(0, len(d))[0]), exact=True)

    # garbage planes: counts past the chunk, addresses anywhere and near
    # the planes; the kernel stays inside them and equals its plain version
    rng = np.random.default_rng(8)
    pay_rows, out_rows = 64, 96
    pw = rng.integers(-2**31, 2**31, (4, pay_rows, 128), dtype=np.int32)
    ta = rng.integers(-2**31, 2**31, (4, 3, 8, 128), dtype=np.int32)
    tb = rng.integers(-2**31, 2**31, (4, 3, 8, 128), dtype=np.int32)
    near = rng.integers(0, (pay_rows + out_rows) * 512, (2, 3, 8, 128))
    ta[2:] = near | rng.integers(0, 128, near.shape) << 24
    tb[2:] = near[::-1]
    ta.reshape(4, -1)[:, ::1024] = rng.integers(-50, 1100, (4, 3))
    got = DK.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cuda"),
                                 out_rows=out_rows)
    ref = DK.decode_tokens_batch(*planes_to_torch(pw, ta, tb, device="cpu"),
                                 out_rows=out_rows)
    check(torch.equal(got.cpu(), ref), "garbage token planes: kernel != plain")
    say("phase7", garbage_planes="no fault", exact=True)

    # one full level-1 text block, B=1, at the main path's plane shapes
    stream = streams[1]
    _, table = scan_block_table(stream)
    off, psz, ext = table[1]
    parsed = [block.tokenize_with_dict(stream[off:off + psz], ext, None)]
    size = parsed[0][5]
    planes, out_rows = _token_compare(errs, parsed,
                                      [data[4 * MiB:4 * MiB + size]],
                                      "tokens full block")
    dev = [p.cuda() for p in planes]
    timing["decode_tokens"] = (
        _cuda_ms(lambda: DK.decode_tokens_batch(*dev, out_rows=out_rows), 5),
        _host_ms(lambda: DK.decode_tokens_batch(*planes, out_rows=out_rows),
                 1),
        _tokens_moved(parsed[0], size))
    say("phase7", full_block=True, tokens=len(parsed[0][1]),
        kernel_ms=f"{timing['decode_tokens'][0]:.4f}",
        plain_ms=f"{timing['decode_tokens'][1]:.1f}")

    # the gang kernel with a dictionary: a full block spans three windows
    full = data[4 * MiB:8 * MiB]
    (_, payload, ext), = iter_container(native.compress_dict(full, d, True))
    lw, gw, gm, _ = DG.prep_gang([(payload, ext)], 1, 8, dictionary=d)
    check(gm[0, 8] == 3, f"dictionary gang: {gm[0, 8]} windows, not 3")
    kw = dict(nblk=1, slot_recs=8, out_rows=3 * pipeline.DBK.WIN_ROWS,
              max_win=3)
    got = DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                               **kw)
    ref = DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cpu"),
                               **kw)
    _compare(errs, "decode_gang", _bytes_of(got, 0, len(d), len(full)),
             _bytes_of(ref, 0, len(d), len(full)), full,
             "gang dictionary, three windows")
    say("phase7", gang_dictionary=len(d), windows=3, exact=True)

    # the token routes end to end on the 256 MiB containers
    mb = len(data) / 1e6
    for level in (0, 1, 2):
        stream = streams[level]
        want = native.decompress(stream)
        check(want == data, f"level {level}: native decode != input")
        for impl in ("pallas", "xla"):
            before = counts["decode_tokens"]
            e2e = []
            for _ in range(3 if level == 1 else 1):
                t0 = time.perf_counter()
                out = _main_path(counts, lambda: pipeline.decompress(
                    stream, impl=impl))
                e2e.append((time.perf_counter() - t0) * 1e3)
                check(out == want, f"{impl} level {level}: != native decode")
            check(impl == "xla" or counts["decode_tokens"] > before,
                  f"{impl} level {level}: the token kernel never launched")
            say("phase7", impl=impl, level=level, input_mb=f"{mb:.1f}",
                exact=True,
                decode_MBps=f"{mb / statistics.median(e2e) * 1e3:.1f}",
                e2e_ms="/".join(f"{t:.1f}" for t in e2e))

    # the pallas route's layers on the level-1 windows
    stream = streams[1]
    _, table = scan_block_table(stream)
    wins = [table[lo:lo + pipeline.WINDOW_BLOCKS]
            for lo in range(0, len(table), pipeline.WINDOW_BLOCKS)]
    with ThreadPoolExecutor() as pool:
        cpu0, t0 = time.process_time(), time.perf_counter()
        parsed = [pipeline._tokenize_window(stream, w, None, pool)
                  for w in wins]
        tok_s, tok_cpu = time.perf_counter() - t0, time.process_time() - cpu0
        t0 = time.perf_counter()
        packed = [pipeline._token_planes(p, pool, True) for p in parsed]
        pack_ms = (time.perf_counter() - t0) * 1e3
    del parsed
    t0 = time.perf_counter()
    dev = [([p.to("cuda", non_blocking=True) for p in planes], rows)
           for planes, rows in packed]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = _cuda_ms(lambda: [DK.decode_tokens_batch(*p, out_rows=r)
                                  for p, r in dev], 3)
    del dev, packed
    say("phase7", impl="pallas", level=1, windows=len(wins),
        kernel_only_MBps=f"{mb / kernel_ms * 1e3:.1f}",
        kernel_ms=f"{kernel_ms:.2f}", tokenize_s=f"{tok_s:.3f}",
        tokenize_cpu_s=f"{tok_cpu:.3f}", pack_ms=f"{pack_ms:.1f}",
        upload_ms=f"{upload_ms:.1f}")

    # decompress_to_words: the words stay on the card
    t0 = time.perf_counter()
    words, sizes, _ = _main_path(counts, lambda: pipeline.decompress_to_words(
        stream))
    torch.cuda.synchronize()
    words_ms = (time.perf_counter() - t0) * 1e3
    check(words.shape[0] >= len(table) and words.shape[1:]
          == (DK.OUT_ROWS, 128) and len(sizes) == len(table),
          f"decompress_to_words: words {words.shape}")
    _words_exact(words, sizes, _blocks_of(data, sizes), "decompress_to_words")
    del words
    say("phase7", decompress_to_words=True, blocks=len(sizes), exact=True,
        e2e_ms=f"{words_ms:.1f}")

    # a dictionary container of 16 full blocks through the API and each
    # route; every full block takes three gang windows
    part = data[:16 * 4 * MiB]
    stream = native.compress_dict(part, d, True)
    want = native.decompress_dict(stream, d)
    check(want == part, "native dictionary decode != input")
    pmb = len(part) / 1e6
    runs = [("api", lambda: tsq.decompress(stream, backend="cuda",
                                           dictionary=d))]
    runs += [(impl, lambda impl=impl: pipeline.decompress(
        stream, impl=impl, dictionary=d))
        for impl in ("gang", "pallas", "xla", "stream")]
    for name, fn in runs:
        before = dict(counts)
        t0 = time.perf_counter()
        out = _main_path(counts, fn)
        ms = (time.perf_counter() - t0) * 1e3
        check(out == want, f"dictionary {name}: != native.decompress_dict")
        launched = {k: counts[k] - before[k] for k in counts}
        # the gang route sends a window the resolver declines to the
        # stream kernel
        kernels = {"api": ("decode_gang", "decode_stream"),
                   "gang": ("decode_gang", "decode_stream"),
                   "pallas": ("decode_tokens",),
                   "stream": ("decode_stream",), "xla": ()}[name]
        check(not kernels or sum(launched[k] for k in kernels) > 0,
              f"dictionary {name}: no kernel of {kernels} launched")
        say("phase7", dictionary=len(d), route=name,
            input_mb=f"{pmb:.1f}", exact=True,
            decode_MBps=f"{pmb / ms * 1e3:.1f}",
            launches=",".join(f"{k}:{launched[k]}" for k in kernels))


def _bulk_classes(others=None):
    """The bulk kernel on each class's full block (``class_blocks``, level
    1, ext on) through every stream ABI, a group holding a copy of the
    block a member (``bulk`` 1, ``bulk2`` 2, ``bulkn`` the width the route
    takes for it), the assemble entry on the block's decide planes, and
    the gang kernel on its gang planes (B = 1): each held to the input (the
    assemble to the native core's payload); its time (the mean of two
    medians of 3), the entries one block applies, us an entry and the
    bound. With ``others`` (other checkouts' kernel libraries by name),
    each is held to this library's words and timed in turns with it
    ("new")."""
    from gang_streams import CLASSES
    from turbosqueeze_tpu_torch.kernels import _build
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native

    blocks = _e2e_input(len(CLASSES))
    libs = {**(others or {}), "new": _build.library()}
    srecs = pipeline.GANG_SRECS[1]

    def timed(kname, name, fn, want, **kv):
        runs = {k: (lambda lib=lib: _with(lib, fn)) for k, lib in libs.items()}
        for k in others or ():
            check(torch.equal(runs[k](), want), f"A/B {k}: {kname} {name} "
                  "!= this library's")
        t = _ab_ms(runs)
        ms = statistics.mean(t["new"])
        n = kv.get("entries", kv.get("gangs"))
        say("bulk", kernel=kname, block=name, kernel_ms=f"{ms:.4f}", **kv,
            us_per_unit=f"{1e3 * ms / max(1, n):.4f}",
            **{f"{k}_ms": "/".join(f"{x:.4f}" for x in v)
               for k, v in t.items()})

    for b, name in enumerate(CLASSES):
        blk = blocks[b * 4 * MiB:(b + 1) * 4 * MiB]
        payload = (native.compress(blk, True, level=1)[19:], True)
        prep = DB.resolve_blocks([payload])[0]
        width = pipeline.bulk_abi("bulkn", [prep])
        for abi, nblk in (("bulk", 1), ("bulk2", 2), width):
            planes = DB.pack_batch([prep] * nblk, abi, nblk)[:3]
            dev = planes_to_torch(*planes, device="cuda")
            got = DB.decode_bulk(abi, nblk, *dev)
            for k in range(nblk):
                check(_bytes_of(got, k, 0, len(blk)) == blk,
                      f"{abi} {name} member {k} != input")
            m = planes[2][0].view(np.uint32).tolist()
            words = planes[1][0].reshape(-1).view(np.uint32).tolist()
            entries = len(DB._member_entries(words, m, abi, nblk, 0,
                                             DB.MAX_WIN))
            _, _, end_base = DB._ABIS[abi]
            moved = (nblk * len(prep[0]) + 4 * max(m[end_base:end_base + 2])
                     + _nbytes(dev[2], got))
            timed(f"decode_{abi}", name, lambda: DB.decode_bulk(
                abi, nblk, *dev), got, nblk=nblk, entries=entries,
                  bound_ms=f"{moved / HBM_BYTES_PER_MS:.6f}")
            del dev, got
        iw, cw, meta = (p.cuda() for p in _emit_planes([blk]))
        side, rec, osz = EB.decide_batch(iw, cw, EB.next_valid(cw), meta)
        got = EB.assemble_batch(iw, side, rec, osz)
        check(EE.payload_from_words(got[0], int(osz[0, 0])) ==
              native.encode_block_candidates(blk, native.build_candidates(blk),
                                             True),
              f"assemble {name}: payload != native")
        m = osz[0].cpu().view(torch.int32).tolist()
        words = (rec[0].cpu().reshape(-1).to(torch.int64)
                 & 0xFFFFFFFF).tolist()
        entries = len(DB._member_entries(words, m, "bulk", 1, 0,
                                         EB.OUT_WIN))
        moved = 32 + 4 * m[7] + 2 * m[0]
        timed("encode_assemble", name, lambda: EB.assemble_batch(
            iw, side, rec, osz), got, entries=entries,
              bound_ms=f"{moved / HBM_BYTES_PER_MS:.6f}")
        del iw, cw, side, rec, got
        gplanes = DG.prep_gang([payload], 1, srecs)
        dev = planes_to_torch(*gplanes[:3], device="cuda")
        got = DG.decode_gang_batch(*dev, nblk=1, slot_recs=srecs)
        check(_bytes_of(got, 0, 0, len(blk)) == blk, f"gang {name} != input")
        gm = gplanes[2][0].numpy().view(np.uint32)
        timed("decode_gang", name, lambda: DG.decode_gang_batch(
            *dev, nblk=1, slot_recs=srecs), got,
              gangs=int(max(gm[16:16 + 2 * int(gm[8])], default=0)))
        del dev, got


def _tokens_moved(parsed, size: int) -> int:
    """Bytes the token kernel must move for one tokenized block: its
    payload, two words a token and a count a chunk, and the block's
    output."""
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK

    n = len(parsed[1])
    return len(parsed[0]) + 8 * n + 4 * DK.n_chunks_for_tokens(n) + size


_STEPS = ("mover_wait", "jump", "load", "store", "prep_wait", "form",
          "paint", "entries", "feed_busy", "feed_wait")


def _clocks_library():
    """This tree's kernels built with the pair mover's step clocks
    (``TSQ_PAIRS_CLOCKS``, decode_pairs.cuh) into ``build/cuda/clocks/``,
    loaded."""
    import ctypes

    from turbosqueeze_tpu_torch.kernels import _build

    path = _build.LIB_PATH.parent / "clocks" / _build.LIB_PATH.name
    _build.build(_build.CSRC, path, ("-DTSQ_PAIRS_CLOCKS",))
    lib = _build.load(path)
    for k in ("tokens", "stream"):
        getattr(lib, f"tsq_decode_{k}_clocks").argtypes = [ctypes.c_void_p]
    return lib


def _decode_clocks(lib, kname, fn, what):
    """One launch of ``fn`` on the clocked library: lane 0's cycles a
    batch in each step of the moving, preparing and feeding warps, the
    batches and hull bytes a batch."""
    import ctypes

    from turbosqueeze_tpu_torch.kernels import _build

    entry = getattr(lib, f"tsq_{kname}_clocks")
    buf = (ctypes.c_ulonglong * 12)()
    _build.check_launch(entry(buf), kname)
    _with(lib, fn)
    torch.cuda.synchronize()
    _build.check_launch(entry(buf), kname)
    c = list(buf)
    n = max(1, c[10])
    say("clocks", kernel=kname, **what, batches=c[10],
        hull_bytes=f"{c[11] / n:.1f}",
        **{k: f"{c[i] / n:.0f}" for i, k in enumerate(_STEPS)})


def _decode_classes(others=None, clocks=None):
    """The token and stream kernels on each class's full block
    (``class_blocks``) at levels 0 and 1, ext on, one block a launch at the
    main path's plane shapes: each held to the input; its time (the mean
    of two medians of 3), the block's format pairs, ns a pair and the bound
    from the bytes it must move. With ``others`` (other checkouts' kernel
    libraries by name), each is held to this library's words and timed in
    turns with it ("new"). With ``clocks`` (``_clocks_library``), one more
    launch a block prints the mover's cycles a batch by step."""
    from gang_streams import CLASSES
    from turbosqueeze_tpu_torch import block
    from turbosqueeze_tpu_torch.kernels import _build
    from turbosqueeze_tpu_torch.kernels import decode_stream as DS
    from turbosqueeze_tpu_torch.kernels import decode_tokens as DK
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native

    blocks = _e2e_input(len(CLASSES))
    libs = {**(others or {}), "new": _build.library()}
    for level in (0, 1):
        for b, name in enumerate(CLASSES):
            blk = blocks[b * 4 * MiB:(b + 1) * 4 * MiB]
            payload = native.compress(blk, True, level=level)[19:]
            parsed = block.tokenize_with_dict(payload, True, None)
            pairs = -(-len(parsed[1]) // 2)
            with ThreadPoolExecutor() as pool:
                planes, out_rows = pipeline._token_planes([parsed], pool,
                                                          False)
            runs = {
                "decode_tokens": (
                    [p.cuda() for p in planes],
                    lambda dev: DK.decode_tokens_batch(*dev,
                                                       out_rows=out_rows),
                    _tokens_moved(parsed, len(blk))),
                "decode_stream": (
                    planes_to_torch(DK.pack_payload_words(payload)[None],
                                    DS.pack_meta([True], [len(blk)]),
                                    device="cuda"),
                    lambda dev: DS.decode_stream_batch(*dev),
                    len(payload) + 32 + len(blk))}
            for kname, (dev, fn, moved) in runs.items():
                got = fn(dev)
                check(_bytes_of(got, 0, 0, len(blk)) == blk,
                      f"{kname} {name} level {level} != input")
                fns = {k: (lambda lib=lib: _with(lib, lambda: fn(dev)))
                       for k, lib in libs.items()}
                for k in others or ():
                    check(torch.equal(fns[k](), got), f"A/B {k}: {kname} "
                          f"{name} level {level} != this library's")
                t = _ab_ms(fns)
                ms = statistics.mean(t["new"])
                say("decode", kernel=kname, level=level, block=name,
                    pairs=pairs, kernel_ms=f"{ms:.4f}",
                    ns_per_pair=f"{1e6 * ms / pairs:.2f}",
                    bound_ms=f"{moved / HBM_BYTES_PER_MS:.6f}",
                    **{f"{k}_ms": "/".join(f"{x:.4f}" for x in v)
                       for k, v in t.items()})
                if clocks is not None:
                    _decode_clocks(clocks, kname, lambda: fn(dev),
                                   {"level": level, "block": name})
                del got
            del runs


def _bulk_compare(errs, abi, nblk, planes, datas, what, base=0, **kw):
    """The bulk kernel on the card's copy of numpy ``planes`` against its
    plain version on the host's: each block's bytes and every word."""
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch

    got = DB.decode_bulk(abi, nblk, *planes_to_torch(*planes, device="cuda"),
                         **kw)
    torch.cuda.synchronize()
    ref = DB.decode_bulk(abi, nblk, *planes_to_torch(*planes, device="cpu"),
                         **kw)
    for k, d in enumerate(datas):
        _compare(errs, f"decode_{abi}", _bytes_of(got, k, base, len(d)),
                 _bytes_of(ref, k, base, len(d)), d, f"{what} block {k}")
    check(torch.equal(got.cpu(), ref), f"{what}: kernel != plain past the "
          "blocks' bytes")


def _garbage_bulk(rng, abi, nblk):
    """Two groups of entries with random rows, counts and records (sources
    anywhere, some past their planes), random words after them, and meta
    with random window counts and ends past the stream."""
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB

    meta_words, nwin_base, end_base = DB._ABIS[abi]
    rec = np.zeros((2, 24 * 128), np.uint32)
    for g in range(2):
        p = 0
        while p < rec.shape[1] - 40:
            n = int(rng.integers(0, 12))
            n_u = int(rng.integers(0, n + 1))
            r = rng.integers(0, 2**32, 2 * n, dtype=np.uint32)
            r[1::2] &= rng.choice(np.array(
                [0x800000FF, 0x203FFFFF, 0xFFFFFFFF], np.uint32), n)
            rec[g, p:p + 2] = rng.integers(0, 4200), n_u << 16 | (n - n_u)
            rec[g, p + 2:p + 2 + 2 * n] = r
            p += 2 + 2 * n
        rec[g, -5:] = rng.integers(0, 2**32, 5, dtype=np.uint32)
    meta = rng.integers(0, 2**32, (2, meta_words), dtype=np.uint32)
    meta[:, nwin_base:nwin_base + nblk] = rng.integers(0, 5, (2, nblk))
    meta[:, end_base:end_base + 3] = np.sort(
        rng.integers(0, rec.shape[1] + 600, (2, 3)), axis=1)
    lit = rng.integers(-2**31, 2**31, (2 * nblk, 16, 128), dtype=np.int32)
    return lit, rec.reshape(2, 24, 128), meta


_BULK_ABIS = (("bulk", 1), ("bulk2", 2), ("bulkn", 3), ("bulkn", 4))


def _bulk_full_group(errs, timing, data, stream):
    """One launch per ABI on the same full blocks of the level-1
    container, whole groups at the width the main path takes for them
    (bulkn's is the one the route picks for the container's first
    window): timed, held to the plain version and the input."""
    from turbosqueeze_tpu_torch.format import scan_block_table
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    _, table = scan_block_table(stream)
    with ThreadPoolExecutor() as pool:
        wprep = DB.resolve_blocks([(stream[o:o + n], e) for o, n, e
                                   in table[:pipeline.WINDOW_BLOCKS]],
                                  pool.map)
    width = pipeline.bulk_abi("bulkn", wprep)[1]
    fprep = wprep[:max(width, 2)]
    del wprep
    sizes = [int(p[2][0]) for p in fprep]
    abis = (("bulk", 1), ("bulk2", 2), ("bulkn", width))
    packed = [DB.pack_batch(fprep, abi, nblk)[:3] for abi, nblk in abis]
    devs = [planes_to_torch(*planes, device="cuda") for planes in packed]
    # the plain versions, a Python walk each, run at once in workers
    with _plain_pool(len(abis)) as pool:
        plain = pool.map_async(_plain_bulk, [
            (abi, nblk, planes) for (abi, nblk), planes in zip(abis, packed)])
        ms_of = [_cuda_ms(lambda: DB.decode_bulk(abi, nblk, *dev), 5)
                 for (abi, nblk), dev in zip(abis, devs)]
        plain = plain.get()
    for (abi, nblk), planes, dev, ms, (ref, plain_ms) in zip(
            abis, packed, devs, ms_of, plain):
        ref = torch.from_numpy(ref)
        got = DB.decode_bulk(abi, nblk, *dev)
        for k, size in enumerate(sizes):
            _compare(errs, f"decode_{abi}", _bytes_of(got, k, 0, size),
                     _bytes_of(ref, k, 0, size),
                     data[4 * MiB * k:4 * MiB * k + size],
                     f"{abi} full group block {k}")
        # the bytes the work needs: each block's literals and each group's
        # stream to its last window's end, read once; meta; the outputs
        _, _, end_base = DB._ABIS[abi]
        lit_b = sum(len(p[0]) for p in fprep)
        rec_b = 4 * int((planes[2][:, end_base:end_base + DB.MAX_WIN]
                         .view(np.uint32).max(axis=1)).sum())
        moved = lit_b + rec_b + _nbytes(dev[2], got)
        timing[f"decode_{abi}"] = (ms, plain_ms, moved)
        say("phase8", abi=abi, nblk=nblk, full_group=True, blocks=len(fprep),
            exact=True, kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.1f}",
            lit_bytes=lit_b, rec_bytes=rec_b, meta_bytes=_nbytes(dev[2]),
            out_bytes=_nbytes(got), bound_ms=f"{moved / HBM_BYTES_PER_MS:.6f}")
        del dev, got, ref


def phase8(errs, counts, timing, data, streams):
    """The bulk record-stream decode: the kernel through its three wrappers
    against its plain version, and the three bulk routes end to end."""
    from gang_streams import (BULK_CASES, CORRUPT, bulk_hand_planes,
                              corrupt_container)
    from turbosqueeze_tpu_torch.format import iter_container
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

    datas, levels = _mixed_blocks()
    # the plain version walks entries in Python: cut the one-window blocks
    datas = [d[:300_000] for d in datas[:-1]] + datas[-1:]
    exts = (True, False, True, False, True)
    preps = DB.resolve_blocks([(native.compress(x, e, level=lv)[19:], e)
                               for x, lv, e in zip(datas, levels, exts)])
    check(preps is not None, "the resolver declined a mixed block")
    for abi, nblk in _BULK_ABIS:
        _bulk_compare(errs, abi, nblk, DB.pack_batch(preps, abi, nblk)[:3],
                      datas, f"{abi} nblk={nblk}")
        say("phase8", abi=abi, nblk=nblk, blocks=len(datas),
            bytes=sum(map(len, datas)), exact=True)

    # a full block and a 33 KB dictionary span three 2 MiB windows
    d = synthetic_text(33_000, seed=113)
    full = data[4 * MiB:8 * MiB]
    (_, payload, ext), = iter_container(native.compress_dict(full, d, True))
    dprep = DB.resolve_blocks([(payload, ext)], dictionary=d)
    check(dprep[0][2][1] == 3, f"dictionary: {dprep[0][2][1]} windows, not 3")
    kw = {"out_rows": 3 * DB.WIN_ROWS, "max_win": 3}
    for abi, nblk in _BULK_ABIS[:3]:
        _bulk_compare(errs, abi, nblk, DB.pack_batch(dprep, abi, nblk)[:3],
                      [full], f"{abi} dictionary", base=len(d), **kw)
    say("phase8", dictionary=len(d), windows=3, exact=True)

    # garbage planes: the kernel stays inside them and equals its plain
    # version word for word
    rng = np.random.default_rng(10)
    for abi, nblk in _BULK_ABIS[:3]:
        planes = _garbage_bulk(rng, abi, nblk)
        got = DB.decode_bulk(abi, nblk,
                             *planes_to_torch(*planes, device="cuda"), **kw)
        ref = DB.decode_bulk(abi, nblk,
                             *planes_to_torch(*planes, device="cpu"), **kw)
        check(torch.equal(got.cpu(), ref), f"garbage {abi}: kernel != plain")
    say("phase8", garbage_planes="no fault", exact=True)

    # records that overlap (gang_streams.BULK_CASES): an entry's units in
    # the plain version's order, through each ABI
    for case in BULK_CASES:
        abi, nblk, *planes, _ = bulk_hand_planes(case)
        got, ref = (DB.decode_bulk(abi, nblk, *planes_to_torch(
            *planes, device=d), max_win=1) for d in ("cuda", "cpu"))
        errs[f"decode_{abi}"] = max(errs[f"decode_{abi}"],
                                    _byte_err(got, ref))
        check(torch.equal(got.cpu(), ref), f"overlap {case}: kernel != plain")
    say("phase8", overlap_cases=len(BULK_CASES), exact=True)

    # the corrupt containers on which three routes differ from the JAX
    # routes by design: each kernel gives its plain version's bytes
    for case in CORRUPT:
        _, c = corrupt_container(case, native)
        for impl, kname in (("pallas", "decode_tokens"),
                            ("bulk", "decode_bulk"),
                            ("stream", "decode_stream")):
            got, ref = (np.frombuffer(pipeline.decompress(
                c, device=d, impl=impl), np.uint8).astype(np.int16)
                for d in ("cuda", "cpu"))
            check(len(got) == len(ref), f"corrupt {case} {impl}: length")
            errs[kname] = max(errs[kname], int(np.abs(got - ref).max()))
            check(np.array_equal(got, ref),
                  f"corrupt {case} {impl}: kernel != plain")
    say("phase8", corrupt_containers=len(CORRUPT),
        routes="pallas,bulk,stream", exact=True)

    _bulk_full_group(errs, timing, data, streams[1])

    # the three bulk routes end to end on the 256 MiB containers
    mb = len(data) / 1e6
    for level in (0, 1, 2):
        stream = streams[level]
        want = native.decompress(stream)
        check(want == data, f"level {level}: native decode != input")
        for impl in ("bulk", "bulk2", "bulkn"):
            names = ("decode_bulk", "decode_bulk2", "decode_bulkn")
            before = sum(counts[k] for k in names)
            e2e = []
            for _ in range(4):  # a cold run, then three warm ones
                t0 = time.perf_counter()
                out = _main_path(counts, lambda: pipeline.decompress(
                    stream, impl=impl))
                e2e.append((time.perf_counter() - t0) * 1e3)
                check(out == want, f"{impl} level {level}: != native decode")
            check(sum(counts[k] for k in names) > before,
                  f"{impl} level {level}: the bulk kernel never launched")
            say("phase8", impl=impl, level=level, input_mb=f"{mb:.1f}",
                exact=True,
                decode_MBps=f"{mb / statistics.median(e2e[1:]) * 1e3:.1f}",
                e2e_ms="/".join(f"{t:.1f}" for t in e2e[1:]),
                cold_ms=f"{e2e[0]:.1f}")
            if level == 1:
                _bulk_layers(stream, impl, mb)

    # phase 7's dictionary container through the three routes
    part = data[:16 * 4 * MiB]
    stream = native.compress_dict(part, d, True)
    want = native.decompress_dict(stream, d)
    check(want == part, "native dictionary decode != input")
    for impl in ("bulk", "bulk2", "bulkn"):
        before = dict(counts)
        t0 = time.perf_counter()
        out = _main_path(counts, lambda: pipeline.decompress(
            stream, impl=impl, dictionary=d))
        ms = (time.perf_counter() - t0) * 1e3
        check(out == want, f"dictionary {impl}: != native.decompress_dict")
        launched = {k: counts[k] - before[k] for k in counts if "bulk" in k}
        check(sum(launched.values()) > 0, f"dictionary {impl}: no launch")
        say("phase8", dictionary=len(d), impl=impl,
            input_mb=f"{len(part) / 1e6:.1f}", exact=True,
            decode_MBps=f"{len(part) / 1e6 / ms * 1e3:.1f}",
            launches=",".join(f"{k}:{n}" for k, n in launched.items() if n))


def _bulk_layers(stream, impl, mb):
    """One bulk route's layers on the same windows as its decode: host
    resolve, merge and packing, upload, kernels and download, apart."""
    from turbosqueeze_tpu_torch.format import scan_block_table
    from turbosqueeze_tpu_torch.kernels import decode_bulk as DB
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    _, table = scan_block_table(stream)
    wins = [table[lo:lo + pipeline.WINDOW_BLOCKS]
            for lo in range(0, len(table), pipeline.WINDOW_BLOCKS)]
    with ThreadPoolExecutor() as pool:
        cpu0, t0 = time.process_time(), time.perf_counter()
        preps = [DB.resolve_blocks([(stream[o:o + n], e) for o, n, e in w],
                                   pool.map) for w in wins]
        resolve_s, resolve_cpu = (time.perf_counter() - t0,
                                  time.process_time() - cpu0)
        abis = [pipeline.bulk_abi(impl, p) for p in preps]
        cpu0, t0 = time.process_time(), time.perf_counter()
        planes = [DB.pack_batch(p, abi, nblk, pool.map)[:3]
                  for p, (abi, nblk) in zip(preps, abis)]
        merge_s, merge_cpu = (time.perf_counter() - t0,
                              time.process_time() - cpu0)
    del preps
    t0 = time.perf_counter()
    dev = [planes_to_torch(*p, device="cuda") for p in planes]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3

    def kernels():
        return [DB.decode_bulk(abi, nblk, *d) for d, (abi, nblk)
                in zip(dev, abis)]

    kernel_ms = _cuda_ms(kernels, 3)
    outs = kernels()
    host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            for o in outs]
    download_ms = _cuda_ms(lambda: [h.copy_(o, non_blocking=True)
                                    for h, o in zip(host, outs)], 3)
    say("phase8", impl=impl, level=1, windows=len(wins),
        groups="/".join(f"{a}x{n}" for a, n in abis),
        kernel_only_MBps=f"{mb / kernel_ms * 1e3:.1f}",
        kernel_ms=f"{kernel_ms:.2f}", resolve_s=f"{resolve_s:.3f}",
        resolve_cpu_s=f"{resolve_cpu:.3f}", merge_pack_s=f"{merge_s:.3f}",
        merge_pack_cpu_s=f"{merge_cpu:.3f}", upload_ms=f"{upload_ms:.1f}",
        download_ms=f"{download_ms:.1f}",
        rec_bytes=sum(_nbytes(d[1]) for d in dev),
        lit_bytes=sum(_nbytes(d[0]) for d in dev))


def _byte_err(got: torch.Tensor, ref: torch.Tensor) -> int:
    """The largest byte difference of two int32 planes."""
    if not ref.numel():
        return 0
    g, r = (t.contiguous().view(torch.uint8).to(torch.int16)
            for t in (got.cpu(), ref))
    return int((g - r).abs().max())


def _encode_compare(errs, planes, ext, what):
    """The decide, assemble and flat decide kernels on the card's copy of
    ``planes`` (input, candidates, meta) against their plain versions on
    the host's: every plane and osz/stats row word for word. Returns the
    card's (decide outputs, payload words, descriptors, stats, skip
    table) and the plain versions' milliseconds."""
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF

    host = [p.cpu() for p in planes]
    dev = [p.cuda() for p in planes]
    hnv, dnv = EB.next_valid(host[1]), EB.next_valid(dev[1])
    check(torch.equal(dnv.cpu(), hnv), f"{what}: next_valid card != host")
    got = EB.decide_batch(dev[0], dev[1], dnv, dev[2], ext=ext)
    pay = EB.assemble_batch(dev[0], *got)
    desc, stats = EF.flat_decide_batch(dev[0], dev[1], dnv, dev[2], ext=ext)
    torch.cuda.synchronize()
    plain_ms = {}
    t0 = time.perf_counter()
    ref = EB.decide_batch(host[0], host[1], hnv, host[2], ext=ext)
    plain_ms["encode_decide"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rpay = EB.assemble_batch(host[0], *ref)
    plain_ms["encode_assemble"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rflat = EF.flat_decide_batch(host[0], host[1], hnv, host[2], ext=ext)
    plain_ms["encode_flat_decide"] = (time.perf_counter() - t0) * 1e3
    for name, gs, rs in (("encode_decide", got, ref),
                         ("encode_assemble", [pay], [rpay]),
                         ("encode_flat_decide", (desc, stats), rflat)):
        for g, r in zip(gs, rs):
            errs[name] = max(errs[name], _byte_err(g, r))
            check(torch.equal(g.cpu(), r), f"{what}: {name} kernel != plain")
    return (got, pay, desc, stats, dnv), plain_ms


def _encode_payloads(planes, out, ext):
    """Each block's payload from the two-pass emitter's words and from the
    flat emitter's layout of the card's descriptors; the two must agree
    and neither may flag a block."""
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF

    (side, rec, osz), pay, desc, stats, _ = out
    words, fosz = EF.layout_live(desc, stats, planes[0].cuda(),
                                 planes[2].cuda(), ext=ext)
    osz, fosz = osz.cpu(), fosz.cpu()
    check(not osz[:, 2].any() and not fosz[:, 2].any(),
          f"an emitter flagged a block: {osz[:, 2].tolist()} "
          f"{fosz[:, 2].tolist()}")
    check(torch.equal(osz[:, 0], fosz[:, 0]), "bulk and flat sizes differ")
    out = []
    for b in range(osz.shape[0]):
        p = EE.payload_from_words(pay[b], int(osz[b, 0]))
        check(p == EE.payload_from_words(words[b], int(fosz[b, 0])),
              f"block {b}: bulk payload != flat payload")
        out.append(p)
    return out


def _garbage_encode(errs):
    """Garbage candidates and skip tables, a meta past the planes and a
    descriptor plane too small: every kernel equals its plain version."""
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_emit as EE
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

    rng = np.random.default_rng(12)
    blocks = [synthetic_text(200_000, seed=121), b"xyzxyzxyz" * 500,
              b"q" * 100]
    iw = torch.from_numpy(np.stack([EE.pack_input_words(b) for b in blocks]))
    cw = torch.from_numpy(np.stack([EE.pack_cand_words(
        native.build_candidates(b)) for b in blocks]))
    cw[0] = torch.from_numpy(rng.integers(-1, 400_000, cw[0].numel(),
                                          dtype=np.int32)).view(cw[0].shape)
    cw[1].view(-1)[100:300] = torch.arange(100, 300, dtype=torch.int32)
    meta = torch.from_numpy(EE.pack_meta([len(b) for b in blocks]))
    meta[2, 0] = (1 << 22) + 1
    nv = EB.next_valid(cw)
    nv[1].view(-1)[:3000] = torch.from_numpy(
        rng.integers(-5, 4000, 3000, dtype=np.int32))
    planes = [iw, cw, nv, meta]
    dev = [p.cuda() for p in planes]
    got = EB.decide_batch(*dev)
    ref = EB.decide_batch(*planes)
    runs = [("encode_decide", got, ref),
            ("encode_assemble", [EB.assemble_batch(dev[0], *got)],
             [EB.assemble_batch(iw, *ref)])]
    runs += [("encode_flat_decide", EF.flat_decide_batch(*dev, desc_rows=r),
              EF.flat_decide_batch(*planes, desc_rows=r)) for r in (8, 64)]
    for name, gs, rs in runs:
        for g, r in zip(gs, rs):
            errs[name] = max(errs[name], _byte_err(g, r))
            check(torch.equal(g.cpu(), r), f"garbage planes: {name} kernel "
                  "!= plain")
    check(ref[2][2, :3].tolist() == [-1, 0, 1], "a meta past the planes: "
          f"osz {ref[2][2].tolist()}")


def _assemble_overlaps(errs):
    """The single-stream overlap cases (``gang_streams.BULK_CASES``)
    through the assemble entry, their literal rows as the input plane's
    first rows beside a random side plane: the kernel against its plain
    version, word for word."""
    from gang_streams import BULK_CASES, bulk_hand_planes
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.kernels.encode_emit import IN_ROWS

    rng = np.random.default_rng(72)
    cases = [c for c, (abi, _, _) in BULK_CASES.items() if abi == "bulk"]
    for case in cases:
        _, _, lit, rec, meta, _ = bulk_hand_planes(case)
        planes = [np.zeros((1, rows, 128), np.int32) for rows in
                  (IN_ROWS, EB.SIDE_ROWS, EB.REC_ROWS)]
        planes[0][:, :lit.shape[1]] = lit
        planes[1][:] = rng.integers(-2**31, 2**31, planes[1].shape,
                                    dtype=np.int32)
        planes[2][:, :rec.shape[1]] = rec
        got, ref = (EB.assemble_batch(*planes_to_torch(*planes, meta,
                                                       device=d))
                    for d in ("cuda", "cpu"))
        errs["encode_assemble"] = max(errs["encode_assemble"],
                                      _byte_err(got, ref))
        check(torch.equal(got.cpu(), ref), f"assemble overlap {case}: "
              "kernel != plain")
    say("phase9", assemble_overlap_cases=len(cases), exact=True)


def _encode_moved(meta, osz, desc, stats) -> dict:
    """The bytes each new kernel must move for this batch, from what its
    run wrote rather than from the planes' capacity. A decide pass reads
    the meta row and each block's input bytes once, and at least one
    candidate word at each stop of the parse (each match and each literal
    run) plus one skip-table word per literal run; the two-pass decide
    writes the side bytes (the payload less its literal bytes), the stream
    up to its last window's end and the osz row, the flat one a descriptor
    per symbol and the stats row. The assemble pass reads the osz row, the
    stream and each payload byte's source once and writes the payload."""
    moved = dict.fromkeys(("encode_decide", "encode_assemble",
                           "encode_flat_decide"), 0)
    meta, osz, stats = meta.cpu(), osz.cpu(), stats.cpu()
    for b in range(meta.shape[0]):
        size, base = meta[b, :2].tolist()
        n = int(stats[b, 0])
        d = desc[b].reshape(-1)[:n].cpu()
        lit = d < 0
        lit_bytes = int((((d >> 25) & 15) + 1)[lit].sum())
        runs = int(lit[:1].sum() + (lit[1:] & ~lit[:-1]).sum())
        stops = int((~lit).sum()) + runs
        reads = 32 + base + size + 4 * stops + 4 * runs
        payload, stream = int(osz[b, 0]), 4 * int(osz[b, 7])
        moved["encode_decide"] += reads + payload - lit_bytes + stream + 32
        moved["encode_assemble"] += 32 + stream + 2 * payload
        moved["encode_flat_decide"] += reads + 4 * n + 32
    return moved


def _encode_full_block(errs, timing):
    """One launch of each new kernel on one full 4 MiB text block, B = 1,
    at the main path's plane shapes: timed, held to its plain version and
    to the native core."""
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF
    from turbosqueeze_tpu_torch.runtime import native

    full = _e2e_input(2)[4 * MiB:]
    planes = _emit_planes([full])
    out, plain_ms = _encode_compare(errs, planes, True, "full block")
    (side, rec, osz), pay, desc, stats, nv = out
    got = _encode_payloads(planes, out, True)
    check(got[0] == native.encode_block_candidates(
        full, native.build_candidates(full), True),
        "full block: payload != native")
    iw, cw, meta = (p.cuda() for p in planes)
    runs = {
        "encode_decide": lambda: EB.decide_batch(iw, cw, nv, meta),
        "encode_assemble": lambda: EB.assemble_batch(iw, side, rec, osz),
        "encode_flat_decide": lambda: EF.flat_decide_batch(iw, cw, nv, meta),
    }
    moved = _encode_moved(meta, osz, desc, stats)
    for name, fn in runs.items():
        ms = _cuda_ms(fn, 3)
        timing[name] = (ms, plain_ms[name], moved[name])
        say("phase9", kernel=name, full_block=True, exact=True,
            kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms[name]:.1f}",
            bytes=moved[name],
            bound_ms=f"{moved[name] / HBM_BYTES_PER_MS:.6f}")
    say("phase9", full_block=True, payload=len(got[0]),
        n_sym=int(stats[0, 0]), records=int(osz[0, 7]) // 2,
        next_valid_ms=f"{_cuda_ms(lambda: EB.next_valid(cw), 3):.4f}",
        layout_ms=f"{_cuda_ms(lambda: EF.layout_live(desc, stats, iw, meta), 3):.4f}")


def _emitter_layers(data, emit_impl):
    """One level-1 route's layers on the windows of its compress, each on
    the device clock: upload, phase A, next_valid, decide, assemble or
    layout, download of the live rows."""
    from turbosqueeze_tpu_torch.format import split_blocks
    from turbosqueeze_tpu_torch.kernels import encode_bulk as EB
    from turbosqueeze_tpu_torch.kernels import encode_flat as EF
    from turbosqueeze_tpu_torch.parallel import pipeline

    blocks = split_blocks(data)
    layers = {k: [] for k in ("upload", "phase_a", "next_valid", "decide",
                              "assemble" if emit_impl == "bulk" else "layout",
                              "download")}
    for lo in range(0, len(blocks), pipeline.WINDOW_BLOCKS):
        win = blocks[lo:lo + pipeline.WINDOW_BLOCKS]
        t0 = time.perf_counter()
        batch = pipeline._upload_window(win, None, torch.device("cuda"))
        torch.cuda.synchronize()
        layers["upload"].append((time.perf_counter() - t0) * 1e3)
        layers["phase_a"].append(_cuda_ms(
            lambda: pipeline._phase_a(batch, win, 0), 1))
        cands = pipeline._phase_a(batch, win, 0)
        iw, cw, meta = pipeline.emit_planes(batch, cands, win, 0)
        layers["next_valid"].append(_cuda_ms(lambda: EB.next_valid(cw), 1))
        nv = EB.next_valid(cw)
        if emit_impl == "bulk":
            layers["decide"].append(_cuda_ms(
                lambda: EB.decide_batch(iw, cw, nv, meta), 1))
            side, rec, osz = EB.decide_batch(iw, cw, nv, meta)
            layers["assemble"].append(_cuda_ms(
                lambda: EB.assemble_batch(iw, side, rec, osz), 1))
            words = EB.assemble_batch(iw, side, rec, osz)
        else:
            layers["decide"].append(_cuda_ms(
                lambda: EF.flat_decide_batch(iw, cw, nv, meta), 1))
            desc, stats = EF.flat_decide_batch(iw, cw, nv, meta)
            layers["layout"].append(_cuda_ms(
                lambda: EF.layout_live(desc, stats, iw, meta), 1))
            words, osz = EF.layout_live(desc, stats, iw, meta)
        rows = -(-int(osz[:, 0].max()) // 512)
        pinned = torch.empty((len(win), rows, 128), dtype=torch.int32,
                             pin_memory=True)
        layers["download"].append(_cuda_ms(lambda: pinned.copy_(
            words[:, :rows], non_blocking=True), 1))
        del batch, cands, iw, cw, nv, words
    return {k: "/".join(f"{t:.2f}" for t in v) for k, v in layers.items()}


def phase9(errs, counts, timing, data):
    """The two-pass and flat emitters: their kernels against their plain
    versions, then ``compress(emit_impl="bulk"|"flat")`` end to end."""
    from gang_streams import open_slot_blocks
    from turbosqueeze_tpu_torch.format import iter_container
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import (synthetic_binary,
                                                     synthetic_text)
    from turbosqueeze_tpu_torch.parallel import pipeline

    rng = np.random.default_rng(3)
    alt = b"".join(rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
                   + b"QWERTYUI" for _ in range(20_000))
    blocks = [synthetic_text(700_000, seed=41),
              synthetic_binary(500_000, seed=43), bytes(300_000),
              np.random.default_rng(7).bytes(4 * MiB), alt, b"abcab", b"",
              *open_slot_blocks()]
    d = synthetic_text(33_000, seed=113)
    dict_blocks = [synthetic_text(150_000, seed=114), bytes(20_000)]
    for dictionary, blks in ((b"", blocks), (d, dict_blocks)):
        for ext in (True, False):
            if not ext and not dictionary:
                # ext moves no literal: the random block once is enough
                blks = blocks[:3] + blocks[4:]
            planes = _emit_planes(blks, dictionary=dictionary)
            what = f"ext={ext} dictionary={len(dictionary)}"
            out, plain_ms = _encode_compare(errs, planes, ext, what)
            got = _encode_payloads(planes, out, ext)
            for b, blk in enumerate(blks):
                if not blk:
                    check(len(got[b]) == 5, "empty block: not 5 bytes")
                    continue
                cand = native.build_candidates(dictionary + blk)
                want = (native.encode_block_dict(blk, dictionary, cand, ext)
                        if dictionary
                        else native.encode_block_candidates(blk, cand, ext))
                check(got[b] == want, f"{what} block {b}: != native")
            say("phase9", ext=ext, dictionary=len(dictionary),
                blocks=len(blks), bytes=sum(map(len, blks)), exact=True,
                **{f"{k}_plain_ms": f"{v:.1f}" for k, v in plain_ms.items()})
    _garbage_encode(errs)
    say("phase9", garbage_planes="no fault", exact=True)
    _assemble_overlaps(errs)
    _encode_full_block(errs, timing)

    # the routes end to end on phase 3's 256 MiB, level 1
    mb = len(data) / 1e6
    want = native.compress(data, True, level=1)
    names = {"bulk": ("encode_decide", "encode_assemble"),
             "flat": ("encode_flat_decide",)}
    for emit_impl, kernels in names.items():
        before = dict(counts)
        over = pipeline.overflow_blocks
        e2e = []
        for k in range(4):  # a cold run, then three warm ones
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = _main_path(counts, lambda: pipeline.compress(
                data, level=1, emit_impl=emit_impl))
            e2e.append((time.perf_counter() - t0) * 1e3)
            check(got == want, f"{emit_impl}: port compress != native")
        peak = torch.cuda.max_memory_allocated()
        check(all(counts[k] > before[k] for k in kernels),
              f"{emit_impl}: a kernel of {kernels} never launched")
        say("phase9", emit_impl=emit_impl, level=1, input_mb=f"{mb:.1f}",
            exact=True,
            compress_MBps=f"{mb / statistics.median(e2e[1:]) * 1e3:.1f}",
            e2e_ms="/".join(f"{t:.1f}" for t in e2e[1:]),
            cold_ms=f"{e2e[0]:.1f}",
            overflow_blocks=pipeline.overflow_blocks - over,
            peak_device_GiB=f"{peak / 2**30:.2f}",
            **_emitter_layers(data, emit_impl))

    # 64 MiB of it with the 33 KB dictionary through both routes
    part = data[:16 * 4 * MiB]
    want = native.compress_dict(part, d, True)
    check(native.decompress_dict(want, d) == part, "native dictionary "
          "round trip")
    for emit_impl, kernels in names.items():
        before = dict(counts)
        t0 = time.perf_counter()
        got = _main_path(counts, lambda: pipeline.compress(
            part, dictionary=d, emit_impl=emit_impl))
        ms = (time.perf_counter() - t0) * 1e3
        check(got == want, f"dictionary {emit_impl}: != native.compress_dict")
        check(all(counts[k] > before[k] for k in kernels),
              f"dictionary {emit_impl}: no launch")
        say("phase9", dictionary=len(d), emit_impl=emit_impl,
            input_mb=f"{len(part) / 1e6:.1f}", exact=True,
            compress_MBps=f"{len(part) / 1e6 / ms * 1e3:.1f}",
            blocks=sum(1 for _ in iter_container(got)))


def _plain_tsqx_group(args):
    """The gang kernel's plain version on one TSQX group's planes, in a
    worker: (words, milliseconds)."""
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels.decode_bulk import MAX_WIN
    from turbosqueeze_tpu_torch.kernels.decode_tokens import OUT_ROWS

    torch.set_num_threads(1)
    planes, nblk, srecs = args
    t0 = time.perf_counter()
    words = DG._decode_gang_plain(*(torch.from_numpy(p) for p in planes),
                                  nblk=nblk, out_rows=OUT_ROWS,
                                  max_win=MAX_WIN, slot_recs=srecs)
    return words.numpy(), (time.perf_counter() - t0) * 1e3


def _cpu_wall(fn):
    """(result, wall ms, host CPU seconds over wall seconds) of ``fn()``;
    the CPU seconds are the process's, every thread's."""
    cpu0, t0 = time.process_time(), time.perf_counter()
    r = fn()
    wall = time.perf_counter() - t0
    return r, wall * 1e3, (time.process_time() - cpu0) / wall


def _tsqx_layers(view, dev):
    """One TSQX decode's layers apart, on all of its batches: the copy of
    the file's planes into pinned memory (host ms), their upload, the gang
    kernel and the download (device ms, CUDA events, median of 3)."""
    from turbosqueeze_tpu_torch import tsqx
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG

    batches = [(lo, min(lo + tsqx.BATCH_GROUPS, view.n_groups))
               for lo in range(0, view.n_groups, tsqx.BATCH_GROUPS)]
    staged = []

    def stage():
        staged[:] = [tsqx._host_planes(view, lo, hi, True)
                     for lo, hi in batches]

    stage_ms = _host_ms(stage, 3)
    planes = [[t.to(dev, non_blocking=True) for t in b] for b in staged]
    upload_ms = _cuda_ms(lambda: [d.copy_(h, non_blocking=True)
                                  for b, hb in zip(planes, staged)
                                  for d, h in zip(b, hb)], 3)

    def kernels():
        return [DG.decode_gang_batch(*b, nblk=view.nblk,
                                     slot_recs=view.slot_recs)
                for b in planes]

    kernel_ms = _cuda_ms(kernels, 3)
    outs = kernels()
    host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            for o in outs]
    download_ms = _cuda_ms(lambda: [h.copy_(o, non_blocking=True)
                                    for h, o in zip(host, outs)], 3)
    plane_bytes = sum(_nbytes(*b) for b in staged)
    return stage_ms, upload_ms, kernel_ms, download_ms, plane_bytes


def _tsqx_timed(counts, data, stream, mb) -> dict:
    """Phase 3's level-1 container packed at nblk 1, 4 and 8 and decoded
    through the API (a cold run and three warm ones, each against the
    input), with its layers timed apart. Returns {nblk: TSQX bytes}."""
    import turbosqueeze_tpu_torch as tsq
    from turbosqueeze_tpu_torch import tsqx

    packs = {}
    for nblk in (1, 4, 8):
        packed, pack_ms, pack_cores = _cpu_wall(
            lambda: tsqx.pack(stream, nblk=nblk))
        packs[nblk] = packed
        view = tsqx.TsqxView(packed)
        before, runs = counts["decode_gang"], []
        for _ in range(4):  # a cold run, then three warm ones
            out, ms, cores = _cpu_wall(lambda: _main_path(
                counts, lambda: tsq.decompress(packed)))
            check(out == data, f"tsqx nblk {nblk}: api.decompress != input")
            runs.append((None, ms, cores))
        check(counts["decode_gang"] > before,
              f"tsqx nblk {nblk}: the gang kernel never launched")
        stage_ms, up_ms, kernel_ms, down_ms, plane_bytes = _tsqx_layers(
            view, torch.device("cuda", 0))
        warm = sorted(r[1] for r in runs[1:])
        say("phase10", tsqx_nblk=nblk, slot_recs=view.slot_recs,
            groups=view.n_groups, tsqx_bytes=len(packed),
            plane_bytes=plane_bytes, lit_rows=view.lit_rows,
            rec_rows=view.rec_rows, exact=True,
            decode_MBps=f"{mb / warm[1] * 1e3:.1f}",
            e2e_ms="/".join(f"{r[1]:.1f}" for r in runs[1:]),
            cold_ms=f"{runs[0][1]:.1f}",
            host_cores="/".join(f"{r[2]:.2f}" for r in runs[1:]),
            stage_ms=f"{stage_ms:.1f}", upload_ms=f"{up_ms:.1f}",
            kernel_ms=f"{kernel_ms:.2f}", download_ms=f"{down_ms:.1f}",
            kernel_only_MBps=f"{mb / kernel_ms * 1e3:.1f}",
            pack_ms=f"{pack_ms:.0f}", pack_cores=f"{pack_cores:.2f}")
    return packs


def _tsqx_plain_args(packs) -> list:
    """Group 0's planes of each pack, for ``_plain_tsqx_group``."""
    from turbosqueeze_tpu_torch import tsqx

    args = []
    for nblk, packed in packs.items():
        v = tsqx.TsqxView(packed)
        args.append(((v.lit_words[:nblk].copy(), v.gang_words[:1].copy(),
                      v.gmeta[:1].copy()), nblk, v.slot_recs))
    return args


def _tsqx_words(errs, data, packs, plain) -> None:
    """Each pack through ``decode_to_words``, batch by batch, every block
    against the input; group 0's words against the plain version's."""
    from turbosqueeze_tpu_torch import tsqx

    for (nblk, packed), (ref, plain_ms) in zip(packs.items(), plain):
        view = tsqx.TsqxView(packed)
        for lo in range(0, view.n_groups, tsqx.BATCH_GROUPS):
            words, sizes = tsqx.decode_to_words(
                view, groups=slice(lo, lo + tsqx.BATCH_GROUPS))
            o = lo * nblk * 4 * MiB
            _words_exact(words, sizes, [
                data[o + b * 4 * MiB:o + b * 4 * MiB + sizes[b]]
                for b in range(min(len(sizes), view.n_blocks - lo * nblk))],
                f"tsqx nblk {nblk}: decode_to_words groups {lo}..")
            if lo == 0:
                host = words.shards[0].data[:nblk].cpu()
                ref = torch.from_numpy(ref)
                check(torch.equal(host, ref),
                      f"tsqx nblk {nblk} group 0: kernel != plain words")
                for b in range(nblk):
                    _compare(errs, "decode_gang",
                             _bytes_of(host, b, 0, sizes[b]),
                             _bytes_of(ref, b, 0, sizes[b]),
                             data[b * 4 * MiB:b * 4 * MiB + sizes[b]],
                             f"tsqx nblk {nblk} group 0 block {b}")
                del host
            del words
        say("phase10", tsqx_nblk=nblk, decode_to_words="exact",
            group0_plain_ms=f"{plain_ms:.1f}", kernel_equals_plain=True)


def _cli_runs(data, tmp: Path) -> None:
    """The CLI as a user runs it, one process a verb, on 64 MiB: compress
    at level 1, pack, decode both containers, info, verify."""
    from turbosqueeze_tpu_torch.runtime import native

    part = data[:64 * MiB]
    src = tmp / "in.bin"
    src.write_bytes(part)
    cli = [sys.executable, "-m", "turbosqueeze_tpu_torch.cli"]
    verbs = (("c", "--level", "1", src, tmp / "a.tsq"),
             ("x", tmp / "a.tsq", tmp / "a.tsqx"),
             ("d", tmp / "a.tsq", tmp / "d.bin"),
             ("d", tmp / "a.tsqx", tmp / "x.bin"),
             ("info", tmp / "a.tsq"), ("verify", src, tmp / "a.tsq"))
    for verb in verbs:
        t0 = time.perf_counter()
        r = subprocess.run(cli + [str(a) for a in verb], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        check(r.returncode == 0,
              f"cli {verb[0]}: rc {r.returncode}\n{r.stderr[-2000:]}")
        say("phase10", cli=verb[0], s=f"{time.perf_counter() - t0:.1f}",
            out=json.dumps(r.stdout.strip().splitlines()[-1]))
    check((tmp / "a.tsq").read_bytes() == native.compress(part, level=1),
          "cli c: container != native.compress")
    for name in ("d.bin", "x.bin"):
        check((tmp / name).read_bytes() == part, f"cli d: {name} != input")


def _file_runs(counts, data, stream, mb, out: Path) -> None:
    """``decompress_to_file`` through every route of its set, each file
    against the input; ``gang`` (the default) timed, a cold run and
    three warm ones."""
    from turbosqueeze_tpu_torch.parallel import pipeline

    for impl in pipeline._FILE_IMPLS:
        runs = []
        for _ in range(4 if impl == "gang" else 1):
            out.unlink(missing_ok=True)
            r = _cpu_wall(lambda: _main_path(
                counts, lambda: pipeline.decompress_to_file(
                    stream, out, impl=impl)))
            check(r[0] == len(data), f"decompress_to_file {impl}: size")
            check(out.read_bytes() == data,
                  f"decompress_to_file {impl}: file != input")
            runs.append(r)
        warm = sorted(r[1] for r in runs[1:] or runs)
        say("phase10", decompress_to_file=impl, level=1, exact=True,
            MBps=f"{mb / warm[len(warm) // 2] * 1e3:.1f}",
            wall_ms="/".join(f"{r[1]:.1f}" for r in runs),
            host_cores="/".join(f"{r[2]:.2f}" for r in runs))
    out.unlink()


def _job_runs(counts, data, mb) -> None:
    """Eight compress jobs at once on the card (levels 0 and 1), then
    eight decompress jobs, each against the native core and the input."""
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.runtime.jobs import JobEngine

    parts = [data[i * 32 * MiB:(i + 1) * 32 * MiB] for i in range(8)]
    with JobEngine(n_workers=8) as eng:
        t0 = time.perf_counter()
        got = _main_path(counts, lambda: [j.result(600) for j in [
            eng.submit_compress(x, level=i % 2) for i, x in enumerate(parts)]])
        comp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = _main_path(counts, lambda: [j.result(600) for j in [
            eng.submit_decompress(s) for s in got]])
        dec_s = time.perf_counter() - t0
    for i, (x, s, y) in enumerate(zip(parts, got, back)):
        check(s == native.compress(x, level=i % 2),
              f"job {i}: container != native.compress")
        check(y == x, f"job {i}: decompress != input")
    say("phase10", jobs=8, job_mb=f"{len(parts[0]) / 1e6:.1f}", exact=True,
        compress_MBps=f"{mb / comp_s:.1f}", decompress_MBps=f"{mb / dec_s:.1f}")


def phase10(errs, counts, data, streams):
    """The serving profile and the entry points around the API, on phase
    3's input: TSQX at nblk 1, 4 and 8 (timed first, with no other work
    on the host); then, while workers run the gang kernel's plain version
    on group 0 of each pack, ``decode_to_words`` on every block and the
    CLI in subprocesses; then ``decompress_to_file`` through every route
    of its set and the job engine with eight jobs at once."""
    import tempfile

    mb = len(data) / 1e6
    packs = _tsqx_timed(counts, data, streams[1], mb)
    with tempfile.TemporaryDirectory() as tmp:
        with _plain_pool(3) as pool:
            plain = pool.map_async(_plain_tsqx_group, _tsqx_plain_args(packs))
            _cli_runs(data, Path(tmp))
            plain = plain.get()
        _tsqx_words(errs, data, packs, plain)
        del packs
        _file_runs(counts, data, streams[1], mb, Path(tmp) / "out")
    _job_runs(counts, data, mb)


_CARD = "cuda:0"  # the card phase 11 spreads its shards over
_WORKER = "turbosqueeze_tpu_torch.parallel._worker"


def _shards_timed(counts, name, kernel, want, mb, call) -> None:
    """``call(device)`` as a main path with every window on one shard
    (``_CARD``) and split into two shards on it, in turns (one, two, two,
    one): each result equal to ``want``, each run launching ``kernel``;
    wall ms, MB/s and host cores of both."""
    runs = {1: [], 2: []}
    for n in (1, 2, 2, 1):
        before = counts[kernel]
        out, ms, cores = _cpu_wall(lambda: _main_path(
            counts, lambda: call(_CARD if n == 1 else [_CARD] * n)))
        check(out == want, f"phase11 {name}, {n} shard(s): wrong bytes")
        check(counts[kernel] > before,
              f"phase11 {name}, {n} shard(s): {kernel} never launched")
        runs[n].append((ms, cores))
    say("phase11", spread=name, card=_CARD, exact=True,
        **{f"shards{n}_{k}": v for n, r in runs.items() for k, v in (
            ("MBps", f"{mb / statistics.mean(m for m, _ in r) * 1e3:.1f}"),
            ("wall_ms", "/".join(f"{m:.1f}" for m, _ in r)),
            ("host_cores", "/".join(f"{c:.2f}" for _, c in r)))})


def _words_timed(counts, name, kernel, data, mb, call) -> None:
    """``call(device)`` -> (``BlockShards``, sizes), a device-resident
    decode of phase 3's input, as a main path over one shard (``_CARD``)
    and two shards on it, in turns (one, two, two, one): each run ends
    when the card has finished (the words stay there), launches
    ``kernel`` and is then checked block by block from the card, every
    shard on ``_CARD``; wall ms, MB/s and host cores of both."""
    runs = {1: [], 2: []}
    for n in (1, 2, 2, 1):
        before = counts[kernel]

        def run():
            out = call(_CARD if n == 1 else [_CARD] * n)
            torch.cuda.synchronize(_CARD)
            return out

        (words, sizes), ms, cores = _cpu_wall(lambda: _main_path(counts, run))
        check(counts[kernel] > before,
              f"phase11 {name}, {n} shard(s): {kernel} never launched")
        blocks = _blocks_of(data, sizes)
        check(len(words.shards) == n and words.shape[0] >= len(blocks),
              f"phase11 {name}, {n} shard(s): {len(words.shards)} shards, "
              f"shape {words.shape}")
        _words_exact(words, sizes, blocks, f"phase11 {name}, {n} shard(s)",
                     _CARD)
        del words
        runs[n].append((ms, cores))
    say("phase11", spread=name, card=_CARD, exact=True, words_on_card=True,
        **{f"shards{n}_{k}": v for n, r in runs.items() for k, v in (
            ("MBps", f"{mb / statistics.mean(m for m, _ in r) * 1e3:.1f}"),
            ("wall_ms", "/".join(f"{m:.1f}" for m, _ in r)),
            ("host_cores", "/".join(f"{c:.2f}" for _, c in r)))})


def _worker_pair(tmp: str, args: list) -> dict:
    """Two ranks of the port's worker on ``_CARD`` over the inputs in
    ``tmp``, joined by gloo on localhost, with the worker's ``args``:
    {op: {(rank, rep): record}}. A rank that fails or outlives its
    timeout fails the phase, and both are killed."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", _WORKER, coordinator, "2", str(rank), tmp,
         "--device", _CARD, *args], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    except subprocess.TimeoutExpired:
        raise SmokeFailure("phase11: a worker outlived its 240 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"phase11 rank {rank}: rc {p.returncode}\n{err[-3000:]}")
    recs = collections.defaultdict(dict)
    for so, _ in outs:
        for line in so.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                check(r["ok"], f"phase11 rank {r['rank']}: {r['op']} failed")
                recs[r["op"]][r["rank"], r["rep"]] = r
    return recs


def _two_processes(data, stream, mb) -> None:
    """Two processes on ``_CARD``: decode (gang, pallas),
    ``decompress_to_file`` (gang), ``compress(level=1)``, TSQX at nblk 4,
    ``decompress_to_words`` (pallas, stream) and ``tsqx.decode_to_words``
    (nblk 4) on phase 3's input, a cold run and a warm one each, checked by
    the workers (rank 0 gets the input, rank 1 ``b""``; both ranks
    ``native.compress``'s container; each rank exactly its own shards of
    the words, every block exact), and the host-0 hop alone; then the
    gang decode again in windows of 32 blocks, 16 a rank, so that each
    rank's next window is resolved while its last decodes. Each rank's
    wall and host cores per op."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("input", "words"):
            (Path(tmp) / f"{name}.bin").write_bytes(data)
            (Path(tmp) / f"{name}.tsq").write_bytes(stream)
        runs = [(0, _worker_pair(tmp, [
            "--reps", "2", "--ops", "decompress:gang,decompress:pallas,"
            "file:gang,compress:1,tsqx:4,hop,words:pallas,words:stream,"
            "tsqx_words:4"])),
            (32, _worker_pair(tmp, ["--reps", "2", "--window", "32",
                                    "--ops", "decompress:gang"]))]
    for window, recs in runs:
        for op, rr in recs.items():
            # a words op ends when both ranks hold their shards
            wall = (max(rr[0, 1]["wall_ms"], rr[1, 1]["wall_ms"])
                    if "words" in op else rr[0, 1]["wall_ms"])
            extra = ({"hop_MBps": f"{rr[0, 1]['MBps']:.1f}"} if op == "hop"
                     else {"MBps": f"{mb / wall * 1e3:.1f}"})
            say("phase11", processes=2, card=_CARD, op=op,
                window_blocks=window or "default", exact=True, **extra,
                **{f"rank{k}_{f}": "/".join(
                    f"{rr[k, rep][f]}" for rep in range(2))
                   for k in range(2) for f in ("wall_ms", "host_cores")})
    say("phase11", processes=2, s=f"{time.perf_counter() - t0:.1f}")


def phase11(counts, data, streams):
    """One call's blocks over several shards: (a) every window split into
    two shards on one card, phase 3's level-1 container through ``gang``,
    ``pallas`` and ``bulk2``, ``compress(level=1)`` and TSQX at nblk 4,
    and through the device-resident decodes (``decompress_to_words``
    pallas and stream, ``tsqx.decode_to_words`` at nblk 4), each timed
    beside one shard in turns; (b) every CUDA device, where the machine
    has more than one; (c) two processes on the one card."""
    import turbosqueeze_tpu_torch as tsq
    from turbosqueeze_tpu_torch import tsqx
    from turbosqueeze_tpu_torch.parallel import pipeline

    mb, stream = len(data) / 1e6, streams[1]
    for impl, kernel in (("gang", "decode_gang"), ("pallas", "decode_tokens"),
                         ("bulk2", "decode_bulk2")):
        _shards_timed(counts, f"decompress {impl}", kernel, data, mb,
                      lambda dev: pipeline.decompress(stream, device=dev,
                                                      impl=impl))
    _shards_timed(counts, "compress level 1", "encode_emit_cand", stream, mb,
                  lambda dev: pipeline.compress(data, level=1, device=dev))
    packed = tsqx.pack(stream, nblk=4)
    _shards_timed(counts, "tsqx nblk 4", "decode_gang", data, mb,
                  lambda dev: tsqx.decompress(packed, device=dev))
    view = tsqx.TsqxView(packed)
    words_calls = [(f"decompress_to_words {impl}", kernel,
                    lambda dev, impl=impl: pipeline.decompress_to_words(
                        stream, device=dev, impl=impl)[:2])
                   for impl, kernel in (("pallas", "decode_tokens"),
                                        ("stream", "decode_stream"))]
    words_calls.append(("tsqx.decode_to_words nblk 4", "decode_gang",
                        lambda dev: tsqx.decode_to_words(view, device=dev)))
    for name, kernel, call in words_calls:
        _words_timed(counts, name, kernel, data, mb, call)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        for name, call, want in (
                ("decompress", lambda: tsq.decompress(stream), data),
                ("compress level 1", lambda: tsq.compress(data, level=1),
                 stream)):
            out, ms, cores = _cpu_wall(lambda: _main_path(counts, call))
            check(out == want, f"phase11 {name} over {n_cards} cards")
            say("phase11", spread=name, cards=n_cards, exact=True,
                MBps=f"{mb / ms * 1e3:.1f}", host_cores=f"{cores:.2f}")
        for name, kernel, call in words_calls:
            def run(call=call):
                out = call(None)
                torch.cuda.synchronize()  # every card
                return out

            (words, sizes), ms, cores = _cpu_wall(
                lambda: _main_path(counts, run))
            check(len(words.shards) == n_cards,
                  f"phase11 {name}: {len(words.shards)} shards on "
                  f"{n_cards} cards")
            check(sorted(sh.device.index for sh in words.shards)
                  == list(range(n_cards)), f"phase11 {name}: shard devices")
            _words_exact(words, sizes, _blocks_of(data, sizes),
                         f"phase11 {name} over {n_cards} cards")
            del words
            say("phase11", spread=name, cards=n_cards, exact=True,
                words_on_card=True, MBps=f"{mb / ms * 1e3:.1f}",
                host_cores=f"{cores:.2f}")
    else:
        say("phase11", spread="every CUDA device", run=False,
            reason=f"{n_cards} CUDA device on this machine")
    del words_calls, view, packed
    _two_processes(data, stream, mb)


# --- phase 12: the contracts at scale ---------------------------------------

SCALE_BLOCKS = 256  # 1 GiB: the size at which the reference's wrap bug showed
_COMPRESS_CALLS = ((0, "scan"), (1, "scan"), (1, "bulk"), (1, "flat"),
                   (2, "scan"))
_DECODE_ROUTES = ("gang", "stream", "pallas", "bulk", "bulk2", "bulkn",
                  "xla")


def _first_diff(a: bytes, b: bytes) -> int:
    """The first offset at which ``a`` and ``b`` differ (the shorter one's
    length where it is a prefix of the other)."""
    n = min(len(a), len(b))
    ne = np.flatnonzero(np.frombuffer(a, np.uint8, n)
                        != np.frombuffer(b, np.uint8, n))
    return int(ne[0]) if ne.size else n


def _same_bytes(got: bytes, want: bytes, what: str) -> None:
    """Decoded bytes against the input; on a difference, the first byte,
    its 4 MiB block, the block's 32-block window and its offset there."""
    if got != want:
        off = _first_diff(got, want)
        raise SmokeFailure(
            f"{what}: differs from the input at byte {off} (block "
            f"{off >> 22}, window {(off >> 22) // 32}, offset "
            f"{off & (4 * MiB - 1)}; lengths {len(got)} / {len(want)})")


def _same_container(got: bytes, want: bytes, what: str) -> None:
    """A container against ``native.compress``'s; on a difference, the
    first block whose payload differs, its window and the payload byte."""
    if got == want:
        return
    from turbosqueeze_tpu_torch.format import iter_container

    for (b, p, e), (_, q, f) in zip(iter_container(got),
                                    iter_container(want)):
        if p != q or e != f:
            raise SmokeFailure(
                f"{what}: block {b} (window {b // 32}) payload differs from "
                f"native.compress's at byte {_first_diff(p, q)} "
                f"(payloads {len(p)} / {len(q)} bytes, ext {e} / {f})")
    raise SmokeFailure(f"{what}: container differs from native.compress's "
                       f"outside the payloads ({len(got)} / {len(want)})")


def _scale_compress(counts, data, dev) -> dict:
    """``data`` through every compress call on the card, each container
    byte-identical to ``native.compress``'s, the sizes in the reference's
    order. Returns the native containers by level."""
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native

    mb = len(data) / 1e6
    want = {}
    for level in (0, 1, 2):
        want[level], ms, cores = _cpu_wall(
            lambda: native.compress(data, True, level=level))
        say("scale", native_compress=level, MBps=f"{mb / ms * 1e3:.1f}",
            host_cores=f"{cores:.2f}")
    for level, emit in _COMPRESS_CALLS:
        torch.cuda.reset_peak_memory_stats()
        got, ms, cores = _cpu_wall(lambda: _main_path(
            counts, lambda: pipeline.compress(data, True, level=level,
                                              device=dev, emit_impl=emit)))
        _same_container(got, want[level], f"scale compress level {level} "
                        f"{emit}")
        say("scale", compress=emit, level=level, input_mb=f"{mb:.1f}",
            ratio=f"{len(got) / len(data):.4f}", exact=True,
            MBps=f"{mb / ms * 1e3:.1f}", host_cores=f"{cores:.2f}",
            peak_GiB=f"{torch.cuda.max_memory_allocated() / (1 << 30):.2f}")
        del got
    check(len(want[1]) <= len(want[0]) and len(want[2]) <= len(want[1]),
          f"scale: sizes out of order {[len(want[v]) for v in range(3)]}")
    return want


def _scale_decode(counts, data, streams, dev) -> None:
    """The level-1 container through every decode route, the file route,
    both words routes and TSQX at nblk 4; levels 0 and 2 through
    ``auto``; every output exactly the input."""
    import tempfile

    from turbosqueeze_tpu_torch import tsqx
    from turbosqueeze_tpu_torch.parallel import pipeline

    mb, stream = len(data) / 1e6, streams[1]

    def timed(name, call, **kv):
        out, ms, cores = _cpu_wall(lambda: _main_path(counts, call))
        say("scale", decode=name, exact=True, MBps=f"{mb / ms * 1e3:.1f}",
            host_cores=f"{cores:.2f}", **kv)
        return out

    for impl in _DECODE_ROUTES:
        _same_bytes(timed(impl, lambda: pipeline.decompress(
            stream, device=dev, impl=impl)), data, f"scale decode {impl}")
    for level in (0, 2):
        _same_bytes(timed("auto", lambda: pipeline.decompress(
            streams[level], device=dev), level=level), data,
            f"scale decode auto, level {level}")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        n = timed("decompress_to_file gang", lambda: pipeline.
                  decompress_to_file(stream, out, device=dev, impl="gang"))
        check(n == len(data), f"scale decompress_to_file: size {n}")
        _same_bytes(out.read_bytes(), data, "scale decompress_to_file")
    blocks = _blocks_of(data, [4 * MiB] * -(-len(data) >> 22))
    for impl in ("pallas", "stream"):
        words, sizes, _ = timed(f"decompress_to_words {impl}", lambda:
                                _synced(pipeline.decompress_to_words(
                                    stream, device=dev, impl=impl)))
        _words_exact(words, sizes, blocks, f"scale decompress_to_words "
                     f"{impl}", device=dev)
        del words
    t0 = time.perf_counter()
    packed = tsqx.pack(stream, nblk=4)
    say("scale", tsqx_pack_nblk=4, s=f"{time.perf_counter() - t0:.1f}",
        tsqx_mb=f"{len(packed) / 1e6:.1f}")
    _same_bytes(timed("tsqx nblk 4", lambda: tsqx.decompress(
        packed, device=dev)), data, "scale tsqx.decompress")
    words, sizes = timed("tsqx.decode_to_words nblk 4", lambda: _synced(
        tsqx.decode_to_words(tsqx.TsqxView(packed), device=dev)))
    _words_exact(words, sizes, blocks, "scale tsqx.decode_to_words",
                 device=dev)


def _synced(r):
    """``r`` once the card has finished the work that made it."""
    torch.cuda.synchronize()
    return r


def _scale_sweep(counts, dev) -> None:
    """Every class of ``ratio_sweep_files()``, the real files included,
    through every compress call on the card, ext on and off: each
    container ``native.compress``'s, the sizes in the reference's order."""
    from turbosqueeze_tpu_torch.parallel import pipeline
    from turbosqueeze_tpu_torch.runtime import native
    from turbosqueeze_tpu_torch.utils.corpus import ratio_sweep_files

    for name, data in ratio_sweep_files().items():
        for ext in (True, False):
            want = {level: native.compress(data, ext, level=level)
                    for level in (0, 1, 2)}
            for level, emit in _COMPRESS_CALLS:
                got = _main_path(counts, lambda: pipeline.compress(
                    data, ext, level=level, device=dev, emit_impl=emit))
                _same_container(got, want[level], f"sweep {name} ext {ext} "
                                f"level {level} {emit}")
            n = [len(want[level]) for level in (0, 1, 2)]
            check(n[1] <= n[0] and n[2] <= n[1],
                  f"sweep {name} ext {ext}: sizes out of order {n}")
            say("scale", sweep=name, ext=int(ext), input=len(data),
                level0=n[0], level1=n[1], level2=n[2], exact=True)


def phase12(counts, seed: int, n_blocks: int = SCALE_BLOCKS, dev=None):
    """The JAX package's format, ratio and mixed-boundary contracts on
    every device route, at 1 GiB: ``tests/gang_streams.py::scale_blocks``
    made from ``seed``, through every compress call (byte-identical to
    ``native.compress``, sizes in order, peak device memory), the level-1
    container through every decode, file, words and TSQX route (exactly
    the input), levels 0 and 2 through ``auto``, then the ratio sweep's
    classes at full size. ``dev``: the devices of every call (default
    every CUDA device)."""
    from gang_streams import scale_blocks

    t0 = time.perf_counter()
    data = scale_blocks(seed, n_blocks)
    say("scale", seed=seed, blocks=n_blocks, input_mb=f"{len(data) / 1e6:.1f}",
        build_s=f"{time.perf_counter() - t0:.1f}")
    streams = _scale_compress(counts, data, dev)
    _scale_decode(counts, data, streams, dev)
    del streams, data
    _scale_sweep(counts, dev)
    say("scale", seconds=f"{time.perf_counter() - t0:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    if not (REPO / "turbosqueeze_tpu_torch").is_dir():
        print("FAIL: run from the root of a checkout of the repository",
              flush=True)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]  # gang_streams
    t_start = time.perf_counter()
    name = phase0()
    errs = dict.fromkeys(KERNELS, 0)
    counts = dict.fromkeys(KERNELS, 0)
    timing = {}
    only = {  # [--ab ROOT...]: one family's kernels on the class blocks,
        # A/B against other checkouts' kernels
        "--emit-only": lambda others: (_emit_classes(errs, timing, others),
                                       _emit_windows(others),
                                       _decide_classes(others)),
        "--bulk-only": _bulk_classes,
        "--decode-only": lambda others: _decode_classes(
            others, _clocks_library() if "--clocks" in sys.argv else None)}
    args = sys.argv[1:]
    seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 1
    mode = next((a for a in args if a in only), None)
    if "--scale-only" in args:
        phase12(counts, seed)
        check(all(counts.values()),
              f"a kernel of the scale phase never launched: {counts}")
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if mode:
        roots = [a for a in args[args.index("--ab") + 1:]
                 if not a.startswith("--")] if "--ab" in args else []
        only[mode](_ab_libraries(map(Path, roots)) if roots else None)
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    phase1(errs)
    phase2(errs)
    data, streams = phase3(errs, counts, timing)
    phase4(errs, counts, timing)
    phase5(errs, timing)
    phase6(counts)
    phase7(errs, counts, timing, data, streams)
    phase8(errs, counts, timing, data, streams)
    phase9(errs, counts, timing, data)
    phase10(errs, counts, data, streams)
    phase11(counts, data, streams)
    del data, streams
    phase12(counts, seed)
    check(all(counts.values()),
          f"a kernel of the main path never launched: {counts}")
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    check(not loaded, f"the port loaded JAX: {loaded[:5]}")
    # no single PyTorch call decodes an LZ stream, parses or emits its
    # tokens, so no kernel has a library yardstick; each one's work is
    # bound by the bytes it reads and writes, far below the card's
    # operation rates
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[k], "max_abs_err": errs[k],
                "ms": round(timing[k][0], 4),
                "plain_ms": round(timing[k][1], 1),
                "bound_ms": round(timing[k][2] / HBM_BYTES_PER_MS, 6),
                "bound_by": "bytes", "library_ms": None}
               for k, (src, rep) in KERNELS.items()]
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
