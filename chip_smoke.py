#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port's main path on one GPU and checks it.

The main path is device decode of ``.tsq`` containers
(``turbosqueeze_tpu_torch.decompress(stream, backend="cuda")``), which runs
two hand-written CUDA kernels: the gang-stream decoder and the raw-payload
stream decoder. Phases:

  0. the card; rebuild the native host core and build the CUDA kernels;
  1. the gang kernel against its plain PyTorch version, per
     (nblk, slot_recs), over mixed corpora and levels;
  2. the stream kernel against its plain version, ext on and off, and with
     a preset dictionary;
  3. end to end: a 256 MiB input (64 full blocks) compressed at levels 0,
     1 and 2, decoded through the public API, checked against the input
     and the native host decoder, and timed;
  4. the stream route end to end on a 64 MiB container.

Every kernel is held against its plain version at zero tolerance over the
bytes the format defines (each block's first ``size`` bytes). Any failure
raises and the script exits non-zero. The last lines are a JSON record of
the kernels and the device line. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

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
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _bytes_of(words, b: int, lo: int, n: int) -> bytes:
    """Bytes [lo, lo + n) of block b's decoded words."""
    return words[b].cpu().numpy().reshape(-1).view("u1")[lo:lo + n].tobytes()


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
    t0 = time.perf_counter()
    # build/ may hold a core built with -march=native for another CPU
    r = subprocess.run(["make", "-C", str(REPO / "csrc"), "-B", "-j8"],
                       capture_output=True, text=True)
    check(r.returncode == 0, f"native core build failed:\n{r.stderr}")
    native_s = time.perf_counter() - t0
    from turbosqueeze_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    cuda_s = time.perf_counter() - t0
    _build.library()
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
    from turbosqueeze_tpu.utils.corpus import synthetic_binary, synthetic_text

    base = synthetic_text(64 * 1024, seed=11)
    two_win = (base * ((3 * MiB) // len(base) + 1))[:2 * MiB + 200_000]
    datas = [synthetic_text(700_000, seed=41), bytes(300_000),
             synthetic_binary(500_000, seed=43),
             np.random.default_rng(7).bytes(400_000), two_win]
    return datas, (0, 1, 2, 0, 1)


def phase1(errs):
    """Gang kernel vs its plain version, on the card's and the host's
    copies of the same planes."""
    from turbosqueeze_tpu.runtime import native
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

    # garbage planes: records, sources and gmeta bounds anywhere; the
    # kernel must stay inside its planes (a fault would surface here)
    rng = np.random.default_rng(5)
    lw = rng.integers(-2**31, 2**31, (4, 16, 128), dtype=np.int32)
    gw = rng.integers(0, 2**32, (2, 64, 128), dtype=np.uint32)
    gm = rng.integers(0, 2**32, (2, 32), dtype=np.uint32)
    gm[0, 8:16] = rng.integers(0, 4, 8)
    gm[0, 16:22] = np.sort(rng.integers(0, 300, 6))  # some past the stream
    DG.decode_gang_batch(*planes_to_torch(lw, gw, gm, device="cuda"),
                         nblk=2, slot_recs=16, max_win=2)
    torch.cuda.synchronize()
    say("phase1", garbage_planes="no fault")


def phase2(errs):
    """Stream kernel vs its plain version, ext on/off and a dictionary."""
    from turbosqueeze_tpu.format import FormatError, iter_container
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu.utils.corpus import synthetic_text
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
    synthetic classes, each block cut from its class at its own offset."""
    from turbosqueeze_tpu.utils.corpus import (real_files, synthetic_binary,
                                               synthetic_text)

    blk = 4 * MiB
    pool = list(real_files().values()) + [
        synthetic_text(blk, seed=301), synthetic_binary(blk, seed=302), None,
        None]
    out = []
    for i in range(n_blocks):
        c = i % len(pool)
        if c == len(pool) - 2:
            out.append(bytes(blk))
        elif c == len(pool) - 1:
            out.append(np.random.default_rng(1000 + i).bytes(blk))
        else:
            src = pool[c]
            off = (i // len(pool)) * 523_123 % len(src)
            reps = (off + blk) // len(src) + 1
            out.append((src * reps)[off:off + blk])
    return b"".join(out)


def _main_path(counts, fn):
    """Runs ``fn`` as the main path: every kernel count is 0 just before,
    and the counts are read and added up just after."""
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels import decode_stream as DS

    DG.launches = DS.launches = 0
    r = fn()
    counts["decode_gang"] += DG.launches
    counts["decode_stream"] += DS.launches
    return r


def phase3(errs, counts, timing):
    import turbosqueeze_tpu_torch as tsq
    from turbosqueeze_tpu.format import scan_block_table
    from turbosqueeze_tpu.runtime import native
    from turbosqueeze_tpu_torch.kernels import decode_gang as DG
    from turbosqueeze_tpu_torch.kernels.decode_tokens import planes_to_torch
    from turbosqueeze_tpu_torch.parallel import pipeline

    data = _e2e_input(64)
    mb = len(data) / 1e6
    srecs = pipeline.GANG_SRECS[pipeline.GANG_NBLK]
    for level in (0, 1, 2):
        stream = native.compress(data, True, level=level)
        before = counts["decode_gang"]
        out = _main_path(counts, lambda: tsq.decompress(stream,
                                                        backend="cuda"))
        check(out == data, f"level {level}: port decode != input")
        check(out == native.decompress(stream),
              f"level {level}: port decode != native decode")
        check(counts["decode_gang"] > before,
              f"level {level}: the gang kernel never launched")
        e2e = [_host_ms(lambda: _main_path(
            counts, lambda: tsq.decompress(stream, backend="cuda")), 1)
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
        if level == 1:  # one full block at the main path's plane shapes
            blk = [t[:1] for t in dev[0]]
            blk_h = [t.cpu() for t in blk]
            size = planes[0][3][0]

            def gang(planes):
                return DG.decode_gang_batch(*planes, nblk=1, slot_recs=srecs)

            timing["decode_gang"] = (_cuda_ms(lambda: gang(blk), 5),
                                     _host_ms(lambda: gang(blk_h), 1))
            _compare(errs, "decode_gang", _bytes_of(gang(blk), 0, 0, size),
                     _bytes_of(gang(blk_h), 0, 0, size), data[:size],
                     "gang full block")
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


def phase4(errs, counts, timing):
    from turbosqueeze_tpu.format import scan_block_table
    from turbosqueeze_tpu.runtime import native
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

    # one full block at the main path's shapes: kernel vs plain version
    _, table = scan_block_table(stream)
    off, psz, ext = table[1]  # a text block
    size = stream[off] | stream[off + 1] << 8 | stream[off + 2] << 16
    planes = (DK.pack_payload_words(stream[off:off + psz])[None],
              DS.pack_meta([ext], [size]))
    blk = planes_to_torch(*planes, device="cuda")
    blk_h = planes_to_torch(*planes, device="cpu")
    timing["decode_stream"] = (
        _cuda_ms(lambda: DS.decode_stream_batch(*blk), 3),
        _host_ms(lambda: DS.decode_stream_batch(*blk_h), 1))
    _compare(errs, "decode_stream",
             _bytes_of(DS.decode_stream_batch(*blk), 0, 0, size),
             _bytes_of(DS.decode_stream_batch(*blk_h), 0, 0, size),
             data[4 * MiB:4 * MiB + size], "stream full block")
    say("phase4", input_mb=f"{mb:.1f}", exact=True,
        decode_MBps=f"{mb / e2e_ms * 1e3:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    if not (REPO / "turbosqueeze_tpu_torch").is_dir():
        print("FAIL: run from the root of a checkout of the repository",
              flush=True)
        return 1
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    name = phase0()
    errs = dict.fromkeys(KERNELS, 0)
    counts = dict.fromkeys(KERNELS, 0)
    timing = {}
    phase1(errs)
    phase2(errs)
    phase3(errs, counts, timing)
    phase4(errs, counts, timing)
    check(all(counts.values()),
          f"a kernel of the main path never launched: {counts}")
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    check(not loaded, f"the port loaded JAX: {loaded[:5]}")
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[k], "max_abs_err": errs[k],
                "ms": round(timing[k][0], 4),
                "plain_ms": round(timing[k][1], 1)}
               for k, (src, rep) in KERNELS.items()]
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
