"""tsq command-line interface of the port: the verbs of
``turbosqueeze_tpu/cli.py`` on the card. Run as

    python -m turbosqueeze_tpu_torch.cli [options] <verb> ...

Verbs:
    c <input> <output> [--no-ext] [--level N] [--dict F]   compress
    d <input> <output> [--dict F]        decompress a .tsq or TSQX file
    b [input] [--size MiB]               time compress and decompress
    x <file.tsq> <file.tsqx> [--nblk N]  pack to the TSQX serving profile
    info <file.tsq> [--blocks]           container inspection
    verify <input> <file.tsq>            roundtrip check
Options: --backend {auto,cuda,native,oracle} (``auto`` is the card),
--device (default: every CUDA device, a shard of each window's blocks on
each; ``cpu`` runs the kernels' plain versions; a comma-separated list
such as ``cuda:0,cuda:1`` names the devices), --threads N (host threads of
the native core and of ``x``).

``c`` and ``d`` with ``--backend native`` and no dictionary stream the
file through the native core's windowed file pipeline; ``d`` on the card
writes each block at its 4 MiB offset (``pipeline.decompress_to_file``).
``d`` on a TSQX file decodes on the card and refuses ``--dict`` or a host
``--backend`` (exit 1), where the JAX package's CLI drops both.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _human(n: float) -> str:
    return f"{n / 1e6:,.1f} MB"


def _read_dict(args):
    if getattr(args, "dict", None):
        with open(args.dict, "rb") as f:
            return f.read()
    return None


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def cmd_compress(args) -> int:
    from .runtime import native
    from .runtime.api import compress

    t0 = time.perf_counter()
    dictionary = _read_dict(args)
    in_size = os.path.getsize(args.input)
    if dictionary is None and native.streaming_ok(args.backend):
        # block windows stream through the native file pipeline: bounded
        # memory on any input size
        out_size = native.compress_file(args.input, args.output,
                                        not args.no_ext, args.level,
                                        args.threads)
    else:
        stream = compress(_read(args.input), ext=not args.no_ext,
                          backend=args.backend, level=args.level,
                          dictionary=dictionary, device=args.device)
        _write(args.output, stream)
        out_size = len(stream)
    dt = time.perf_counter() - t0
    print(f"{_human(in_size)} -> {_human(out_size)} "
          f"({100.0 * out_size / max(in_size, 1):.2f}%) "
          f"in {dt:.2f}s ({in_size / 1e6 / dt:,.0f} MB/s)")
    return 0


def cmd_pack(args) -> int:
    """.tsq -> TSQX: the host resolve runs once here, so a decode of the
    result is a file read, an upload and the gang kernel."""
    from . import tsqx

    t0 = time.perf_counter()
    packed = tsqx.pack(_read(args.input), nblk=args.nblk,
                       threads=args.threads or None)
    _write(args.output, packed)
    dt = time.perf_counter() - t0
    print(f"{_human(os.path.getsize(args.input))} -> {_human(len(packed))} "
          f"TSQX in {dt:.2f}s")
    return 0


def cmd_decompress(args) -> int:
    from . import tsqx
    from .parallel import pipeline
    from .runtime import native
    from .runtime.api import decompress

    t0 = time.perf_counter()
    dictionary = _read_dict(args)
    in_size = os.path.getsize(args.input)
    with open(args.input, "rb") as f:
        packed = tsqx.is_tsqx(f.read(4))
    if not packed and dictionary is None and native.streaming_ok(
            args.backend):
        out_size = native.decompress_file(args.input, args.output,
                                          args.threads)
    elif not packed and args.backend in ("auto", "cuda"):
        out_size = pipeline.decompress_to_file(
            _read(args.input), args.output, device=args.device,
            dictionary=dictionary)
    else:  # a host backend, or TSQX: the API refuses a dictionary or a
        # host backend for it
        data = decompress(_read(args.input), backend=args.backend,
                          dictionary=dictionary, device=args.device)
        _write(args.output, data)
        out_size = len(data)
    dt = time.perf_counter() - t0
    print(f"{_human(in_size)} -> {_human(out_size)} "
          f"in {dt:.2f}s ({out_size / 1e6 / dt:,.0f} MB/s)")
    return 0


def cmd_bench(args) -> int:
    """Times compress and decompress (wall clock, host to host) over a
    file or synthetic text, ext off and on."""
    from .runtime.api import compress, decompress

    if args.input:
        data = _read(args.input)
        name = args.input
    else:
        from .utils.corpus import synthetic_text

        size = args.size << 20
        data = synthetic_text(size, seed=1234)
        name = f"synthetic-text[{size >> 20} MiB]"
    for ext in (False, True):
        t0 = time.perf_counter()
        stream = compress(data, ext=ext, backend=args.backend,
                          device=args.device)
        t1 = time.perf_counter()
        out = decompress(stream, backend=args.backend, device=args.device)
        t2 = time.perf_counter()
        ok = out == data
        print(f"{name} ext={int(ext)}: "
              f"compress {len(data) / 1e6 / (t1 - t0):,.0f} MB/s, "
              f"decompress {len(data) / 1e6 / (t2 - t1):,.0f} MB/s, "
              f"ratio {100.0 * len(stream) / max(len(data), 1):.2f}%, "
              f"roundtrip {'OK' if ok else 'FAIL'}")
        if not ok:
            return 1
    return 0


def cmd_info(args) -> int:
    from .format import CONTAINER_HEADER_SZ, scan_block_table

    stream = _read(args.input)
    hdr, table = scan_block_table(stream)
    payload = sum(sz for _, sz, _ in table)
    print(f"TSQ1 container: {hdr.n_blocks} blocks, "
          f"{hdr.total_size:,} bytes uncompressed, "
          f"{len(stream):,} bytes compressed "
          f"({100.0 * len(stream) / max(hdr.total_size, 1):.2f}%)")
    ext_blocks = sum(1 for _, _, ext in table if ext)
    print(f"extensions: {ext_blocks}/{hdr.n_blocks} blocks; "
          f"payload {payload:,} B; overhead "
          f"{len(stream) - payload - CONTAINER_HEADER_SZ:,} B headers")
    if args.blocks:
        for b, (off, sz, ext) in enumerate(table):
            print(f"  block {b}: offset {off:,}, {sz:,} B, ext={int(ext)}")
    return 0


def cmd_verify(args) -> int:
    from .runtime.api import decompress

    out = decompress(_read(args.tsq), backend=args.backend,
                     device=args.device)
    if out == _read(args.input):
        print("OK: bit-exact roundtrip")
        return 0
    print("MISMATCH")
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tsq",
        description="Turbosqueeze on the GPU: .tsq compression in PyTorch "
                    "and CUDA")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "native", "oracle"])
    p.add_argument("--device", default=None,
                   type=lambda v: v.split(",") if "," in v else v,
                   help="devices, comma-separated (default: every CUDA "
                        "device); 'cpu' runs the kernels' plain versions")
    p.add_argument("--threads", type=int, default=0)
    sub = p.add_subparsers(dest="verb", required=True)

    pc = sub.add_parser("c", help="compress")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--no-ext", action="store_true")
    pc.add_argument("--level", type=int, default=0,
                    help="0 = upstream-parity parse; 1 = exact candidate "
                         "parse; 2 = lazy best-of-chain (best ratio); "
                         "3/4 = lazy with capped chain walks")
    pc.add_argument("--dict", help="preset dictionary file (<= 64 KiB)")
    pc.set_defaults(fn=cmd_compress)

    pd = sub.add_parser("d", help="decompress a .tsq or TSQX file")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--dict", help="preset dictionary used at compression")
    pd.set_defaults(fn=cmd_decompress)

    pb = sub.add_parser("b", help="benchmark")
    pb.add_argument("input", nargs="?", default=None)
    pb.add_argument("--size", type=int, default=64, help="synthetic MiB")
    pb.set_defaults(fn=cmd_bench)

    px = sub.add_parser("x", help="pack .tsq -> TSQX (serving profile)")
    px.add_argument("input")
    px.add_argument("output")
    px.add_argument("--nblk", type=int, default=4,
                    help="gang co-schedule width (1..8; default 4)")
    px.set_defaults(fn=cmd_pack)

    pi = sub.add_parser("info", help="inspect a .tsq container")
    pi.add_argument("input")
    pi.add_argument("--blocks", action="store_true")
    pi.set_defaults(fn=cmd_info)

    pv = sub.add_parser("verify", help="verify a .tsq against its source")
    pv.add_argument("input")
    pv.add_argument("tsq")
    pv.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, RuntimeError) as e:  # FormatError too
        print(f"tsq: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
