"""Builds the port's CUDA kernels into one shared library and binds it.

The kernels in ``csrc/`` export a plain C interface and include no
PyTorch header, so ``nvcc`` builds them in seconds and ``ctypes`` loads
the result. The library is built at first use, from the sources beside
this module only, and rebuilt whenever a source is newer than it. The
build holds an exclusive ``fcntl`` lock on ``build.lock`` beside the
library, so processes that start at once build it once, and publishes it
with ``os.replace``; ``library()`` checks, builds and loads under a
``threading.Lock``, so threads that make the first kernel call at once
build and load it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_bulk.cu", "decode_gang.cu", "decode_stream.cu",
           "decode_tokens.cu", "encode_bulk.cu", "encode_emit.cu",
           "encode_flat.cu")
HEADERS = ("decode_pairs.cuh", "decode_rows.cuh",
           "encode_parse.cuh")  # included by sources
LIB_PATH = (Path(__file__).resolve().parents[2] / "build" / "cuda"
            / "libtsq_torch_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_load_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(csrc: Path = CSRC, lib_path: Path = LIB_PATH,
          flags: tuple = ()) -> str:
    """Compile the library from the sources in ``csrc`` (with the extra
    nvcc ``flags``) if it is missing or older than a source. Returns the
    compiler's report (registers, spills per kernel), or "" when the
    library was already current. Holds an exclusive lock on
    ``build.lock`` in the library's directory while it checks and
    builds."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return _build_locked(csrc, lib_path, flags)


def _build_locked(csrc: Path, lib_path: Path, flags: tuple) -> str:
    srcs = [csrc / s for s in SOURCES]
    # another checkout (an A/B run's) may not have every header
    newest = max(f.stat().st_mtime for f in srcs + [csrc / h for h in HEADERS]
                 if f.exists())
    if lib_path.exists() and lib_path.stat().st_mtime >= newest:
        return ""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [lib_path.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    # one nvcc per source, all at once: the build time is the slowest
    # source's, not the sum
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o),
                               str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s, o in zip(srcs, objs)]
    report = []
    for s, p in zip(srcs, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name} ({p.returncode}):"
                               f"\n{err}")
        report.append(err)
    tmp = lib_path.with_name(f"{lib_path.name}.{tag}")
    r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                       capture_output=True, text=True)
    for o in objs:
        o.unlink()
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
    return "".join(report)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; safe from any
    thread."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _load_lock:
        if _lib is None:
            build()
            _lib = load(LIB_PATH)
        return _lib


def load(lib_path: Path) -> ctypes.CDLL:
    """A built kernel library, loaded and its entry points typed."""
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    # lit, gang, gmeta, out, n_blocks, nblk, lit_rows, rec_rows,
    # out_rows, max_win, slot_recs, stream
    lib.tsq_decode_gang.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    lib.tsq_decode_gang.restype = I
    # lit, rec, meta, out, n_blocks, nblk, lit_rows, rec_rows, out_rows,
    # max_win, meta_words, nwin_base, end_base, stream
    lib.tsq_decode_bulk.argtypes = [P, P, P, P, *[I] * 9, P]
    lib.tsq_decode_bulk.restype = I
    # input, side, rec, osz, out, n_blocks, in_rows, side_rows,
    # rec_rows, out_rows, max_win, stream
    lib.tsq_encode_assemble.argtypes = [P, P, P, P, P, *[I] * 6, P]
    lib.tsq_encode_assemble.restype = I
    # input, cand, nv, meta, side, rec, osz, n_blocks, in_rows,
    # cand_rows, side_rows, rec_rows, ext, stream
    lib.tsq_encode_decide.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.tsq_encode_decide.restype = I
    # input, cand, nv, meta, desc, stats, n_blocks, in_rows, cand_rows,
    # desc_rows, ext, stream
    lib.tsq_encode_flat_decide.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.tsq_encode_flat_decide.restype = I
    # payload, meta, dict, out, n_blocks, pay_rows, out_rows,
    # dict_rows, stream
    lib.tsq_decode_stream.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.tsq_decode_stream.restype = I
    # payload, tok_a, tok_b, out, n_blocks, n_chunks, pay_rows,
    # out_rows, stream
    lib.tsq_decode_tokens.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.tsq_decode_tokens.restype = I
    # input, cand, table, meta, out, osz, n_blocks, in_rows, cand_rows,
    # out_rows, ext, table_mode, stream
    lib.tsq_encode_emit.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.tsq_encode_emit.restype = I
    lib.tsq_cuda_error_string.argtypes = [I]
    lib.tsq_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        msg = library().tsq_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
