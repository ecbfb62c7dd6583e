"""Builds the port's CUDA kernels into one shared library and binds it.

The kernels in ``csrc/`` export a plain C interface and include no
PyTorch header, so ``nvcc`` builds them in seconds and ``ctypes`` loads
the result. The library is built at first use, from the sources beside
this module only, and rebuilt whenever a source is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_gang.cu", "decode_stream.cu")
LIB_PATH = (Path(__file__).resolve().parents[2] / "build" / "cuda"
            / "libtsq_torch_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> str:
    """Compile the library if it is missing or older than a source.
    Returns the compiler's report (registers, spills per kernel), or ""
    when the library was already current."""
    srcs = [CSRC / s for s in SOURCES]
    newest = max(s.stat().st_mtime for s in srcs)
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        return ""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a reader never sees a partial file
    return r.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        P, I = ctypes.c_void_p, ctypes.c_int
        # lit, gang, gmeta, out, n_blocks, nblk, lit_rows, rec_rows,
        # out_rows, max_win, slot_recs, stream
        lib.tsq_decode_gang.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
        lib.tsq_decode_gang.restype = I
        # payload, meta, dict, out, n_blocks, pay_rows, out_rows,
        # dict_rows, stream
        lib.tsq_decode_stream.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.tsq_decode_stream.restype = I
        lib.tsq_cuda_error_string.argtypes = [I]
        lib.tsq_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        msg = library().tsq_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
