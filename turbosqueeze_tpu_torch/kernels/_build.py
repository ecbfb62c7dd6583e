"""Builds the port's CUDA kernels into one shared library and binds it.

The kernels in ``csrc/`` export a plain C interface and include no
PyTorch header, so ``nvcc`` builds them in seconds and ``ctypes`` loads
the result. The library is built at first use, from the sources beside
this module only, by the port's one library builder
(``utils/sharedlib.py``), and rebuilt whenever a source is newer than it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..utils import sharedlib

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


def _nvcc() -> list:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH")
    return [str(Path(CUDA_HOME) / "bin" / "nvcc")]


def build(csrc: Path = CSRC, lib_path: Path = LIB_PATH,
          flags: tuple = ()) -> str:
    """Compile the library from the sources in ``csrc`` (with the extra
    nvcc ``flags``) if it is missing or older than a source. Returns the
    compiler's report (registers, spills per kernel), or "" when the
    library was already current."""
    return sharedlib.build([csrc / s for s in SOURCES],
                           [csrc / h for h in HEADERS], lib_path, _nvcc,
                           (*NVCC_FLAGS, *flags), what="CUDA kernel")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; safe from any
    thread."""
    return sharedlib.load_once(globals(), build, lambda: load(LIB_PATH))


def load(lib_path: Path) -> ctypes.CDLL:
    """A built kernel library, loaded and its entry points typed."""
    P, I = ctypes.c_void_p, ctypes.c_int
    return sharedlib.bind(ctypes.CDLL(str(lib_path)), {
        # lit, gang, gmeta, out, n_blocks, nblk, lit_rows, rec_rows,
        # out_rows, max_win, slot_recs, stream
        "tsq_decode_gang": (I, [P, P, P, P, I, I, I, I, I, I, I, P]),
        # lit, rec, meta, out, n_blocks, nblk, lit_rows, rec_rows,
        # out_rows, max_win, meta_words, nwin_base, end_base, stream
        "tsq_decode_bulk": (I, [P, P, P, P, *[I] * 9, P]),
        # input, side, rec, osz, out, n_blocks, in_rows, side_rows,
        # rec_rows, out_rows, max_win, stream
        "tsq_encode_assemble": (I, [P, P, P, P, P, *[I] * 6, P]),
        # input, cand, nv, meta, side, rec, osz, n_blocks, in_rows,
        # cand_rows, side_rows, rec_rows, ext, stream
        "tsq_encode_decide": (I, [P] * 7 + [I] * 6 + [P]),
        # input, cand, nv, meta, desc, stats, n_blocks, in_rows,
        # cand_rows, desc_rows, ext, stream
        "tsq_encode_flat_decide": (I, [P] * 6 + [I] * 5 + [P]),
        # payload, meta, dict, out, n_blocks, pay_rows, out_rows,
        # dict_rows, stream
        "tsq_decode_stream": (I, [P, P, P, P, I, I, I, I, P]),
        # payload, tok_a, tok_b, out, n_blocks, n_chunks, pay_rows,
        # out_rows, stream
        "tsq_decode_tokens": (I, [P, P, P, P, I, I, I, I, P]),
        # input, cand, table, meta, out, osz, n_blocks, in_rows,
        # cand_rows, out_rows, ext, table_mode, stream
        "tsq_encode_emit": (I, [P, P, P, P, P, P, I, I, I, I, I, I, P]),
        "tsq_cuda_error_string": (ctypes.c_char_p, [I]),
    })


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        msg = library().tsq_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
