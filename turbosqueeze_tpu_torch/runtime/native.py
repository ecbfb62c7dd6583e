"""The port's own ctypes binding to the C++ host core (``csrc/``).

The host core is the one source the port shares with the JAX package: the
same ``csrc/*.cpp``, built by each package into its own directory. This
module builds its copy at first use into ``build/torch_core/`` (listed in
``.gitignore``) with the flags of ``csrc/Makefile`` through the port's one
library builder (``utils/sharedlib.py``), and rebuilds it when a source
is newer than the library.

It binds only what the port calls: the host codec (``compress``,
``decompress``, their dictionary forms, with ``progress=``, and the
numpy forms ``compress_array``, ``decompress_array``), the file
pipeline (``compress_file``, ``decompress_file``), the emission
helpers of device compress (``build_candidates``,
``encode_block_candidates``, ``encode_block_dict``), the tokenizer, and the
bulk resolver with its mergers (``bulk_prep``, ``bulk_merge2``,
``bulk_mergen``, ``bulk_gang``). Each returns the same bytes as
``turbosqueeze_tpu/runtime/native.py`` (``tests/test_torch_host_copies.py``).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from ..format import FormatError
from ..utils import sharedlib

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "csrc"
SOURCES = ("tsq_core.cpp", "tsq_runtime.cpp", "tsq_capi.cpp", "tsq_bulk.cpp",
           "tsq_gang.cpp")
HEADERS = ("tsq_core.h",)
LIB_PATH = REPO / "build" / "torch_core" / "libtsq_core.so"
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-march=native")  # csrc/Makefile

MAX_DICT = 65536 - 4
BULK_FALLBACK = -100  # stream too fragmented for the bulk formulation
_BULK_OVERFLOW = -101
_BULK_BAD_ARG = -102

_lib = None

PROGRESS_CFUNC = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.c_uint64)
_NULL_PROGRESS = PROGRESS_CFUNC()


# --- build and load ----------------------------------------------------------

def build(force: bool = False) -> Path:
    """Build the core if it is missing or older than a source (always,
    with ``force``). Returns the library's path; raises RuntimeError with
    the compiler's output when a step fails."""
    sharedlib.build([CSRC / s for s in SOURCES], [CSRC / h for h in HEADERS],
                    LIB_PATH, lambda: [CXX], CXXFLAGS, CXXFLAGS,
                    what="native core", force=force)
    return LIB_PATH


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, U64, U32, I, I64 = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                           ctypes.c_int, ctypes.c_int64)
    S = ctypes.c_char_p
    sigs = {
        "tsq_compress_bound": (ctypes.c_uint64, [U64]),
        "tsq_compress_mt": (I64, [P, U64, P, U64, I, U32, I]),
        "tsq_compress_mt_cb": (I64, [P, U64, P, U64, I, U32, I,
                                     PROGRESS_CFUNC, P]),
        "tsq_compress_mt_dict": (I64, [P, U64, P, U32, P, U64, I, I, U32,
                                       PROGRESS_CFUNC, P]),
        "tsq_decompressed_size": (I64, [S, U64]),
        "tsq_decompress_mt": (I64, [P, U64, P, U64, I]),
        "tsq_decompress_mt_cb": (I64, [P, U64, P, U64, I, PROGRESS_CFUNC, P]),
        "tsq_decompress_mt_dict": (I64, [P, U64, P, U32, P, U64, I,
                                         PROGRESS_CFUNC, P]),
        "tsq_compress_file_cb": (I64, [S, S, I, U32, I, PROGRESS_CFUNC, P]),
        "tsq_decompress_file_cb": (I64, [S, S, I, PROGRESS_CFUNC, P]),
        "tsq_build_candidates": (None, [S, U32, P]),
        "tsq_encode_block_candidates": (I64, [S, U32, P, P, I]),
        "tsq_encode_block_lazy": (I64, [S, U32, P, P, I, U32]),
        "tsq_encode_block_dict": (I64, [S, U32, U32, P, P, I, U32]),
        "tsq_tokenize_block": (I64, [S, U64, I, P, P, P, P, U64,
                                     ctypes.POINTER(ctypes.c_uint32), U32]),
        "tsq_bulk_prep": (I64, [S, U64, I, P, U64, P, U64, P]),
        "tsq_bulk_prep_dict": (I64, [S, U64, I, S, U32, P, U64, P, U64, P]),
        "tsq_bulk_merge2": (I64, [P, P, P, P, P, U64, P]),
        "tsq_bulk_mergen": (I64, [P, P, U32, P, U64, P]),
        "tsq_bulk_gang": (I64, [P, P, U32, U32, P, U64, P]),
    }
    return sharedlib.bind(lib, sigs)


def _load() -> ctypes.CDLL:
    """The bound core, built first if needed; safe from any thread."""
    return sharedlib.load_once(globals(), build,
                               lambda: _bind(ctypes.CDLL(str(LIB_PATH))))


def available() -> bool:
    """True once the core is built and loaded; a failed build raises."""
    return _load() is not None


def streaming_ok(backend: str) -> bool:
    """Whether file jobs of ``backend`` stream through the core's file
    pipeline (``compress_file``, ``decompress_file``). Only
    ``"native"`` does: the port's ``"auto"`` means the card, so unlike
    the JAX package's ``streaming_ok`` it never picks the host core for
    ``"auto"``. A failed build raises."""
    return backend == "native" and available()


# --- buffers and progress ----------------------------------------------------

# Decode sizes are exact (the container declares them), so the core writes
# straight into a fresh bytes object (refcount 1) instead of staging the
# whole output through numpy and copying it.
_py_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_py_new_bytes.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
_py_new_bytes.restype = ctypes.py_object
_py_bytes_ptr = ctypes.pythonapi.PyBytes_AsString
_py_bytes_ptr.argtypes = [ctypes.py_object]
_py_bytes_ptr.restype = ctypes.c_void_p
_py_resize_bytes = ctypes.pythonapi._PyBytes_Resize
_py_resize_bytes.argtypes = [ctypes.POINTER(ctypes.py_object),
                             ctypes.c_ssize_t]
_py_resize_bytes.restype = ctypes.c_int

_HUGE_MIN = 8 << 20       # advise only when it can span several 2 MiB pages
_HUGE_ALIGN = 2 << 20
_MADV_HUGEPAGE = 14       # linux uapi mman.h
_libc = None


def _advise_hugepages(ptr: int, n: int) -> None:
    """Best-effort madvise(MADV_HUGEPAGE) on the 2 MiB-aligned interior of
    [ptr, ptr + n): large fresh buffers then fault in far fewer pages."""
    global _libc
    if n < _HUGE_MIN or not ptr:
        return
    try:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        a0 = (ptr + _HUGE_ALIGN - 1) & ~(_HUGE_ALIGN - 1)
        ln = (ptr + n - a0) & ~(_HUGE_ALIGN - 1)
        if ln > 0:
            _libc.madvise(ctypes.c_void_p(a0), ctypes.c_size_t(ln),
                          _MADV_HUGEPAGE)
    except OSError:
        pass


def _alloc_exact_bytes(n: int):
    """Uninitialized bytes of length n plus its writable buffer address."""
    b = _py_new_bytes(None, n)
    ptr = _py_bytes_ptr(b)
    _advise_hugepages(ptr, n)
    return b, ptr


def _wrap_progress(progress):
    """python callable (done, total) -> (cfunc, keepalive). The core calls
    back from its worker threads with a monotone done count."""
    if progress is None:
        return _NULL_PROGRESS, None

    def trampoline(_ctx, done, total):
        try:
            progress(int(done), int(total))
        except Exception:  # noqa: BLE001 - a callback never raises into C
            pass

    cf = PROGRESS_CFUNC(trampoline)
    return cf, cf


def _check_dict(dictionary: bytes) -> None:
    if not 0 < len(dictionary) <= MAX_DICT:
        raise ValueError(f"dictionary must be 1..{MAX_DICT} bytes")


# --- the host codec ----------------------------------------------------------

def compress(data: bytes, ext: bool = True, level: int = 0,
             n_threads: int = 0, progress=None) -> bytes:
    """A ``.tsq`` container of ``data``, on all host cores."""
    lib = _load()
    bound = lib.tsq_compress_bound(len(data))
    # write into a bound-size bytes, then shrink it in place (``obj`` stays
    # the only reference until the shrink)
    obj = ctypes.py_object(_py_new_bytes(None, bound))
    out_ptr = _py_bytes_ptr(obj)
    _advise_hugepages(out_ptr, bound)
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_compress_mt_cb(data, len(data), out_ptr, bound,
                               1 if ext else 0, level, n_threads, cb, None)
    if n < 0:
        raise RuntimeError(f"native compress failed (code {n})")
    if _py_resize_bytes(ctypes.byref(obj), n) != 0:
        raise MemoryError("bytes resize failed")
    return obj.value


def decompress(stream: bytes, n_threads: int = 0, progress=None) -> bytes:
    """The bytes of a ``.tsq`` container, on all host cores."""
    lib = _load()
    size = lib.tsq_decompressed_size(stream, len(stream))
    if size < 0:
        raise FormatError(f"bad .tsq stream (code {size})")
    out, ptr = _alloc_exact_bytes(size)
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_decompress_mt_cb(stream, len(stream), ptr, size, n_threads,
                                 cb, None)
    if n < 0:
        raise FormatError(f"native decompress failed (code {n})")
    if n != size:
        raise FormatError(f"native decompress short ({n} != {size})")
    return out


def _ptr(arr: np.ndarray) -> ctypes.c_char_p:
    return ctypes.cast(arr.ctypes.data, ctypes.c_char_p)


def compress_array(arr: np.ndarray, ext: bool = True, level: int = 0,
                   n_threads: int = 0) -> np.ndarray:
    """A ``.tsq`` container of the uint8 array ``arr``, as a uint8 array:
    one native call on the array's own buffer; the result is a view of a
    fresh bound-size buffer, cut to the container."""
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    bound = lib.tsq_compress_bound(arr.nbytes)
    out = np.empty(bound, dtype=np.uint8)
    n = lib.tsq_compress_mt(_ptr(arr), arr.nbytes, _ptr(out), bound,
                            1 if ext else 0, level, n_threads)
    if n < 0:
        raise RuntimeError(f"native compress failed (code {n})")
    return out[:n]


def decompress_array(stream_arr: np.ndarray,
                     n_threads: int = 0) -> np.ndarray:
    """The bytes of the ``.tsq`` container in the uint8 array
    ``stream_arr``, as a uint8 array; FormatError on a bad stream."""
    lib = _load()
    stream_arr = np.ascontiguousarray(stream_arr, dtype=np.uint8)
    size = lib.tsq_decompressed_size(_ptr(stream_arr), stream_arr.nbytes)
    if size < 0:
        raise FormatError(f"bad .tsq stream (code {size})")
    out = np.empty(max(size, 1), dtype=np.uint8)
    n = lib.tsq_decompress_mt(_ptr(stream_arr), stream_arr.nbytes,
                              _ptr(out), size, n_threads)
    if n < 0:
        raise FormatError(f"native decompress failed (code {n})")
    return out[:n]


def compress_dict(data: bytes, dictionary: bytes, ext: bool = True,
                  n_threads: int = 0, level: int = 1,
                  progress=None) -> bytes:
    """Compress with a preset dictionary: shared context of up to 64 KiB
    virtually preceding every block."""
    lib = _load()
    _check_dict(dictionary)
    bound = lib.tsq_compress_bound(len(data))
    out = np.empty(bound, dtype=np.uint8)
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_compress_mt_dict(data, len(data), dictionary,
                                 len(dictionary), out.ctypes.data, bound,
                                 1 if ext else 0, n_threads, level, cb, None)
    if n < 0:
        raise RuntimeError(f"native dict compress failed (code {n})")
    return out[:n].tobytes()


def decompress_dict(stream: bytes, dictionary: bytes, n_threads: int = 0,
                    progress=None) -> bytes:
    lib = _load()
    _check_dict(dictionary)
    size = lib.tsq_decompressed_size(stream, len(stream))
    if size < 0:
        raise FormatError(f"bad .tsq stream (code {size})")
    out, ptr = _alloc_exact_bytes(size)
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_decompress_mt_dict(stream, len(stream), dictionary,
                                   len(dictionary), ptr, size, n_threads,
                                   cb, None)
    if n < 0:
        raise FormatError(f"native dict decompress failed (code {n})")
    if n != size:
        raise FormatError(f"native dict decompress short ({n} != {size})")
    return out


def compress_file(in_path, out_path, ext: bool = True, level: int = 0,
                  n_threads: int = 0, progress=None) -> int:
    """Compress the file ``in_path`` into a ``.tsq`` container at
    ``out_path``, streaming windows of blocks through the core (bounded
    memory on any input size). Returns the container's size."""
    lib = _load()
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_compress_file_cb(os.fsencode(in_path), os.fsencode(out_path),
                                 1 if ext else 0, level, n_threads, cb, None)
    if n < 0:
        raise RuntimeError(f"native file compress failed (code {n})")
    return n


def decompress_file(in_path, out_path, n_threads: int = 0,
                    progress=None) -> int:
    """Decompress the ``.tsq`` file ``in_path`` into ``out_path``, streaming
    windows of blocks through the core. Returns the decoded size."""
    lib = _load()
    cb, _keep = _wrap_progress(progress)
    n = lib.tsq_decompress_file_cb(os.fsencode(in_path),
                                   os.fsencode(out_path), n_threads, cb, None)
    if n < 0:
        raise FormatError(f"native file decompress failed (code {n})")
    return n


# --- emission helpers of device compress -------------------------------------

_PAYLOAD_CAP = (1 << 22) + (1 << 20) + 64


def build_candidates(block: bytes) -> np.ndarray:
    """Host hash-chain candidate array for one block (int32, -1 = none)."""
    lib = _load()
    cand = np.empty(len(block), dtype=np.int32)
    lib.tsq_build_candidates(block + bytes(8), len(block), cand.ctypes.data)
    return cand


def encode_block_candidates(block: bytes, cand, ext: bool,
                            level: int = 1) -> bytes:
    """One block payload from a candidate array: level 1 is the
    nearest-predecessor greedy parse, level >= 2 the lazy best-of-chain."""
    lib = _load()
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    if len(cand) != len(block):
        raise ValueError("candidate array length must equal block length")
    out = np.empty(_PAYLOAD_CAP, dtype=np.uint8)
    if level >= 2:
        psz = lib.tsq_encode_block_lazy(
            block + bytes(80), len(block), cand.ctypes.data,
            out.ctypes.data, 1 if ext else 0, level)
    else:
        psz = lib.tsq_encode_block_candidates(
            block + bytes(80), len(block), cand.ctypes.data,
            out.ctypes.data, 1 if ext else 0)
    if psz < 0:
        raise RuntimeError(f"candidate emission failed (code {psz})")
    return out[:psz].tobytes()


def encode_block_dict(block: bytes, dictionary: bytes, cand, ext: bool,
                      level: int = 1) -> bytes:
    """One block payload from candidates over concat(dictionary, block)."""
    lib = _load()
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    if len(cand) != len(dictionary) + len(block):
        raise ValueError("candidates must cover dictionary + block")
    out = np.empty(_PAYLOAD_CAP, dtype=np.uint8)
    psz = lib.tsq_encode_block_dict(
        dictionary + block + bytes(80), len(dictionary), len(block),
        cand.ctypes.data, out.ctypes.data, 1 if ext else 0, level)
    if psz < 0:
        raise RuntimeError(f"dict emission failed (code {psz})")
    return out[:psz].tobytes()


# --- decode preparation ------------------------------------------------------

def tokenize_block(payload: bytes, ext: bool, dict_len: int = 0):
    """Parse one block payload into token arrays (dst, src, len, lit, all
    int32) plus the uncompressed size. With ``dict_len`` positions lie in
    the dict-extended output space ``[0, dict_len + size)``."""
    lib = _load()
    max_tokens = (1 << 20) + 64  # about 1 token per 4 output bytes, + slack
    dst = np.empty(max_tokens, dtype=np.uint32)
    src = np.empty(max_tokens, dtype=np.uint32)
    ln = np.empty(max_tokens, dtype=np.uint16)
    lit = np.empty(max_tokens, dtype=np.uint8)
    size = ctypes.c_uint32(0)
    n = lib.tsq_tokenize_block(
        payload + bytes(64), len(payload), 1 if ext else 0,
        dst.ctypes.data, src.ctypes.data, ln.ctypes.data, lit.ctypes.data,
        max_tokens, ctypes.byref(size), dict_len)
    if n < 0:
        raise FormatError(f"tokenize failed (code {n})")
    return (dst[:n].astype(np.int32), src[:n].astype(np.int32),
            ln[:n].astype(np.int32), lit[:n].astype(np.int32),
            int(size.value))


def bulk_prep(payload: bytes, ext: bool, dictionary: bytes = None):
    """Resolve one block payload into the bulk-decode planes
    (``csrc/tsq_bulk.cpp``): the compacted literal bytes, the row-grouped
    record stream and the 8 meta words (size, windows, literal bytes,
    record words, window boundaries). Returns (lit u8[], rec u32[],
    meta u32[8]); None when the stream is too fragmented for the bulk
    formulation (decode that block with the stream parser instead). With
    ``dictionary`` the planes cover the dict-extended output space
    ``[0, dict_len + size)``. Raises FormatError on a malformed payload."""
    lib = _load()
    padded = payload + bytes(64)
    size = (payload[0] | (payload[1] << 8) | (payload[2] << 16)
            if len(payload) >= 3 else 0)
    dlen = len(dictionary) if dictionary else 0
    lit = np.empty(dlen + size + 64, dtype=np.uint8)
    meta = np.zeros(8, dtype=np.uint32)
    # about 0.5 record words per payload byte on level-0 text: 2 words a
    # byte makes the re-parsing overflow retry a cold path
    rec_cap = max(1 << 19, 2 * len(payload))
    while True:
        rec = np.empty(rec_cap, dtype=np.uint32)
        if dlen:
            n = lib.tsq_bulk_prep_dict(
                padded, len(payload), 1 if ext else 0, dictionary, dlen,
                lit.ctypes.data, lit.shape[0], rec.ctypes.data, rec_cap,
                meta.ctypes.data)
        else:
            n = lib.tsq_bulk_prep(
                padded, len(payload), 1 if ext else 0, lit.ctypes.data,
                lit.shape[0], rec.ctypes.data, rec_cap, meta.ctypes.data)
        if n == _BULK_OVERFLOW and rec_cap < (1 << 24):
            rec_cap *= 4
            continue
        break
    if n in (BULK_FALLBACK, _BULK_OVERFLOW):
        return None
    if n < 0:
        raise FormatError(f"bulk prep failed (code {n})")
    return lit[:int(meta[2])], rec[:int(n)], meta


def _u32(arrays):
    return [np.ascontiguousarray(a, dtype=np.uint32) for a in arrays]


def bulk_merge2(rec_a, meta_a, rec_b, meta_b):
    """Zip two blocks' record streams into one strictly alternating stream.
    Returns (merged u32[], meta2 u32[8]): sizes [0..1], windows [2..3],
    merged window boundaries [4..7]."""
    lib = _load()
    rec_a, meta_a, rec_b, meta_b = _u32((rec_a, meta_a, rec_b, meta_b))
    cap = 2 * (len(rec_a) + len(rec_b)) + 4096
    out = np.empty(cap, dtype=np.uint32)
    meta2 = np.zeros(8, dtype=np.uint32)
    n = lib.tsq_bulk_merge2(rec_a.ctypes.data, meta_a.ctypes.data,
                            rec_b.ctypes.data, meta_b.ctypes.data,
                            out.ctypes.data, cap, meta2.ctypes.data)
    if n < 0:
        raise RuntimeError(f"bulk merge failed (code {n})")
    return out[:int(n)], meta2


def bulk_mergen(recs, metas):
    """Zip N (1..4) blocks' record streams into one strictly round-robin
    stream, exhausted members padded with empty entries. Returns
    (merged u32[], metan u32[16]): sizes [0..3], windows [4..7], merged
    window boundaries [8..15] ([8] = 0)."""
    lib = _load()
    nblk = len(recs)
    if not 1 <= nblk <= 4 or len(metas) != nblk:
        raise ValueError(f"bulk_mergen takes 1..4 streams and as many "
                         f"metas, got {nblk} and {len(metas)}")
    recs, metas = _u32(recs), _u32(metas)
    cap = 2 * sum(len(r) for r in recs) + 4096
    out = np.empty(cap, dtype=np.uint32)
    metan = np.zeros(16, dtype=np.uint32)
    rp = (ctypes.c_void_p * nblk)(*[r.ctypes.data for r in recs])
    mp = (ctypes.c_void_p * nblk)(*[m.ctypes.data for m in metas])
    n = lib.tsq_bulk_mergen(rp, mp, nblk, out.ctypes.data, cap,
                            metan.ctypes.data)
    if n < 0:
        raise RuntimeError(f"bulk mergen failed (code {n})")
    return out[:int(n)], metan


def bulk_gang(recs, metas, slot_recs: int = 8):
    """Re-shape N (1..8) blocks' record streams into the fixed-geometry
    gang stream (``csrc/tsq_gang.cpp``). Returns (gang u32[],
    gmeta u32[32]): sizes [0..7], windows [8..15], per-window U/W segment
    round boundaries [16..21], total rounds [30], nblk [31]."""
    lib = _load()
    nblk = len(recs)
    if not 1 <= nblk <= 8 or len(metas) != nblk:
        raise ValueError(f"bulk_gang takes 1..8 streams and as many metas, "
                         f"got {nblk} and {len(metas)}")
    recs, metas = _u32(recs), _u32(metas)
    # worst case: one block holds every entry (the others pad with null
    # gangs), entries as short as one record each
    cap = nblk * 4 * max(max(len(r) for r in recs), 64) + 64 * nblk * 16
    rp = (ctypes.c_void_p * nblk)(*[r.ctypes.data for r in recs])
    mp = (ctypes.c_void_p * nblk)(*[m.ctypes.data for m in metas])
    for _ in range(3):
        out = np.empty(cap, dtype=np.uint32)
        _advise_hugepages(out.ctypes.data, out.nbytes)
        gmeta = np.zeros(32, dtype=np.uint32)
        n = lib.tsq_bulk_gang(rp, mp, nblk, slot_recs, out.ctypes.data, cap,
                              gmeta.ctypes.data)
        if n >= 0:
            return out[:int(n)], gmeta
        if n == _BULK_BAD_ARG:
            raise ValueError(f"bulk_gang invalid arguments (nblk={nblk}, "
                             f"slot_recs={slot_recs}, code {n})")
        if n != _BULK_OVERFLOW:
            break
        cap *= 2
    raise RuntimeError(f"bulk gang merge failed (code {n})")
