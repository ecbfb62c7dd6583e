"""Public blocking compress/decompress API with backend dispatch: the port
of ``turbosqueeze_tpu/runtime/api.py``.

Backends:
  * ``cuda``   — the device pipeline on the GPU (``parallel/pipeline.py``):
    compress and decode of ``.tsq`` containers run on the card; raises
    where there is no GPU (``device="cpu"`` runs the kernels' plain
    versions instead).
  * ``auto``   — the default: ``cuda``.
  * ``native`` — the C++ multithreaded host core (``runtime/native.py``),
    only when asked for by name.
  * ``oracle`` — the pure-Python exact codec (``reference_codec.py``),
    only when asked for by name.

``decompress`` also takes TSQX serving containers (``tsqx.py``), which
decode on the card only (``device="cpu"`` runs the gang kernel's plain
version): a host backend or a dictionary raises for them.
"""

from __future__ import annotations

from .. import reference_codec, tsqx
from ..format import FormatError
from ..parallel import pipeline
from . import native

_BACKENDS = ("auto", "cuda", "native", "oracle")


def _resolve(backend: str) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend: {backend!r}")
    return "cuda" if backend == "auto" else backend


def compress(data: bytes, ext: bool = True, backend: str = "auto",
             level: int = 0, dictionary: bytes = None, progress=None,
             device=None) -> bytes:
    """Compress bytes into a .tsq container, on the card unless
    ``backend`` names a host codec.

    ``level`` 0 reproduces the upstream greedy parse bit for bit; >= 1 are
    the exact candidate parses of the same format (>= 2 the lazy one).
    ``dictionary`` (<= 65532 bytes) is shared context virtually preceding
    every block, at level >= 1; both ends must use the same one.
    ``progress`` is called with ``(blocks_done, n_blocks)`` per block.
    ``device`` picks the devices each window's blocks spread over
    (default: every CUDA device; one device, ``"cpu"`` for the kernels'
    plain versions, or a sequence of devices); every backend's container
    is the same bytes.
    """
    b = _resolve(backend)
    if dictionary is not None:
        if b == "oracle":
            raise NotImplementedError(
                "dictionary mode needs the native or cuda backend")
        if b == "native":
            return native.compress_dict(data, dictionary, ext,
                                        level=max(level, 1),
                                        progress=progress)
        return pipeline.compress(data, ext, level=max(level, 1),
                                 device=device, dictionary=dictionary,
                                 progress=progress)
    if b == "cuda":
        return pipeline.compress(data, ext, level=level, device=device,
                                 progress=progress)
    if b == "oracle":
        return reference_codec.compress(data, ext)
    return native.compress(data, ext, level=level, progress=progress)


def decompress(stream: bytes, backend: str = "auto",
               dictionary: bytes = None, device=None,
               progress=None) -> bytes:
    """Decompress a .tsq container, on the card unless ``backend`` names a
    host codec. ``dictionary`` is the preset dictionary it was compressed
    with, if any. ``device`` picks the devices as in ``compress``; with
    several processes (``parallel.mesh.init_distributed``) rank 0 returns
    the bytes and the others ``b""``. ``progress`` is called with
    ``(blocks_done, n_blocks)`` per block (not for TSQX). On the card a
    ``.tsq`` container takes ``pipeline.decompress``'s ``"auto"`` route:
    the stream kernel parses each raw payload on a CUDA device, with no
    host resolve; on ``device="cpu"`` the host resolves each block for the
    gang kernel's plain version."""
    b = _resolve(backend)
    if tsqx.is_tsqx(stream):
        if dictionary is not None:
            raise FormatError("TSQX containers embed their context; "
                              "dictionary does not apply")
        if b != "cuda":
            raise ValueError(f"TSQX containers decode on the card only, "
                             f"not on backend {backend!r}")
        return tsqx.decompress(stream, device=device)
    if len(stream) < 16 or stream[:4] != b"TSQ1":
        raise FormatError("not a TSQ1 stream")
    if b == "cuda":
        return pipeline.decompress(stream, device=device,
                                   dictionary=dictionary, progress=progress)
    if b == "oracle":
        return reference_codec.decompress(stream, dictionary=dictionary)
    if dictionary is not None:
        return native.decompress_dict(stream, dictionary, progress=progress)
    return native.decompress(stream, progress=progress)
