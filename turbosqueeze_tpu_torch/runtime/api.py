"""Public blocking compress/decompress API with backend dispatch: the port
of ``turbosqueeze_tpu/runtime/api.py``.

Backends:
  * ``cuda``   — the device pipeline on the GPU (``parallel/pipeline.py``):
    compress and decode of ``.tsq`` containers run on the card.
  * ``native`` — the shared C++ multithreaded host core.
  * ``oracle`` — the shared pure-Python exact codec.
  * ``auto``   — as in the JAX package: native if built, else oracle.

TSQX containers are not ported yet.
"""

from __future__ import annotations

from turbosqueeze_tpu.format import FormatError

from ..parallel import pipeline

_BACKENDS = ("auto", "cuda", "native", "oracle")


def _resolve(backend: str) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend: {backend!r}")
    if backend == "auto":
        from turbosqueeze_tpu.runtime import native

        return "native" if native.available() else "oracle"
    return backend


def compress(data: bytes, ext: bool = True, backend: str = "auto",
             level: int = 0, dictionary: bytes = None, progress=None,
             device=None) -> bytes:
    """Compress bytes into a .tsq container.

    ``level`` 0 reproduces the upstream greedy parse bit for bit; >= 1 are
    the exact candidate parses of the same format (>= 2 the lazy one).
    ``dictionary`` (<= 65532 bytes) is shared context virtually preceding
    every block, at level >= 1; both ends must use the same one.
    ``progress`` is called with ``(blocks_done, n_blocks)`` per block.
    ``device`` picks the card for ``backend='cuda'`` (default: the first
    CUDA device); every backend's container is the same bytes.
    """
    b = _resolve(backend)
    if dictionary is not None:
        if b == "oracle":
            raise NotImplementedError(
                "dictionary mode needs the native or cuda backend")
        if b == "native":
            from turbosqueeze_tpu.runtime import native

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
        from turbosqueeze_tpu import reference_codec

        return reference_codec.compress(data, ext)
    from turbosqueeze_tpu.runtime import native

    return native.compress(data, ext, level=level, progress=progress)


def decompress(stream: bytes, backend: str = "auto",
               dictionary: bytes = None, device=None,
               progress=None) -> bytes:
    """Decompress a .tsq container. ``dictionary`` is the preset
    dictionary it was compressed with, if any. ``device`` picks the card
    for ``backend='cuda'`` (default: the first CUDA device). ``progress``
    is called with ``(blocks_done, n_blocks)`` per block."""
    if len(stream) >= 4 and stream[:4] == b"TSQX":
        raise NotImplementedError("TSQX containers are not ported yet")
    if len(stream) < 16 or stream[:4] != b"TSQ1":
        raise FormatError("not a TSQ1 stream")
    b = _resolve(backend)
    if b == "cuda":
        return pipeline.decompress(stream, device=device,
                                   dictionary=dictionary, progress=progress)
    if dictionary is not None:
        if b == "oracle":
            from turbosqueeze_tpu import reference_codec

            return reference_codec.decompress(stream, dictionary=dictionary)
        from turbosqueeze_tpu.runtime import native

        return native.decompress_dict(stream, dictionary, progress=progress)
    if b == "oracle":
        from turbosqueeze_tpu import reference_codec

        return reference_codec.decompress(stream)
    from turbosqueeze_tpu.runtime import native

    return native.decompress(stream, progress=progress)
