"""Public blocking compress/decompress API with backend dispatch: the port
of ``turbosqueeze_tpu/runtime/api.py``.

Backends:
  * ``cuda``   — device decode on the GPU (``parallel/pipeline.py``).
  * ``native`` — the shared C++ multithreaded host core.
  * ``oracle`` — the shared pure-Python exact codec.
  * ``auto``   — as in the JAX package: native if built, else oracle.

Compression is the native host core's job here, as the JAX package's
``auto`` makes it; device encode is not ported yet. TSQX containers and
preset dictionaries are not ported yet either.
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
             level: int = 0, dictionary: bytes = None) -> bytes:
    """Compress bytes into a .tsq container on the host.

    ``level`` 0 reproduces the upstream greedy parse bit for bit; >= 1 are
    the native core's better parses of the same format.
    """
    if dictionary is not None:
        raise NotImplementedError("preset dictionaries are not ported yet")
    b = _resolve(backend)
    if b == "cuda":
        raise NotImplementedError("device encode is not ported yet; use "
                                  "backend='native'")
    if b == "oracle":
        from turbosqueeze_tpu import reference_codec

        return reference_codec.compress(data, ext)
    from turbosqueeze_tpu.runtime import native

    return native.compress(data, ext, level=level)


def decompress(stream: bytes, backend: str = "auto",
               dictionary: bytes = None, device=None) -> bytes:
    """Decompress a .tsq container. ``device`` picks the card for
    ``backend='cuda'`` (default: the first CUDA device)."""
    if len(stream) >= 4 and stream[:4] == b"TSQX":
        raise NotImplementedError("TSQX containers are not ported yet")
    if len(stream) < 16 or stream[:4] != b"TSQ1":
        raise FormatError("not a TSQ1 stream")
    if dictionary is not None:
        raise NotImplementedError("preset dictionaries are not ported yet")
    b = _resolve(backend)
    if b == "cuda":
        return pipeline.decompress(stream, device=device)
    if b == "oracle":
        from turbosqueeze_tpu import reference_codec

        return reference_codec.decompress(stream)
    from turbosqueeze_tpu.runtime import native

    return native.decompress(stream)
