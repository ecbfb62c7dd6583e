"""turbosqueeze_tpu_torch — the `.tsq` codec's device layer in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port of ``turbosqueeze_tpu``'s device path, which stays the reference.
It shares that package's host modules that import no JAX — the container
format, the native C++ core (``turbosqueeze_tpu.runtime.native``, built
from ``csrc/``), the oracle codec and the corpora — and re-declares what
the JAX modules hold. Importing it never loads JAX.

Decode of a ``.tsq`` container runs on the card through two kernels in
``kernels/csrc/``: the gang-stream decoder (blocks the native core
resolves) and the raw-payload stream decoder (the fallback).
"""

__version__ = "0.1.0"

from turbosqueeze_tpu import format  # noqa: F401
from turbosqueeze_tpu.format import BLOCK_SZ, OUTPUT_SZ, FormatError  # noqa: F401

from .runtime.api import compress, decompress  # noqa: F401
