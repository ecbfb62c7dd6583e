"""turbosqueeze_tpu_torch — the `.tsq` codec's device layer in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port of ``turbosqueeze_tpu``'s device path, which stays the reference.
It shares that package's host modules that import no JAX — the container
format, the native C++ core (``turbosqueeze_tpu.runtime.native``, built
from ``csrc/``), the oracle codec and the corpora — and re-declares what
the JAX modules hold. Importing it never loads JAX.

Compress and decode of a ``.tsq`` container run on the card
(``compress``/``decompress`` with ``backend="cuda"``), through three
kernels in ``kernels/csrc/``: the token emitter (level 0 with the
upstream's hash table, level 1 from phase-A candidates), the gang-stream
decoder (blocks the native core resolves) and the raw-payload stream
decoder (the fallback). Level >= 2 compress searches on the card and
parses on the host.
"""

__version__ = "0.1.0"

from turbosqueeze_tpu import format  # noqa: F401
from turbosqueeze_tpu.format import BLOCK_SZ, OUTPUT_SZ, FormatError  # noqa: F401

from .runtime.api import compress, decompress  # noqa: F401
