"""turbosqueeze_tpu_torch — the `.tsq` codec's device layer in PyTorch, with
hand-written CUDA kernels for Hopper (H100).

The port of ``turbosqueeze_tpu``'s device path, which stays the reference.
It imports nothing of that package: it keeps its own copies of the host
modules it needs (``format``, ``reference_codec``, ``utils/corpus``) and
its own binding to the C++ host core (``runtime/native.py``, built from
the shared ``csrc/`` into ``build/torch_core/``). Importing it never loads
JAX.

``compress`` and ``decompress`` run on the card by default
(``backend="auto"`` is ``"cuda"``): compress through the token emitter,
decode through the gang-stream, bulk record-stream, raw-payload stream and
token-chunk decoders, hand-written CUDA kernels in ``kernels/csrc/``. The
host codecs run only when asked for by name (``backend="native"`` or
``"oracle"``).
"""

__version__ = "0.1.0"

from . import format  # noqa: F401
from .format import BLOCK_SZ, OUTPUT_SZ, FormatError  # noqa: F401

from .runtime.api import compress, decompress  # noqa: F401
