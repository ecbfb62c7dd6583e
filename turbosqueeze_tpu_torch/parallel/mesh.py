"""The devices a decode spreads its blocks over.

Blocks are the unit of data parallelism, as in the JAX package's 1-D
``blocks`` mesh (``turbosqueeze_tpu/parallel/mesh.py``). The port runs in
one process; spreading one call's blocks over several cards and several
processes comes later.
"""

from __future__ import annotations

import torch


def block_devices(device=None) -> list:
    """The devices blocks decode on.

    ``None`` or ``"cuda"`` lists every CUDA device and raises when there is
    none: the port never falls back to the CPU unasked. A specific device
    (``"cuda:1"``, ``"cpu"``, a ``torch.device``) is returned alone; the
    CPU runs the kernels' plain versions.
    """
    if device is None or str(device) == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch decode on the host")
        return [torch.device("cuda", i) for i in range(n)]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but CUDA is not available")
    return [dev]


def pad_batch(n: int, multiple: int) -> int:
    """Blocks rounded up to a whole number of groups; pad with no-op
    blocks."""
    return -(-n // multiple) * multiple
