"""The devices and processes a call spreads its blocks over.

Blocks are the unit of data parallelism, as in the JAX package's 1-D
``blocks`` mesh (``turbosqueeze_tpu/parallel/mesh.py``): independent 4 MiB
blocks shard over every local device of every process. A call's window of
``n`` blocks splits into ``S`` contiguous shards, ``S`` being the local
device count times the process count; process ``r`` owns shards
``[r * L, (r + 1) * L)`` of them, one on each of its ``L`` devices
(``shard_bounds``). The device-resident decodes pad their rows to a
whole number of equal shards instead (``padded_shards``) and return each
process's shards as a ``BlockShards``, the counterpart of the
reference's block-sharded ``jax.Array``. Processes join through
``init_distributed`` over ``torch.distributed`` on gloo: every byte that
crosses a process is host data, as the reference's coordination service
and ``process_allgather`` carry host data, and gloo, unlike NCCL, takes
two ranks on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

# a peer that fails or never arrives raises on the others after this long,
# where it would otherwise hang them
DIST_TIMEOUT = timedelta(seconds=300)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def block_devices(device=None) -> List[torch.device]:
    """The local devices blocks run on, one shard each.

    ``None`` or ``"cuda"`` lists every CUDA device and raises when there is
    none: the port never falls back to the CPU unasked. A specific device
    (``"cuda:1"``, ``"cpu"``, a ``torch.device``) is returned alone; the
    CPU runs the kernels' plain versions. A sequence of devices lists them
    in order, repeats allowed (``["cuda:0", "cuda:0"]`` is two shards on
    one card); a sequence that mixes the CPU and CUDA raises ``ValueError``.
    """
    if device is None or (not isinstance(device, (list, tuple))
                          and str(device) == "cuda"):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch decode on the host")
        return [torch.device("cuda", i) for i in range(n)]
    if not isinstance(device, (list, tuple)):
        return [_device(device)]
    if not device:
        raise ValueError("an empty sequence of devices")
    types = {torch.device(d).type for d in device}
    if len(types) > 1:
        raise ValueError(f"devices mix {sorted(types)}: a call runs all of "
                         f"its shards on one kind of device")
    return [_device(d) for d in device]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join this process to the others of a multi-process run.

    ``coordinator`` is rank 0's ``host:port``; ``None`` does nothing (one
    process), as in the JAX package. The process group is gloo over TCP,
    with ``DIST_TIMEOUT`` on every collective and transfer.
    """
    if coordinator is None:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=DIST_TIMEOUT)


def process_count() -> int:
    """Processes in the run: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """A window of ``n`` blocks split over ``n_shards`` shards: shard s
    gets blocks ``[s * k, min((s + 1) * k, n))``, ``k = ceil(n / n_shards)``,
    as the reference's leading-axis sharding of a padded batch does; the
    last shards may be empty."""
    k = -(-n // n_shards)
    return [(min(s * k, n), min((s + 1) * k, n)) for s in range(n_shards)]


def pad_batch(n: int, multiple: int) -> int:
    """Blocks rounded up to a whole number of groups; pad with no-op
    blocks."""
    return -(-n // multiple) * multiple


@dataclass(frozen=True)
class Shard:
    """One device's shard of a ``BlockShards``: global rows ``index`` of
    the result (a ``slice``, as ``jax.Array.addressable_shards[i].index[0]``
    gives), held in ``data`` on ``device``."""
    index: slice
    device: torch.device
    data: torch.Tensor


@dataclass(frozen=True)
class BlockShards:
    """A result sharded over the leading (block) axis of every local device
    of every process: the torch counterpart of a ``jax.Array`` under the
    reference's 1-D ``blocks`` sharding. ``shape`` is the global shape;
    ``shards`` holds this process's shards in global row order, one a
    local device (one shard covering every row on a single device in a
    single process)."""
    shape: Tuple[int, ...]
    shards: Tuple[Shard, ...]


def padded_shards(n: int, n_local: int) -> Tuple[int, List[slice]]:
    """The reference's padded batch of ``n`` rows over ``n_local`` devices
    in each process: ``(B, rows)``. With ``S = n_local * process_count()``
    shards of ``k = max(ceil(n / S), 1)`` rows each, ``B = k * S``
    (``pad_batch(n, S)``, at least ``S``); shard s holds global rows
    ``[s * k, (s + 1) * k)``, and ``rows`` are this process's shards
    ``[r * n_local, (r + 1) * n_local)``, one a local device in order.
    Rows past ``n`` are no-op padding."""
    n_shards = n_local * process_count()
    B = pad_batch(max(n, 1), n_shards)
    k, first = B // n_shards, process_index() * n_local
    return B, [slice(s * k, (s + 1) * k)
               for s in range(first, first + n_local)]
