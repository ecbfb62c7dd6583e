"""The port's entry points over two processes on the CPU: two ranks of
``turbosqueeze_tpu_torch.parallel._worker`` join a gloo process group on
localhost, each with ``device="cpu"``, and run the three-block level-1
container of ``test_torch_multidevice.py`` through ``decompress`` (gang,
xla: rank 0 gets the input, rank 1 ``b""``), ``decompress_to_file`` (each
rank writes its own blocks), ``compress(level=1)`` (``native.compress``'s
bytes on both ranks), TSQX at nblk 1 and 4, ranks that disagree on
``window_blocks`` (both raise ``ValueError``, in ``decompress`` and in
``decompress_to_words``) and the host-0 hop alone; and the five short
blocks of ``test_torch_sharded_words.py`` through ``decompress_to_words``
(pallas, stream) and ``tsqx.decode_to_words`` (nblk 1 and 2), each rank
holding exactly its own shards of the padded rows.
Each rank runs under a timeout and is killed when it expires. Tolerance:
equal bytes (the workers compare).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_host_copies import port_core
from test_torch_sharded_words import BLOCKS, STREAM
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

REPO = Path(__file__).resolve().parent.parent
OPS = ("decompress:gang", "decompress:xla", "file:gang", "compress:1",
       "tsqx:1", "tsqx:4", "mismatch", "hop", "words:pallas", "words:stream",
       "tsqx_words:1", "tsqx_words:2", "mismatch:words")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Each rank's JSON records, keyed (op, rank), after both ranks exit
    0; a rank past its timeout is killed, and its peer with it."""
    tmp = tmp_path_factory.mktemp("multihost")
    data = synthetic_text(2 * (4 << 20) + 300_000, seed=61)
    (tmp / "input.bin").write_bytes(data)
    (tmp / "input.tsq").write_bytes(port_core().compress(data, True,
                                                         level=1))
    (tmp / "words.tsq").write_bytes(STREAM)
    (tmp / "words.bin").write_bytes(b"".join(BLOCKS))
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "turbosqueeze_tpu_torch.parallel._worker",
         coordinator, "2", str(rank), str(tmp), "--device", "cpu",
         "--ops", ",".join(OPS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {err[-3000:]}"
    recs = {}
    for so, _ in outs:
        for line in so.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                recs[r["op"], r["rank"]] = r
    return recs


@pytest.mark.parametrize("op", OPS)
def test_both_ranks(records, op):
    """Each op ran on both ranks and passed the worker's check: the input
    on rank 0 and ``b""`` on rank 1 for a decode, the input in the file,
    ``native.compress``'s container on both ranks, ``ValueError`` on both
    for the mismatch."""
    for rank in range(2):
        assert records[op, rank]["ok"], (op, rank)


def test_hop_reports_its_rate(records):
    mbps = records["hop", 0]["MBps"]
    assert mbps > 0
    print(f"host-0 hop: {mbps:.1f} MB/s over gloo on localhost")
