"""The port's job engine (``turbosqueeze_tpu_torch/runtime/jobs.py``) on
the CPU: the cases of ``tests/test_jobs.py`` on an engine of the native
core (``backend="native"``) and on one of the device pipeline with the
kernels' plain versions (``device="cpu"``): callbacks, chaining, stress,
drain on close, in-band errors, per-block progress, file jobs.
"""

import threading

import pytest
import torch

from test_torch_host_copies import port_core
from turbosqueeze_tpu_torch.runtime import jobs as jobs_mod
from turbosqueeze_tpu_torch.runtime import native
from turbosqueeze_tpu_torch.runtime.jobs import JobEngine
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

ENGINES = {"native": {"backend": "native"}, "cpu": {"device": "cpu"}}


@pytest.fixture(scope="module")
def payloads():
    port_core()
    return [synthetic_text(20_000, seed=s) for s in range(4)]


@pytest.fixture(params=sorted(ENGINES))
def kw(request):
    return ENGINES[request.param]


def test_sync_roundtrip(payloads, kw):
    with JobEngine(**kw) as eng:
        for data in payloads:
            stream = eng.compress(data)
            assert stream == native.compress(data)
            assert eng.decompress(stream) == data


def test_async_callbacks(payloads, kw):
    events = []
    done = threading.Event()

    def on_complete(jobid, success):
        events.append((jobid, success))
        done.set()

    with JobEngine(**kw) as eng:
        job = eng.submit_compress(payloads[0], on_complete=on_complete)
        stream = job.result(timeout=60)
        assert done.wait(timeout=60)
    assert events == [(job.jobid, True)]
    assert stream[:4] == b"TSQ1"


def test_progress_reported(payloads, kw):
    fractions = []
    with JobEngine(**kw) as eng:
        job = eng.submit_compress(
            payloads[1], on_progress=lambda j, f: fractions.append(f))
        job.result(timeout=60)
    assert fractions[0] == 0.0 and fractions[-1] == 1.0


def test_async_chaining(payloads, kw):
    """A decompress job submitted from inside a compress job's completion
    callback: callbacks run on worker threads and must not wait on the
    jobs they spawn."""
    result = {}
    done = threading.Event()
    eng = JobEngine(n_workers=2, **kw)
    submitted = threading.Event()
    chained = threading.Event()

    def stage3(jobid, success):
        done.set()

    def stage2(jobid, success):
        assert success
        submitted.wait(30)  # the callback may outrun submit() returning
        result["dec"] = eng.submit_decompress(result["comp"].result(30),
                                              on_complete=stage3)
        chained.set()

    result["comp"] = eng.submit_compress(payloads[2], on_complete=stage2)
    submitted.set()
    assert done.wait(timeout=60)
    assert chained.wait(timeout=60)
    assert result["dec"].result(timeout=60) == payloads[2]
    eng.close()


def test_jobids_monotonic(payloads, kw):
    with JobEngine(**kw) as eng:
        jobs = [eng.submit_compress(payloads[0]) for _ in range(5)]
        ids = [j.jobid for j in jobs]
        assert ids == sorted(ids) and len(set(ids)) == 5
        for j in jobs:
            j.result(timeout=60)


def test_failure_in_band(kw):
    """A bad job reports success=False via its callback and keeps its
    error, without raising across the worker boundary."""
    events = []
    with JobEngine(**kw) as eng:
        job = eng.submit_decompress(
            b"NOT A TSQ STREAM" * 4,
            on_complete=lambda j, ok: events.append(ok))
        with pytest.raises(ValueError):
            job.result(timeout=60)
    assert events == [False]
    assert not job.success and isinstance(job.error, ValueError)


def test_massive_async(payloads):
    """200 compress jobs, then 200 decompress jobs, through one engine with
    more workers than this box has cores to spare."""
    with JobEngine(n_workers=16, backend="native") as eng:
        jobs = [eng.submit_compress(payloads[i % 4]) for i in range(200)]
        streams = [j.result(timeout=120) for j in jobs]
        decs = [eng.submit_decompress(s) for s in streams]
        outs = [d.result(timeout=120) for d in decs]
    assert all(outs[i] == payloads[i % 4] for i in range(200))
    assert [j.jobid for j in jobs + decs] == list(range(1, 401))


def test_concurrent_device_jobs(payloads):
    """Jobs on the device pipeline from eight threads at once give the
    native core's containers and bytes back."""
    with JobEngine(n_workers=8, device="cpu") as eng:
        jobs = [eng.submit_compress(payloads[i % 4], level=i % 2)
                for i in range(8)]
        streams = [j.result(timeout=120) for j in jobs]
        decs = [eng.submit_decompress(s) for s in streams]
        outs = [d.result(timeout=120) for d in decs]
    for i in range(8):
        assert streams[i] == native.compress(payloads[i % 4], level=i % 2)
        assert outs[i] == payloads[i % 4]


def test_file_jobs(tmp_path, payloads, kw):
    src, dst, back = tmp_path / "src", tmp_path / "out.tsq", tmp_path / "back"
    src.write_bytes(payloads[3])
    with JobEngine(**kw) as eng:
        eng.submit_compress(in_path=str(src), out_path=str(dst)).result(60)
        eng.submit_decompress(in_path=str(dst), out_path=str(back)).result(60)
    assert back.read_bytes() == payloads[3]
    assert dst.read_bytes() == native.compress(payloads[3])


def test_submit_validation():
    with JobEngine(backend="native") as eng:
        with pytest.raises(ValueError):
            eng.submit_compress()  # neither data nor path
        with pytest.raises(ValueError):
            eng.submit_compress(b"x", in_path="/nope")


def test_close_drains(payloads, kw):
    eng = JobEngine(**kw)
    jobs = [eng.submit_compress(payloads[0]) for _ in range(8)]
    eng.close()
    assert all(j.future.done() for j in jobs)
    with pytest.raises(RuntimeError):
        eng.submit_compress(payloads[0])


def test_jobs_compression_levels(payloads, kw):
    """The level flows through the engine; higher levels shrink
    compressible payloads and roundtrip exactly."""
    data = payloads[0] * 8
    with JobEngine(n_workers=2, **kw) as eng:
        s0 = eng.compress(data, level=0)
        s2 = eng.compress(data, level=2)
        assert eng.decompress(s0) == data
        assert eng.decompress(s2) == data
    assert len(s2) <= len(s0)


def test_per_block_progress_fractions(tmp_path):
    """Multi-block jobs report per-block fractions between the endpoints,
    in memory and file to file (the native file pipeline)."""
    data = synthetic_text(3 * (1 << 22) + 999, seed=81)  # 4 blocks
    fractions = []
    with JobEngine(backend="native") as eng:
        eng.submit_compress(
            data, on_progress=lambda j, f: fractions.append(f)).result(120)
    assert fractions[0] == 0.0 and fractions[-1] == 1.0
    assert len([f for f in fractions if 0.0 < f < 1.0]) >= 3
    assert fractions == sorted(fractions)

    src, dst, back = tmp_path / "in.bin", tmp_path / "out.tsq", tmp_path / "b"
    src.write_bytes(data)
    fr2, fr3 = [], []
    with JobEngine(backend="native") as eng:
        n = eng.submit_compress(
            in_path=str(src), out_path=str(dst),
            on_progress=lambda j, f: fr2.append(f)).result(120)
        assert n == dst.stat().st_size
        eng.submit_decompress(
            in_path=str(dst), out_path=str(back),
            on_progress=lambda j, f: fr3.append(f)).result(120)
    assert back.read_bytes() == data
    assert len([f for f in fr2 if 0.0 < f < 1.0]) >= 3
    assert len([f for f in fr3 if 0.0 < f < 1.0]) >= 3


def test_device_progress_per_block():
    """The device pipeline reports a fraction per block, in block order;
    the block count is the container's."""
    data = bytes(1 << 22) + bytes(5_000)  # two blocks, cheap on the CPU
    stream = native.compress(data)
    fr = []
    with JobEngine(device="cpu") as eng:
        assert eng.submit_decompress(
            stream, on_progress=lambda j, f: fr.append(f)).result(120) == data
    assert fr == [0.0, 0.5, 1.0, 1.0]


def test_device_jobs_without_a_gpu_fail_in_band(payloads, monkeypatch):
    """The default engine runs on the card: without one its jobs fail
    (in band) instead of falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not native.streaming_ok("auto")
    with JobEngine() as eng:
        job = eng.submit_compress(payloads[0])
        with pytest.raises(RuntimeError, match="CUDA"):
            job.result(timeout=60)
    assert not job.success
    assert jobs_mod.native.streaming_ok("native")
