"""Job model and asynchronous submission: the port of
``turbosqueeze_tpu/runtime/jobs.py`` on the port's own ``api``.

Jobs carry file-or-memory endpoints, monotonically increasing job ids,
progress and completion callbacks, and an in-band error contract: a failed
job reports ``success=False`` through its callback and keeps its error in
its future; nothing raises across the worker boundary.

A host thread pool runs the jobs. The threads overlap: the native core
releases the GIL inside its calls, and the device pipeline waits on the
card. The default backend ``"auto"`` is the card (``device=`` picks the
devices as ``api.compress`` does, by default every CUDA device; ``"cpu"``
runs the kernels' plain versions); file-to-file jobs stream
through the native core's file pipeline only with ``backend="native"``
(``native.streaming_ok``).
"""

from __future__ import annotations

import os
import threading
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import api, native

ProgressFn = Callable[[int, float], None]    # (jobid, fraction_done)
CompletionFn = Callable[[int, bool], None]   # (jobid, success)


@dataclass
class Job:
    """One compression or decompression request.

    Exactly one of (data, in_path) is set; memory jobs return bytes via
    ``result()``, file jobs write to out_path.
    """
    jobid: int
    kind: str                      # "compress" | "decompress"
    data: Optional[bytes] = None
    in_path: Optional[str] = None
    out_path: Optional[str] = None
    ext: bool = True
    level: int = 0                 # 0 greedy (upstream-identical), 1
                                   # exact, >= 2 lazy
    on_progress: Optional[ProgressFn] = None
    on_complete: Optional[CompletionFn] = None
    future: Future = field(default_factory=Future)
    error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    @property
    def success(self) -> bool:
        return self.future.done() and self.future.exception() is None


class JobEngine:
    """Asynchronous job engine: submit returns at once; callbacks fire
    from worker threads; ``close()`` drains the jobs in flight."""

    def __init__(self, n_workers: int = 0, backend: str = "auto",
                 device=None, verbose: bool = False):
        if n_workers <= 0:
            n_workers = min(8, os.cpu_count() or 1)
        self._pool = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="tsq-job")
        self._backend = backend
        self._device = device
        self._verbose = verbose
        self._next_id = 1
        self._lock = threading.Lock()
        self._inflight = 0
        self._drained = threading.Condition(self._lock)
        self._closed = False

    # -- submission ---------------------------------------------------------

    def submit_compress(self, data: Optional[bytes] = None, *,
                        in_path: Optional[str] = None,
                        out_path: Optional[str] = None,
                        ext: bool = True, level: int = 0,
                        on_progress: Optional[ProgressFn] = None,
                        on_complete: Optional[CompletionFn] = None) -> Job:
        return self._submit("compress", data, in_path, out_path, ext, level,
                            on_progress, on_complete)

    def submit_decompress(self, data: Optional[bytes] = None, *,
                          in_path: Optional[str] = None,
                          out_path: Optional[str] = None,
                          on_progress: Optional[ProgressFn] = None,
                          on_complete: Optional[CompletionFn] = None) -> Job:
        return self._submit("decompress", data, in_path, out_path, True, 0,
                            on_progress, on_complete)

    # -- sync wrappers ------------------------------------------------------

    def compress(self, data: bytes, ext: bool = True, level: int = 0) -> bytes:
        return self.submit_compress(data, ext=ext, level=level).result()

    def decompress(self, data: bytes) -> bytes:
        return self.submit_decompress(data).result()

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            self._closed = True
            self._drained.wait_for(lambda: self._inflight == 0, timeout)
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ----------------------------------------------------------

    def _submit(self, kind, data, in_path, out_path, ext, level,
                on_progress, on_complete) -> Job:
        if (data is None) == (in_path is None):
            raise ValueError("exactly one of data / in_path must be given")
        with self._lock:
            if self._closed:
                raise RuntimeError("engine closed")
            jobid = self._next_id
            self._next_id += 1
            self._inflight += 1
        job = Job(jobid=jobid, kind=kind, data=data, in_path=in_path,
                  out_path=out_path, ext=ext, level=level,
                  on_progress=on_progress, on_complete=on_complete)
        self._pool.submit(self._run, job)
        return job

    def _execute(self, job: Job, per_block):
        """The job's work: its result (bytes, or for a streamed file job
        the output's byte count)."""
        if job.in_path is not None and job.out_path is not None \
                and native.streaming_ok(self._backend):
            # file-to-file jobs stream block windows through the native
            # file pipeline instead of reading the whole input
            if job.kind == "compress":
                return native.compress_file(job.in_path, job.out_path,
                                            job.ext, job.level,
                                            progress=per_block)
            return native.decompress_file(job.in_path, job.out_path,
                                          progress=per_block)
        if job.in_path is not None:
            with open(job.in_path, "rb") as f:
                data = f.read()
        else:
            data = job.data
        if job.kind == "compress":
            result = api.compress(data, ext=job.ext, backend=self._backend,
                                  level=job.level, progress=per_block,
                                  device=self._device)
        else:
            result = api.decompress(data, backend=self._backend,
                                    progress=per_block, device=self._device)
        if job.out_path is not None:
            with open(job.out_path, "wb") as f:
                f.write(result)
        return result

    def _run(self, job: Job) -> None:
        success = False
        try:
            per_block = None
            if job.on_progress:
                job.on_progress(job.jobid, 0.0)

                def per_block(done, total, job=job):
                    job.on_progress(job.jobid, done / max(total, 1))

            result = self._execute(job, per_block)
            if job.on_progress:
                job.on_progress(job.jobid, 1.0)
            success = True
            job.future.set_result(result)
        except Exception as e:  # noqa: BLE001 - the in-band error contract
            job.error = e
            job.future.set_exception(e)
            if self._verbose:
                traceback.print_exc()
        finally:
            try:
                if job.on_complete:
                    job.on_complete(job.jobid, success)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._drained.notify_all()
            if self._verbose:
                state = "ok" if success else "FAILED"
                print(f"[tsq] job {job.jobid} {job.kind} {state}")
