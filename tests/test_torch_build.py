"""The port's CUDA kernel library loader (``turbosqueeze_tpu_torch/
kernels/_build.py``) without a compiler: ``library()`` builds and loads
once when many threads make the first kernel call at once, and
``build()`` holds the ``fcntl`` lock in the library's directory while it
checks and builds."""

import fcntl
import threading
import time

import pytest

from turbosqueeze_tpu_torch.kernels import _build


def test_first_library_call_from_eight_threads_builds_once(monkeypatch):
    builds, loads, lib = [], [], object()

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # every thread arrives while the build runs
        return ""

    def fake_load(path):
        loads.append(path)
        return lib

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(_build, "_lib", None)
    got, start = [], threading.Barrier(8)

    def first_call():
        start.wait(timeout=30)
        got.append(_build.library())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loads == [_build.LIB_PATH]
    assert len(got) == 8 and all(g is lib for g in got)


def test_build_holds_the_file_lock(tmp_path, monkeypatch):
    lib_path = tmp_path / "cuda" / "libtsq_torch_kernels.so"
    held = []

    def probe(csrc, path, flags):
        with open(path.parent / "build.lock", "w") as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        held.append((path, flags))
        return "report"

    monkeypatch.setattr(_build, "_build_locked", probe)
    assert _build.build(lib_path=lib_path, flags=("-DX",)) == "report"
    assert held == [(lib_path, ("-DX",))]
    with open(lib_path.parent / "build.lock", "w") as other:  # released
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)


def test_current_library_is_not_rebuilt(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for s in _build.SOURCES + _build.HEADERS:
        (csrc / s).write_text("// source\n")
    lib_path = tmp_path / "out" / "lib.so"
    lib_path.parent.mkdir()
    lib_path.write_bytes(b"")  # newer than every source: nothing to do
    assert _build.build(csrc, lib_path) == ""
