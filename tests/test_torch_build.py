"""The port's one library builder (``turbosqueeze_tpu_torch/utils/
sharedlib.py``) through both of its callers, the CUDA kernel library
(``kernels/_build.py``) and the host core (``runtime/native.py``): each
case runs once a library. A first call from many threads builds and
loads once; the build holds the ``fcntl`` lock in the library's
directory while it compiles; a current library is not rebuilt (the
guard on a run's set-up time) and a stale one is; processes that find no
library at once build it once and publish it whole; a failed build
raises with the compiler's output and publishes nothing.

No CUDA toolkit is needed: the kernel cases, and the core's cases that
check the steps, run a fake compiler (a Python script that logs its
command, checks the lock, and writes the file after ``-o``). The core's
multi-process and failed builds run the real ``g++``."""

import fcntl
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from turbosqueeze_tpu_torch.kernels import _build
from turbosqueeze_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parents[1]

FAKE_CC = r"""
import fcntl, os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_CC_LOG"], "a") as log:
    log.write(" ".join(args) + "\n")
if os.environ.get("FAKE_CC_LOCK"):
    with open(os.environ["FAKE_CC_LOCK"], "w") as other:
        try:
            fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
            sys.exit("the build lock is not held")
        except BlockingIOError:
            pass
if os.environ.get("FAKE_CC_FAIL") and "-shared" not in args:
    print("fatal error: no_such_header.h: No such file or directory")
    sys.exit(1)
time.sleep(float(os.environ.get("FAKE_CC_SLEEP", "0")))
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write("built\n")
print("ptxas info    : Used 32 registers,", os.path.basename(out))
"""


class Kernels:
    """The CUDA kernel library: ``_build.build`` and ``_build.library``."""

    what, name, sources = "CUDA kernel", "libtsq_torch_kernels.so", \
        _build.SOURCES
    module, first_use = _build, staticmethod(lambda: _build.library())
    script = """
import sys
from pathlib import Path
from turbosqueeze_tpu_torch.kernels import _build
_build._nvcc = lambda: [sys.executable, sys.argv[2]]
print(repr(_build.build(lib_path=Path(sys.argv[1]) / sys.argv[3])))
"""

    def __init__(self, monkeypatch, lib_path):
        self.mp, self.lib_path = monkeypatch, lib_path

    def use(self, cc):
        self.mp.setattr(_build, "_nvcc", lambda: cc)

    def build(self, flags=()):
        return _build.build(lib_path=self.lib_path, flags=flags)

    def fake_steps(self, build, load):
        self.mp.setattr(_build, "build", build)
        self.mp.setattr(_build, "load", load)
        return _build.LIB_PATH


class Core:
    """The host core: ``native.build`` and ``native._load``."""

    what, name, sources = "native core", "libtsq_core.so", native.SOURCES
    module, first_use = native, staticmethod(lambda: native._load())
    script = """
import sys
from pathlib import Path
from turbosqueeze_tpu_torch.runtime import native
native.LIB_PATH = Path(sys.argv[1]) / sys.argv[3]
native.CXXFLAGS = native.CXXFLAGS + tuple(sys.argv[4:])
print(native.build())
print(native.available())
"""

    def __init__(self, monkeypatch, lib_path):
        self.mp, self.lib_path = monkeypatch, lib_path
        monkeypatch.setattr(native, "LIB_PATH", lib_path)

    def use(self, cc):
        self.mp.setattr(native, "CXX", cc[0])
        self.mp.setattr(native, "CXXFLAGS", tuple(cc[1:]))

    def build(self, flags=()):
        self.mp.setattr(native, "CXXFLAGS", native.CXXFLAGS + flags)
        return native.build()

    def fake_steps(self, build, load):
        self.mp.setattr(native, "build", build)
        self.mp.setattr(native.ctypes, "CDLL", load)
        self.mp.setattr(native, "_bind", lambda lib: lib)
        return str(self.lib_path)


@pytest.fixture(params=[Kernels, Core], ids=["kernels", "core"])
def lib(request, tmp_path, monkeypatch):
    return request.param(monkeypatch, tmp_path / "out" / request.param.name)


@pytest.fixture
def fake_cc(tmp_path, monkeypatch):
    """The fake compiler's command and the log of its calls (one line a
    call)."""
    script, log = tmp_path / "fake_cc.py", tmp_path / "cc.log"
    script.write_text(FAKE_CC)
    log.write_text("")
    monkeypatch.setenv("FAKE_CC_LOG", str(log))
    return [sys.executable, str(script)], log


def _calls(log):
    return log.read_text().splitlines()


def test_first_library_call_from_eight_threads_builds_once(lib):
    builds, loads, loaded = [], [], object()

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # every thread arrives while the build runs
        return lib.lib_path

    def fake_load(path):
        loads.append(path)
        return loaded

    path = lib.fake_steps(fake_build, fake_load)
    lib.mp.setattr(lib.module, "_lib", None)
    got, start = [], threading.Barrier(8)

    def first_call():
        start.wait(timeout=30)
        got.append(lib.first_use())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loads == [path]
    assert len(got) == 8 and all(g is loaded for g in got)


def test_build_holds_the_file_lock(lib, fake_cc, monkeypatch):
    cc, log = fake_cc
    lib.use(cc)
    lock_path = lib.lib_path.parent / "build.lock"
    monkeypatch.setenv("FAKE_CC_LOCK", str(lock_path))  # each call checks
    lib.build(flags=("-DX",))
    calls = _calls(log)
    assert len(calls) == len(lib.sources) + 1 and "-shared" in calls[-1]
    assert all("-DX" in c for c in calls[:-1])
    with open(lock_path, "w") as other:  # released
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)


def test_current_library_is_not_rebuilt(lib, fake_cc):
    cc, log = fake_cc
    lib.use(cc)
    first = lib.build()
    n = len(_calls(log))
    assert n == len(lib.sources) + 1
    assert lib.lib_path.read_text() == "built\n"
    second = lib.build()  # current: nothing compiles
    assert len(_calls(log)) == n
    if isinstance(lib, Kernels):
        assert "registers" in first and second == ""
    else:
        assert first == second == lib.lib_path
    old = lib.lib_path.stat().st_mtime - 1e6  # older than every source
    os.utime(lib.lib_path, (old, old))
    lib.build()
    assert len(_calls(log)) == 2 * n


def test_build_locks_and_publishes_atomically(lib, fake_cc, tmp_path,
                                              monkeypatch):
    """Four processes that find no library at once build it once, under
    the lock, and each finds a whole library (the core's loads)."""
    cc, log = fake_cc
    monkeypatch.setenv("FAKE_CC_SLEEP", "0.2")
    out = lib.lib_path.parent
    out.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", lib.script, str(out),
                               cc[1], lib.name], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    if isinstance(lib, Core):  # the real compiler
        assert all(o.split() == [str(lib.lib_path), "True"]
                   for o, _ in outs)
    else:
        reports = sorted(o.strip() for o, _ in outs)
        assert reports[:3] == ["''"] * 3 and "registers" in reports[3]
        assert len(_calls(log)) == len(lib.sources) + 1
    assert sorted(f.name for f in out.iterdir()) == ["build.lock", lib.name]


def test_failed_build_raises_with_the_compiler_output(lib, fake_cc,
                                                      monkeypatch):
    out = lib.lib_path.parent
    if isinstance(lib, Core):  # the real compiler
        out.mkdir()
        r = subprocess.run([sys.executable, "-c", lib.script, str(out), "",
                            lib.name, "-DTSQ_NO_SUCH", "-include",
                            "no_such_header.h"],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        err = r.stderr
    else:
        lib.use(fake_cc[0])
        monkeypatch.setenv("FAKE_CC_FAIL", "1")
        with pytest.raises(RuntimeError) as e:
            lib.build()
        err = str(e.value)
    assert f"{lib.what} build failed" in err
    assert "no_such_header.h" in err
    assert sorted(f.name for f in out.iterdir()) == ["build.lock"]
