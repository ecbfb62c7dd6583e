"""The one builder and loader of the port's two shared libraries, the CUDA
kernels (``kernels/_build.py``) and the host core (``runtime/native.py``).

A library is rebuilt when it is missing or older than any of its sources
and headers that exist. The check and the build hold an exclusive
``fcntl`` lock on ``build.lock`` beside the library, so processes that
start at once build it once; one compiler runs per source, all at once;
the link goes to a name tagged with the process id and is published by
``os.replace``, so a reader never loads a partial file. A failed step
raises with the compiler's output and publishes nothing. ``load_once``
loads under a ``threading.Lock``, so threads that make the first call at
once load the library once.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Sequence

_load_locks: dict = {}


def build(sources: Sequence[Path], headers: Sequence[Path], lib_path: Path,
          compiler: Callable[[], List[str]], cflags: Sequence[str],
          ldflags: Sequence[str] = (), *, what: str,
          force: bool = False) -> str:
    """Compile ``sources`` with ``compiler() + cflags`` and link them with
    ``compiler() + ldflags`` into ``lib_path`` unless it is current (always
    with ``force``); ``compiler`` is asked for its command only then.
    Returns the compilers' output, "" when the library was current."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        stamps = [f.stat().st_mtime for f in (*sources, *headers)
                  if f.exists()]
        if not force and lib_path.exists() and \
                lib_path.stat().st_mtime >= max(stamps, default=0):
            return ""
        cc, tag = compiler(), f"{os.getpid()}.tmp"
        objs = [lib_path.with_name(f"{s.stem}.{tag}.o") for s in sources]
        tmp = lib_path.with_name(f"{lib_path.name}.{tag}")
        run = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            procs = [subprocess.Popen([*cc, *cflags, "-c", str(s), "-o",
                                       str(o)], **run)
                     for s, o in zip(sources, objs)]
            outs = [p.communicate()[0] for p in procs]
            errs = [f"{s.name} ({p.returncode}):\n{out}"
                    for s, p, out in zip(sources, procs, outs) if p.returncode]
            if errs:
                raise RuntimeError(f"{what} build failed:\n" + "\n".join(errs))
            r = subprocess.run([*cc, *ldflags, "-shared", "-o", str(tmp),
                                *map(str, objs)], **run)
            if r.returncode:
                raise RuntimeError(f"{what} link failed ({r.returncode}):\n"
                                   f"{r.stdout}")
            os.replace(tmp, lib_path)
        finally:
            for f in (*objs, tmp):
                f.unlink(missing_ok=True)
        return "".join(outs)


def load_once(owner: dict, build: Callable, open_lib: Callable):
    """``owner["_lib"]`` (a module's globals), set on first use to
    ``open_lib()`` after ``build()``; safe from any thread."""
    lib = owner["_lib"]
    if lib is not None:
        return lib
    with _load_locks.setdefault(owner["__name__"], threading.Lock()):
        if owner["_lib"] is None:
            build()
            owner["_lib"] = open_lib()
        return owner["_lib"]


def bind(lib, signatures: dict):
    """``lib`` with each entry point of ``signatures`` (name: (restype,
    argtypes)) typed."""
    for name, (res, args) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib
