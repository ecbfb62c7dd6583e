"""The ratio sweep's contract (``tests/test_ratio_sweep.py``) held on the
port's compress on the CPU, where the kernels run their plain versions.
For each synthetic class of ``ratio_sweep_files`` (1 MiB each) and each
``ext``:

- ``pipeline.compress`` at level 0, at level 1 through every emitter
  (``scan``, ``bulk``, ``flat``) and at level 2 gives ``native.compress``'s
  container byte for byte, and at levels 1 and 2 the JAX pipeline's;
- level 1 is no larger than level 0 (the upstream's parse) and level 2
  no larger than level 1;
- the level-1 container decodes to the input on the ``gang``, ``stream``
  and ``bulk2`` routes;
- against the upstream binary (where the golden harness builds): level 0
  is its container, level 1 no larger than its, and it decodes the port's
  level-1 and level-2 containers.

The real files run at full size on the card (``chip_smoke.py``'s scale
phase), not here.
"""

import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import pytest

from turbosqueeze_tpu.parallel import mesh as ref_mesh
from turbosqueeze_tpu.parallel import pipeline as ref_pipeline
from turbosqueeze_tpu_torch.parallel import pipeline
from turbosqueeze_tpu_torch.utils.corpus import ratio_sweep_files

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_host_copies import jax_core, port_core  # noqa: E402

FILES = ratio_sweep_files(include_real=False)
CASES = [pytest.param(name, ext, id=f"{name}-ext{int(ext)}")
         for name in FILES for ext in (True, False)]
CALLS = ((0, "scan"), (1, "scan"), (1, "bulk"), (1, "flat"), (2, "scan"))


@pytest.fixture(scope="module", autouse=True)
def native():
    jax_core()  # the JAX pipeline's reference runs on it
    return port_core()


@lru_cache(maxsize=None)
def _port(name: str, ext: bool) -> dict:
    """The port's containers of one class: (level, emit_impl) -> bytes."""
    return {(level, emit): pipeline.compress(FILES[name], ext, level=level,
                                             device="cpu", emit_impl=emit)
            for level, emit in CALLS}


@pytest.mark.parametrize("name, ext", CASES)
def test_matches_native_and_keeps_the_order(native, name, ext):
    data = FILES[name]
    want = {level: native.compress(data, ext, level=level)
            for level in (0, 1, 2)}
    for (level, emit), got in _port(name, ext).items():
        assert got == want[level], f"{name}: level {level} {emit}"
    assert len(want[1]) <= len(want[0]), f"{name}: level 1 > level 0"
    assert len(want[2]) <= len(want[1]), f"{name}: level 2 > level 1"


@pytest.mark.parametrize("name, ext", CASES)
def test_level1_decodes_on_every_route(native, name, ext):
    data = FILES[name]
    stream = native.compress(data, ext, level=1)
    for impl in ("gang", "stream", "bulk2"):
        assert pipeline.decompress(stream, device="cpu", impl=impl) == data, (
            f"{name}: {impl}")


@pytest.mark.parametrize("name, ext", CASES)
def test_matches_jax_pipeline(name, ext):
    mesh = ref_mesh.block_mesh(jax.devices()[:1])
    for level in (1, 2):
        ref = ref_pipeline.compress(FILES[name], ext, level=level, mesh=mesh)
        assert _port(name, ext)[(level, "scan")] == ref, f"{name}: {level}"


@pytest.mark.parametrize("name, ext", CASES)
def test_against_upstream_binary(golden_harness, tmp_path, name, ext):
    data = FILES[name]
    src, dst = tmp_path / "in.bin", tmp_path / "up.tsq"
    src.write_bytes(data)
    subprocess.run([str(golden_harness), "c", "1" if ext else "0", str(src),
                    str(dst)], check=True)
    upstream = dst.read_bytes()
    port = _port(name, ext)
    assert port[(0, "scan")] == upstream, f"{name}: level 0 != upstream"
    assert len(port[(1, "scan")]) <= len(upstream), f"{name}: level 1"
    for level in (1, 2):
        sp, dp = tmp_path / f"l{level}.tsq", tmp_path / f"l{level}.out"
        sp.write_bytes(port[(level, "scan")])
        subprocess.run([str(golden_harness), "d", str(sp), str(dp)],
                       check=True)
        assert dp.read_bytes() == data, f"{name}: upstream decode, {level}"
