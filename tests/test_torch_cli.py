"""The port's CLI (``python -m turbosqueeze_tpu_torch.cli``) on the CPU:
the cases of ``tests/test_cli.py`` and ``tests/test_tsqx.py::
test_cli_pack_verb`` with ``--device cpu`` (the kernels' plain versions)
or a host backend, the native file pipeline's files equal to the JAX
package's CLI's, and the TSQX refusals the JAX CLI lacks.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_host_copies import jax_core, port_core
from turbosqueeze_tpu.cli import main as ref_main
from turbosqueeze_tpu_torch.cli import main
from turbosqueeze_tpu_torch.format import scan_block_table
from turbosqueeze_tpu_torch.utils.corpus import synthetic_text

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def core():
    return port_core()


def test_compress_decompress_verbs(tmp_path, capsys):
    data = synthetic_text(200_000, seed=9)
    src, tsq, out = tmp_path / "src", tmp_path / "a.tsq", tmp_path / "out"
    src.write_bytes(data)
    assert main(CPU + ["c", str(src), str(tsq)]) == 0
    assert tsq.read_bytes()[:4] == b"TSQ1"
    assert main(CPU + ["d", str(tsq), str(out)]) == 0
    assert out.read_bytes() == data
    assert "MB/s" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["native", "cuda"])
def test_no_ext_flag(tmp_path, backend):
    src, tsq = tmp_path / "src", tmp_path / "a.tsq"
    src.write_bytes(synthetic_text(50_000))
    assert main(CPU + ["--backend", backend, "c", str(src), str(tsq),
                       "--no-ext"]) == 0
    _, table = scan_block_table(tsq.read_bytes())
    assert table and all(not ext for _, _, ext in table)


def test_info_and_verify(tmp_path, capsys):
    data = synthetic_text(100_000, seed=3)
    src, tsq = tmp_path / "src", tmp_path / "a.tsq"
    src.write_bytes(data)
    assert main(CPU + ["c", str(src), str(tsq)]) == 0
    assert main(["info", str(tsq), "--blocks"]) == 0
    out = capsys.readouterr().out
    assert "1 blocks" in out and "block 0" in out
    assert main(CPU + ["verify", str(src), str(tsq)]) == 0
    assert "OK: bit-exact" in capsys.readouterr().out
    src.write_bytes(data[:-1] + b"?")
    assert main(["--backend", "native", "verify", str(src), str(tsq)]) == 1


@pytest.mark.parametrize("argv", [["--backend", "native"], CPU])
def test_bench_small(capsys, argv):
    assert main(argv + ["b", "--size", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("roundtrip OK") == 2


def test_oracle_backend(tmp_path):
    data = synthetic_text(10_000)
    src, tsq, out = tmp_path / "src", tmp_path / "a.tsq", tmp_path / "out"
    src.write_bytes(data)
    assert main(["--backend", "oracle", "c", str(src), str(tsq)]) == 0
    assert main(["--backend", "oracle", "d", str(tsq), str(out)]) == 0
    assert out.read_bytes() == data


def test_native_file_pipeline_equals_the_jax_cli(tmp_path):
    """``c``/``d`` with ``--backend native`` stream through the core's
    file pipeline, as the JAX CLI does: the same files, several blocks,
    a level and a dictionary through the in-memory path."""
    jax_core()
    data = synthetic_text((4 << 20) + 30_000, seed=5) + bytes(70_000)
    dict_f = tmp_path / "dict"
    dict_f.write_bytes(synthetic_text(8_000, seed=6))
    src = tmp_path / "src"
    src.write_bytes(data)
    for extra in ([], ["--level", "2"], ["--dict", str(dict_f)]):
        files = {}
        for name, fn in (("port", main), ("ref", ref_main)):
            tsq, out = tmp_path / f"{name}.tsq", tmp_path / f"{name}.out"
            assert fn(["--backend", "native", "c", str(src), str(tsq)]
                      + extra) == 0
            d = ["--dict", str(dict_f)] if "--dict" in extra else []
            assert fn(["--backend", "native", "d", str(tsq), str(out)]
                      + d) == 0
            assert out.read_bytes() == data
            files[name] = tsq.read_bytes()
        assert files["port"] == files["ref"], extra


def test_pack_verb(tmp_path):
    data = synthetic_text(200_000, seed=96)
    src, tsq = tmp_path / "in.bin", tmp_path / "a.tsq"
    tsqx_f, out = tmp_path / "a.tsqx", tmp_path / "out.bin"
    src.write_bytes(data)
    assert main(["--backend", "native", "c", str(src), str(tsq)]) == 0
    assert main(["x", str(tsq), str(tsqx_f), "--nblk", "2"]) == 0
    assert main(CPU + ["d", str(tsqx_f), str(out)]) == 0
    assert out.read_bytes() == data


def test_tsqx_refuses_a_dictionary_and_host_backends(tmp_path, capsys):
    src, tsq, tsqx_f = (tmp_path / "in.bin", tmp_path / "a.tsq",
                        tmp_path / "a.tsqx")
    src.write_bytes(synthetic_text(50_000, seed=97))
    assert main(["--backend", "native", "c", str(src), str(tsq)]) == 0
    assert main(["x", str(tsq), str(tsqx_f)]) == 0
    capsys.readouterr()
    out = tmp_path / "out"
    for argv in (CPU + ["d", str(tsqx_f), str(out), "--dict", str(src)],
                 ["--backend", "native", "d", str(tsqx_f), str(out)],
                 ["--backend", "oracle", "d", str(tsqx_f), str(out)]):
        assert main(argv) == 1
        assert capsys.readouterr().err.startswith("tsq: error: ")
    assert not out.exists()


def test_card_verbs_without_a_gpu_exit_1(tmp_path, capsys, monkeypatch):
    src, tsq = tmp_path / "src", tmp_path / "a.tsq"
    src.write_bytes(synthetic_text(20_000, seed=2))
    assert main(["--backend", "native", "c", str(src), str(tsq)]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    capsys.readouterr()
    for argv in (["c", str(src), str(tmp_path / "b.tsq")],
                 ["d", str(tsq), str(tmp_path / "out")],
                 ["verify", str(src), str(tsq)]):
        assert main(argv) == 1
        assert "CUDA" in capsys.readouterr().err


def test_module_entry_point(tmp_path):
    data = synthetic_text(30_000, seed=4)
    src, tsq, out = tmp_path / "src", tmp_path / "a.tsq", tmp_path / "out"
    src.write_bytes(data)
    cli = [sys.executable, "-m", "turbosqueeze_tpu_torch.cli"]
    for argv in (CPU + ["c", str(src), str(tsq), "--level", "1"],
                 CPU + ["d", str(tsq), str(out)]):
        r = subprocess.run(cli + argv, cwd=REPO, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
    assert out.read_bytes() == data
    r = subprocess.run(cli + ["d", str(src), str(out)], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1 and r.stderr.startswith("tsq: error: ")
